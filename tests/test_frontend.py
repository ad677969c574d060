"""Front ends: LaTeX renderers, CLI demos, web-site generator."""

import json
import os
import subprocess
import sys

import pytest

from ipmzoo.formulations import (Bounds, InequalityHandling,
                                     ProblemStage, Settings)
from ipmzoo.frontend.latex import (render_first_order_conditions,
                                       render_lagrangian,
                                       render_newton_systems, render_problem)


class TestLatex:
    def test_newton_systems_bundle(self):
        systems = render_newton_systems(Settings())
        # the cosmetic 1 -> I rewrite appears in the full system lhs
        assert "-I" in systems.full.lhs
        # augmented system has a 2x2 matrix body: one '&' per row
        rows = [r for r in systems.augmented.lhs.split("\\\\") if r.strip()]
        assert len(rows) == 2
        assert all(r.count("&") == 1 for r in rows)
        assert systems.normal.lhs.count("&") == 0
        # shorthand rhs uses -r_{var} symbols
        assert "-r_{x}" in systems.full.rhs_shorthand
        # delta definitions present for the reductions
        assert "\\Delta" in systems.augmented.delta_definitions

    def test_problem_rendering(self):
        s = render_problem(Settings(), ProblemStage.SLACKED)
        assert "\\text{minimize}" in s and "\\text{subject to}" in s
        assert "0.5 x^T Q x + c^T x" in s
        barrier = render_problem(Settings(),
                                 ProblemStage.SLACKED_WITH_BARRIERS)
        assert "\\log" in barrier

    def test_lagrangian_and_kkt(self):
        lag = render_lagrangian(Settings())
        assert "\\lambda" in lag and "\\log" in lag
        kkt = render_first_order_conditions(Settings())
        assert "&= 0" in kkt

    def test_bounds_none_renders_empty_constraints(self):
        s = render_problem(Settings(inequalities=Bounds.NONE,
                                    variable_bounds=Bounds.NONE))
        assert "\\leq" not in s


_LATEX_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                             "latex_strings.json.gz")


def _latex_cases():
    import gzip
    with gzip.open(_LATEX_GOLDEN, "rt") as f:
        return json.load(f)


class TestLatexGolden:
    """Exact string parity with the reference's web presentation layer
    (/root/reference/src/wasm_bindings.cpp:33-249), pinned by the oracle
    fixture — see tests/golden/README.md for provenance."""

    @pytest.mark.parametrize("key", sorted(_latex_cases()))
    def test_latex_parity(self, key):
        from ipmzoo.formulations import EqualityHandling
        gold = _latex_cases()[key]
        ib, vb, eq, eh, ih = key.split("|")
        st = Settings(inequalities=Bounds(ib), variable_bounds=Bounds(vb),
                      equalities=eq == "1",
                      equality_handling=EqualityHandling(eh),
                      inequality_handling=InequalityHandling(ih))
        assert render_problem(st, ProblemStage.SLACKED) == \
            gold["problem_slacked"]
        assert render_problem(st, ProblemStage.SLACKED_WITH_BARRIERS) == \
            gold["problem_barrier"]
        assert render_lagrangian(st) == gold["lagrangian"]
        assert render_first_order_conditions(st) == gold["kkt"]
        systems = render_newton_systems(st)
        for name in ("full", "augmented", "normal"):
            s = getattr(systems, name)
            for field in ("lhs", "rhs", "rhs_shorthand", "variables",
                          "delta_definitions"):
                assert getattr(s, field) == gold[name][field], \
                    f"{name}.{field} mismatch"


class TestWeb:
    def test_generate_site(self, tmp_path):
        from ipmzoo.frontend.web import generate_site
        out = str(tmp_path / "site")
        generate_site(out)
        assert os.path.exists(os.path.join(out, "index.html"))
        with open(os.path.join(out, "derivations.json")) as f:
            data = json.load(f)
        assert len(data) == 336
        assert all("error" not in v for v in data.values())
        sample = data["both|both|0|none|slacked_slacks"]
        assert "problem" in sample and "systems" in sample
        assert sample["systems"]["augmented"]["lhs"]

    def test_dim_zeros_toggle_wired(self, tmp_path):
        # reference behaviour: docs/index.html "Dim zeros" checkbox +
        # ipm-derivation.js:24-27 regex wrapping standalone 0s.
        from ipmzoo.frontend.web import _PAGE
        assert 'id="dim_zeros" checked' in _PAGE
        assert "function dimZeros" in _PAGE
        assert r"{\\color{lightgray}0}" in _PAGE
        # applied to every system matrix body, and re-renders on change
        assert _PAGE.count("dimZeros(s.lhs)") == 1
        assert 'getElementById("dim_zeros").addEventListener' in _PAGE


class TestCLI:
    def _run(self, *args):
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        return subprocess.run(
            [sys.executable, "-m", "ipmzoo.frontend.cli", *args],
            capture_output=True, text=True, env=env, timeout=500)

    def test_symbolic_demo(self):
        out = self._run("-o")
        assert out.returncode == 0
        assert "Augmented system lhs" in out.stdout
        assert "Normal equations lhs" in out.stdout

    def test_basic_and_eval_demos(self):
        out = self._run("-b", "-e")
        assert out.returncode == 0
        assert "d/dx" in out.stdout
        assert "1/2 x^T Q x = " in out.stdout

    def test_latex_flag(self):
        out = self._run("--latex")
        assert out.returncode == 0
        assert "% problem" in out.stdout
        assert "\\text{minimize}" in out.stdout
