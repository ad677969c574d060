"""Golden parity: derived Newton systems match the reference term-for-term.

``tests/golden/newton_systems.json.gz`` holds the rendered (condensed
LaTeX) Newton system, augmented system, normal equations, shorthand rhs
and delta definitions for all 384 formulation-lattice points, generated by
driving the reference implementation's symbolic layer.  Our derivation
must reproduce every string exactly.
"""

import gzip
import json
import os

import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings,
                                     augmented_system, newton_system,
                                     normal_equations, shorthand_rhs)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "newton_systems.json.gz")

with gzip.open(GOLDEN, "rt") as f:
    CASES = json.load(f)


def _settings(d) -> Settings:
    return Settings(
        inequalities=Bounds(d["inequalities"]),
        variable_bounds=Bounds(d["variable_bounds"]),
        equalities=d["equalities"],
        equality_handling=EqualityHandling(d["equality_handling"]),
        inequality_handling=InequalityHandling(d["inequality_handling"]),
    )


def _render_system(ns):
    return {
        "lhs": [[e.to_string(True) for e in row] for row in ns.lhs],
        "rhs": [e.to_string(True) for e in ns.rhs],
        "variables": [v.to_string(True) for v in ns.variables],
        "delta_definitions": [[dv.to_string(True), dd.to_string(True)]
                              for dv, dd in ns.delta_definitions],
    }


def _case_id(case):
    s = case["settings"]
    return (f"i={s['inequalities']},v={s['variable_bounds']},"
            f"e={s['equalities']},eh={s['equality_handling']},"
            f"ih={s['inequality_handling']}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_newton_parity(case):
    assert "error" not in case, "golden case failed in reference"
    settings = _settings(case["settings"])

    full = newton_system(settings)
    assert _render_system(full) == case["full"]

    sh = shorthand_rhs(full)
    assert [e.to_string(True) for e in sh.shorthand_rhs] == \
        case["shorthand_rhs"]
    assert [[v.to_string(True), d.to_string(True)]
            for v, d in sh.vector_definitions] == case["shorthand_defs"]

    aug = augmented_system(full)
    assert _render_system(aug) == case["augmented"]

    normal = normal_equations(full)
    assert _render_system(normal) == case["normal"]
