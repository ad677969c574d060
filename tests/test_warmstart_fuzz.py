"""Warm starting and randomized robustness sweep."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo.models import CompiledIPM, QPData


def random_qp(n, m, seed, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return QPData.make(
        Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
        A_ineq=rng.normal(size=(m, n)) if m else None,
        l_A_ineq=(-np.abs(rng.normal(size=m)) - 1) if m else None,
        u_A_ineq=(np.abs(rng.normal(size=m)) + 1) if m else None,
        l_x=-5 * np.ones(n), u_x=5 * np.ones(n), dtype=dtype)


class TestWarmStart:
    def test_warm_start_reduces_iterations(self):
        n, m = 10, 4
        data = random_qp(n, m, 0)
        s = CompiledIPM(Settings(), n=n, m_ineq=m)
        r1 = s.solve(data)
        assert bool(r1.converged)
        # perturb the linear term (receding-horizon style resolve)
        data2 = dataclasses.replace(data, c=data.c + 0.01)
        cold = s.solve(data2)
        warm = s.solve(data2, warm_start=r1.variables)
        assert bool(warm.converged)
        assert int(warm.iterations) < int(cold.iterations)
        np.testing.assert_allclose(np.asarray(warm.x), np.asarray(cold.x),
                                   atol=1e-6)

    def test_warm_start_partial_dict(self):
        # warm starting only x is allowed; other variables default
        n = 6
        data = random_qp(n, 0, 1)
        s = CompiledIPM(Settings(inequalities=Bounds.NONE), n=n)
        r1 = s.solve(data)
        warm = s.solve(data, warm_start={"x": r1.x})
        assert bool(warm.converged)


# QPData is a frozen-ish dataclass pytree; dataclasses.replace works on it
# because it is a plain dataclass.


FUZZ_SETTINGS = [
    Settings(),
    Settings(inequality_handling=InequalityHandling.SLACKS),
    Settings(inequality_handling=InequalityHandling.NAIVE_SLACKS),
    Settings(inequalities=Bounds.LOWER),
    Settings(inequalities=Bounds.UPPER,
             inequality_handling=InequalityHandling.SLACKS),
    Settings(inequalities=Bounds.NONE),
    Settings(equalities=True,
             equality_handling=EqualityHandling.REGULARIZATION),
    Settings(equalities=True,
             equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL),
    Settings(equalities=True, equality_handling=EqualityHandling.NONE,
             inequalities=Bounds.NONE),
]


@pytest.mark.parametrize("idx", range(len(FUZZ_SETTINGS)))
def test_fuzz_formulations_never_crash(idx):
    """Random data on a slice of the formulation lattice: every solve must
    end in a clean state — converged, max-iter, or flagged divergence —
    and converged solves must satisfy their box bounds."""
    settings = FUZZ_SETTINGS[idx]
    n, m = 7, 3
    m_eq = 1 if settings.equalities else 0
    solver = CompiledIPM(settings, n=n, m_ineq=m, m_eq=m_eq,
                        dtype=jnp.float64, tol=1e-8)
    for seed in range(3):
        rng = np.random.default_rng(100 * idx + seed)
        data = random_qp(n, m, 100 * idx + seed)
        if m_eq:
            data = dataclasses.replace(
                data, A_eq=jnp.asarray(rng.normal(size=(1, n))),
                b_eq=jnp.asarray(rng.normal(size=(1,))))
        res = solver.solve(data)
        assert np.isfinite(float(res.objective)) or bool(res.diverged)
        if bool(res.converged):
            x = np.asarray(res.x)
            assert (x >= -5 - 1e-6).all() and (x <= 5 + 1e-6).all()
