"""taylor="symbolic": the Mehrotra corrector's exact quadratic Taylor
remainder staged as ONE simplified expression in the affine-delta
symbols, vs the default three-point numeric computation
(taylor="staged").  The two are the same polynomial identity, so single
steps must agree to float reassociation error across the formulation
slice, and batched solves must stay in lockstep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo.models import CompiledIPM, QPData

from test_formulation_coverage import data


def _one_step(settings, m_eq, taylor):
    s = CompiledIPM(settings, n=2, m_ineq=1, m_eq=m_eq,
                    dtype=jnp.float64, kernel="jnp", taylor=taylor)
    d = data(m_eq > 0)
    st = s.init_state(d)
    new = s._step_impl(st, d)
    return new


@pytest.mark.parametrize("ih", list(InequalityHandling))
@pytest.mark.parametrize("bounds", [Bounds.BOTH, Bounds.LOWER,
                                    Bounds.UPPER])
def test_step_matches_staged_inequalities(ih, bounds):
    settings = Settings(inequalities=bounds, inequality_handling=ih)
    a = _one_step(settings, 0, "staged")
    b = _one_step(settings, 0, "symbolic")
    for va, vb in zip(a.vars, b.vars):
        np.testing.assert_allclose(np.asarray(vb), np.asarray(va),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(b.mu), float(a.mu), rtol=1e-12)


@pytest.mark.parametrize("eh", list(EqualityHandling))
def test_step_matches_staged_equalities(eh):
    settings = Settings(equalities=True, equality_handling=eh,
                        inequality_handling=InequalityHandling.SLACKS)
    try:
        a = _one_step(settings, 1, "staged")
    except NotImplementedError:
        pytest.skip(f"{eh} routes away from the default kernel")
    b = _one_step(settings, 1, "symbolic")
    for va, vb in zip(a.vars, b.vars):
        np.testing.assert_allclose(np.asarray(vb), np.asarray(va),
                                   rtol=1e-12, atol=1e-12)


def test_full_solve_equivalence():
    s1 = CompiledIPM(Settings(), n=2, m_ineq=1, dtype=jnp.float64,
                     taylor="staged")
    s2 = CompiledIPM(Settings(), n=2, m_ineq=1, dtype=jnp.float64,
                     taylor="symbolic")
    d = data(False)
    r1, r2 = s1.solve(d), s2.solve(d)
    assert bool(r1.converged) and bool(r2.converged)
    assert int(r1.iterations) == int(r2.iterations)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=0, atol=1e-10)


def test_batched_lockstep_symbolic():
    """Under vmap the symbolic remainder stays in lockstep with the
    staged one."""
    B, n, m = 8, 6, 3
    rng = np.random.default_rng(2)
    M = rng.normal(size=(B, n, n))
    d = QPData(
        Q=jnp.asarray(np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)),
        c=jnp.asarray(rng.normal(size=(B, n))),
        A_ineq=jnp.asarray(rng.normal(size=(B, m, n))),
        l_A_ineq=jnp.asarray(-np.abs(rng.normal(size=(B, m))) - 1),
        u_A_ineq=jnp.asarray(np.abs(rng.normal(size=(B, m))) + 1),
        A_eq=jnp.zeros((B, 0, n)), b_eq=jnp.zeros((B, 0)),
        l_x=jnp.full((B, n), -5.0), u_x=jnp.full((B, n), 5.0))
    runs = [CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float64,
                        taylor=t).solve_batch(d)
            for t in ("staged", "symbolic")]
    assert all(bool(jnp.all(r.converged)) for r in runs)
    np.testing.assert_array_equal(np.asarray(runs[0].iterations),
                                  np.asarray(runs[1].iterations))
    np.testing.assert_allclose(np.asarray(runs[1].x), np.asarray(runs[0].x),
                               rtol=1e-10, atol=1e-10)


def test_unknown_taylor_rejected():
    with pytest.raises(ValueError, match="taylor"):
        CompiledIPM(Settings(), n=2, m_ineq=1, taylor="nope")
