"""Achievable convergence floor vs working dtype — the pinned table.

Measured on the benchmark QP class (random SPD box QPs with two-sided
inequalities, n=16, m=8).  The floor is set by two things working
precision touches: the FACTORISATION (refinement cannot rescue it once
eps_factor * cond(K) ~ 1 — hybrid_refine/df_residuals do not move the
floor on this class) and the ITERATE REPRESENTATION (an f32-rounded
point cannot have residual below ~eps_f32 * ||Qx||).  two_float=True
removes BOTH: iterates are (hi, lo) pairs and the augmented system is
assembled and factored in double-single (ops/ldlt_df.py), giving an
effective unit roundoff of ~2^-48 from pure f32 arithmetic.

| dtype | options        | achievable tol | not achievable |
|-------|----------------|----------------|----------------|
| f64   | plain          | 1e-8 (parity)  | —              |
| f32   | plain          | 1e-6           | 3e-7           |
| f32   | hybrid_refine  | 1e-6           | 3e-7           |
| f32   | two_float      | 1e-8 (parity)  | (1e-10 observed on
|       |                |                |  this class)   |

The 1e-8 two_float row closes the last BASELINE.md gap ("duality-gap
parity <= 1e-8"; reference tolerance anchor
/root/reference/src/NumericalOptimization/Optimizer.cpp:124,133).

If the f32 rows improve after a solver change, UPDATE this table —
that is a feature, not a flake.  If f32@1e-6 (or f32+two_float@1e-8)
starts failing, that is a regression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import Settings
from ipmzoo.models import CompiledIPM, QPData

B, N, M = 48, 16, 8


@pytest.fixture(scope="module")
def qp_batch():
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, N, N)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / N + \
        np.eye(N, dtype=np.float32)
    return QPData.make(
        Q=Q, c=rng.normal(size=(B, N)),
        A_ineq=rng.normal(size=(B, M, N)),
        l_A_ineq=-np.abs(rng.normal(size=(B, M))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, M))) + 1,
        l_x=np.full((B, N), -5.0), u_x=np.full((B, N), 5.0))


def _conv_frac(dtype, tol, data, **opts):
    d = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), data)
    s = CompiledIPM(Settings(), n=N, m_ineq=M, dtype=dtype, tol=tol,
                    **opts)
    res = s.solve_batch(d)
    assert not bool(jnp.any(res.diverged)), \
        "divergence rollback tripped (mu floor should prevent this)"
    return float(jnp.mean(res.converged.astype(jnp.float64)))


class TestFloorTable:
    def test_f64_reaches_reference_parity_tol(self, qp_batch):
        assert _conv_frac(jnp.float64, 1e-8, qp_batch) == 1.0

    def test_f32_reaches_1e6(self, qp_batch):
        assert _conv_frac(jnp.float32, 1e-6, qp_batch) == 1.0

    def test_f32_hybrid_reaches_1e6(self, qp_batch):
        assert _conv_frac(jnp.float32, 1e-6, qp_batch, refine=2,
                          hybrid_refine=True) == 1.0

    def test_f32_floor_is_real(self, qp_batch):
        """3e-7 is BELOW the f32 factorisation floor on this class; if
        this starts converging, the floor moved — update the table."""
        assert _conv_frac(jnp.float32, 3e-7, qp_batch) < 0.5
        assert _conv_frac(jnp.float32, 3e-7, qp_batch, refine=2,
                          hybrid_refine=True) < 0.5

    def test_f32_no_rollbacks_at_1e6(self, qp_batch):
        """VERDICT #3 'done' criterion: f32 converges at tol <= 1e-6
        with zero rollbacks (the _conv_frac helper asserts no
        divergence on every row of the table)."""
        assert _conv_frac(jnp.float32, 1e-6, qp_batch, gondzio=2) == 1.0


class TestTwoFloatFloor:
    """two_float=True rows of the table.

    Run EAGERLY (un-jitted _step_impl), like the df_residuals tests:
    the pair pipeline's step graph is ~13k ops and XLA's CPU backend
    compiles it pathologically slowly, while eager execution of the
    same ops takes seconds.  The bench line (BENCH_MODE=tf) runs the
    jitted path on the GPU."""

    def _solve_eager(self, data_row, tol, max_iter=30):
        s = CompiledIPM(Settings(), n=N, m_ineq=M, dtype=jnp.float32,
                        tol=tol, two_float=True)
        st = s.init_state(data_row)
        for _ in range(max_iter):
            if (float(st.residual) < tol and float(st.gap) < tol):
                break
            st = s._step_impl(st, data_row)
        return st, s

    def test_f32_two_float_reaches_1e8_parity(self, qp_batch):
        """Reference-parity tolerance from pure f32 arithmetic, and the
        solution matches a plain f64 solve far beyond f32 precision."""
        for i in (0, 1, 2):
            row = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a[i], jnp.float32), qp_batch)
            st, s = self._solve_eager(row, 1e-8)
            assert float(st.residual) < 1e-8, i
            assert float(st.gap) < 1e-8, i
            row64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a[i], jnp.float64), qp_batch)
            s64 = CompiledIPM(Settings(), n=N, m_ineq=M,
                              dtype=jnp.float64, tol=1e-8)
            r64 = s64.solve(row64)
            xi = s.var_index[s.symbols.x]
            x_tf = (np.asarray(st.vars[xi][0], np.float64) +
                    np.asarray(st.vars[xi][1], np.float64))
            assert float(np.max(np.abs(x_tf - np.asarray(r64.x)))) < 1e-9

    def test_f32_two_float_beyond_parity(self, qp_batch):
        """The observed pair floor is deeper than the 1e-8 target."""
        row = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a[0], jnp.float32), qp_batch)
        st, _ = self._solve_eager(row, 1e-10, max_iter=35)
        assert float(st.residual) < 1e-10
        assert float(st.gap) < 1e-10
