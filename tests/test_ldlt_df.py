"""Two-float (double-single) LDL^T: accuracy and semantics.

The pair kernels must (a) agree with an f64 factorisation far beyond
f32 accuracy, (b) keep the reference's zero-pivot floor semantics
(/root/reference/src/NumericalOptimization/LinearSolvers.cpp:26-28),
and (c) solve ill-conditioned quasi-definite systems that plain f32
LDL^T cannot — the property the two-float IPM mode rides to 1e-8.
"""

import jax.numpy as jnp
import numpy as np

from ipmzoo.ops.ldlt import ldlt, ldlt_solve
from ipmzoo.ops.ldlt_df import (ldlt_df, ldlt_solve_df, solve_ldlt_df,
                                    split_f64)


def _quasi_definite(n, cond_scale=1.0, seed=0):
    """K = [[H, A^T], [A, -D]] with H SPD; cond steered by cond_scale."""
    rng = np.random.default_rng(seed)
    h = n // 2
    M = rng.normal(size=(h, h))
    H = M @ M.T / h + np.eye(h)
    A = rng.normal(size=(n - h, h))
    D = np.diag(np.abs(rng.normal(size=n - h)) * cond_scale + 1e-12)
    K = np.block([[H, A.T], [A, -D]])
    return K


class TestLdltDfAccuracy:
    def test_factor_matches_f64_beyond_f32(self):
        K = _quasi_definite(24)
        L64, D64 = ldlt(jnp.asarray(K, jnp.float64))
        Lh, Ll, Dh, Dl = ldlt_df(*split_f64(K))
        L_df = np.asarray(Lh, np.float64) + np.asarray(Ll, np.float64)
        D_df = np.asarray(Dh, np.float64) + np.asarray(Dl, np.float64)
        # pair unit roundoff ~2^-48: far beyond f32's 6e-8
        np.testing.assert_allclose(L_df, np.asarray(L64), atol=2e-12)
        np.testing.assert_allclose(D_df, np.asarray(D64), rtol=2e-12)

    def test_solve_matches_f64(self):
        K = _quasi_definite(32, seed=1)
        rng = np.random.default_rng(2)
        b = rng.normal(size=32)
        x64 = ldlt_solve(jnp.asarray(K, jnp.float64),
                         jnp.asarray(b, jnp.float64))
        xh, xl = ldlt_solve_df(*split_f64(K), *split_f64(b))
        x_df = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
        np.testing.assert_allclose(x_df, np.asarray(x64), atol=5e-12)

    def test_ill_conditioned_beats_f32(self):
        """cond(K) ~ 1e8 (an IPM barrier near mu ~ 1e-8): the pair solve
        keeps ~6 digits where the f32 solve has none left."""
        K = _quasi_definite(16, cond_scale=1e-8, seed=3)
        rng = np.random.default_rng(4)
        x_true = rng.normal(size=16)
        b = K @ x_true
        x64 = np.linalg.solve(K, b)

        x32 = ldlt_solve(jnp.asarray(K, jnp.float32),
                         jnp.asarray(b, jnp.float32))
        err32 = np.max(np.abs(np.asarray(x32, np.float64) - x64)) / \
            np.max(np.abs(x64))

        xh, xl = ldlt_solve_df(*split_f64(K), *split_f64(b))
        err_df = np.max(np.abs(np.asarray(xh, np.float64) +
                               np.asarray(xl, np.float64) - x64)) / \
            np.max(np.abs(x64))
        assert err_df < 1e-6
        assert err_df < err32 * 1e-2   # decisively better than f32

    def test_zero_pivot_floor(self):
        """An exactly singular leading block trips the 1e-8 floor, the
        same regularisation as the f32/f64 kernels."""
        K = np.zeros((2, 2))
        K[0, 1] = K[1, 0] = 1.0
        Lh, Ll, Dh, Dl = ldlt_df(*split_f64(K))
        assert np.asarray(Dh)[0] == np.float32(1e-8)

    def test_empty_system(self):
        Lh, Ll, Dh, Dl = ldlt_df(jnp.zeros((0, 0), jnp.float32),
                                 jnp.zeros((0, 0), jnp.float32))
        assert Lh.shape == (0, 0) and Dh.shape == (0,)
        xh, xl = solve_ldlt_df(Lh, Ll, Dh, Dl,
                               jnp.zeros((0,), jnp.float32),
                               jnp.zeros((0,), jnp.float32))
        assert xh.shape == (0,)
