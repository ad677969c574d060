"""Native C++ tier: LDL^T and Bunch-Kaufman vs numpy/scipy oracles."""

import numpy as np
import pytest

from ipmzoo import native


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def quasidefinite(n1, n2, seed):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n1, n1))
    H = H @ H.T + n1 * np.eye(n1)
    S = rng.normal(size=(n2, n2))
    S = S @ S.T + n2 * np.eye(n2)
    A = rng.normal(size=(n2, n1))
    return np.block([[H, A.T], [A, -S]])


def indefinite(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return (M + M.T) / 2


class TestLDLT:
    @pytest.mark.parametrize("n1,n2", [(4, 2), (16, 9), (40, 23)])
    def test_factor_and_solve(self, n1, n2):
        A = quasidefinite(n1, n2, seed=n1 + n2)
        L, D = native.ldlt_factor(A)
        np.testing.assert_allclose(L @ np.diag(D) @ L.T, A,
                                   rtol=1e-9, atol=1e-9)
        b = np.random.default_rng(0).normal(size=n1 + n2)
        x = native.ldlt_solve(L, D, b)
        np.testing.assert_allclose(A @ x, b, rtol=1e-8, atol=1e-8)

    def test_pivot_floor(self):
        L, D = native.ldlt_factor(np.zeros((3, 3)))
        assert np.all(D == 1e-8)

    def test_batch(self):
        nb, n1, n2 = 16, 6, 3
        A = np.stack([quasidefinite(n1, n2, seed=s) for s in range(nb)])
        b = np.random.default_rng(1).normal(size=(nb, n1 + n2))
        x = native.ldlt_factor_solve_batch(A, b)
        np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x), b,
                                   rtol=1e-8, atol=1e-8)

    def test_matches_device_kernel(self):
        """The native tier and the jnp device kernel agree (up to
        floating-point summation order)."""
        import jax.numpy as jnp
        from ipmzoo.ops import ldlt as jldlt
        A = quasidefinite(8, 5, seed=42)
        Ln, Dn = native.ldlt_factor(A)
        Lj, Dj = jldlt(jnp.asarray(A))
        np.testing.assert_allclose(Ln, np.asarray(Lj), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(Dn, np.asarray(Dj), rtol=1e-9, atol=1e-9)


class TestBunchKaufman:
    @pytest.mark.parametrize("n", [1, 2, 3, 8, 25, 60])
    def test_solve_indefinite(self, n):
        A = indefinite(n, seed=n)
        F, ipiv, info = native.bunch_kaufman_factor(A)
        assert info == 0
        rng = np.random.default_rng(2)
        for _ in range(3):
            b = rng.normal(size=n)
            x = native.bunch_kaufman_solve(F, ipiv, b)
            np.testing.assert_allclose(A @ x, b, rtol=1e-7, atol=1e-7)

    def test_needs_2x2_pivots(self):
        # zero diagonal forces 2x2 pivoting
        A = np.array([[0.0, 1.0], [1.0, 0.0]])
        F, ipiv, info = native.bunch_kaufman_factor(A)
        assert info == 0
        b = np.array([1.0, 2.0])
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(A @ x, b, atol=1e-12)
        assert ipiv[0] < 0  # a 2x2 block was used

    def test_saddle_point_matrix(self):
        # KKT-style matrix with zero block: [[Q, A^T], [A, 0]]
        rng = np.random.default_rng(3)
        n, m = 6, 3
        Q = rng.normal(size=(n, n))
        Q = Q @ Q.T + np.eye(n)
        A = rng.normal(size=(m, n))
        K = np.block([[Q, A.T], [A, np.zeros((m, m))]])
        F, ipiv, info = native.bunch_kaufman_factor(K)
        assert info == 0
        b = rng.normal(size=n + m)
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(K @ x, b, rtol=1e-8, atol=1e-8)

    def test_vs_scipy(self):
        from scipy.linalg import ldl as scipy_ldl
        A = indefinite(12, seed=7)
        # compare solve results (factor layouts differ)
        b = np.random.default_rng(4).normal(size=12)
        F, ipiv, _ = native.bunch_kaufman_factor(A)
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(x, np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-8)


class TestRegLDLTAgainstBK:
    """Correctness fallback for the IPM's 'regldlt' mode: the signed-
    regularised unpivoted LDL^T + iterative-refinement recipe must
    reproduce the native Bunch-Kaufman (dynamically pivoted) solution on
    genuinely indefinite KKT systems with a zero dual block."""

    @staticmethod
    def _kkt(n, m, seed):
        rng = np.random.default_rng(seed)
        Q = rng.normal(size=(n, n))
        Q = Q @ Q.T / n + np.eye(n)
        A = rng.normal(size=(m, n))
        return np.block([[Q, A.T], [A, np.zeros((m, m))]])

    @staticmethod
    def _regldlt_solve(K, b, signs, sweeps=3):
        import jax.numpy as jnp
        from ipmzoo.ops.pallas_ldlt import ldlt_auto, solve_ldlt_auto
        Kj = jnp.asarray(K)
        eps = float(np.finfo(K.dtype).eps)
        scale = max(1.0, float(np.max(np.abs(np.diag(K)))))
        Kr = Kj + jnp.diag(jnp.asarray(signs * eps ** (2 / 3) * scale))
        L, D = ldlt_auto(Kr)
        x = solve_ldlt_auto(L, D, jnp.asarray(b))
        for _ in range(sweeps):
            x = x + solve_ldlt_auto(L, D, jnp.asarray(b) - Kj @ x)
        return np.asarray(x)

    @pytest.mark.parametrize("n,m", [(6, 2), (20, 8), (48, 17)])
    def test_matches_bunch_kaufman(self, n, m):
        K = self._kkt(n, m, seed=n)
        b = np.random.default_rng(n + 1).normal(size=n + m)
        F, ipiv, info = native.bunch_kaufman_factor(K)
        assert info == 0
        x_bk = native.bunch_kaufman_solve(F, ipiv, b)
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        x_reg = self._regldlt_solve(K, b, signs)
        np.testing.assert_allclose(x_reg, x_bk, rtol=1e-9, atol=1e-9)

    def test_batched_matches_bunch_kaufman(self):
        import jax
        import jax.numpy as jnp
        from ipmzoo.ops.pallas_ldlt import ldlt_auto, solve_ldlt_auto
        n, m, batch = 12, 5, 8
        Ks = np.stack([self._kkt(n, m, seed=100 + i) for i in range(batch)])
        bs = np.random.default_rng(0).normal(size=(batch, n + m))
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        eps = float(np.finfo(np.float64).eps)

        def solve_one(K, b):
            Kr = K + jnp.diag(jnp.asarray(signs) * eps ** (2 / 3))
            L, D = ldlt_auto(Kr)
            x = solve_ldlt_auto(L, D, b)
            for _ in range(3):
                x = x + solve_ldlt_auto(L, D, b - K @ x)
            return x

        xs = np.asarray(jax.jit(jax.vmap(solve_one))(
            jnp.asarray(Ks), jnp.asarray(bs)))
        for i in range(batch):
            F, ipiv, info = native.bunch_kaufman_factor(Ks[i])
            assert info == 0
            x_bk = native.bunch_kaufman_solve(F, ipiv, bs[i])
            np.testing.assert_allclose(xs[i], x_bk, rtol=1e-9, atol=1e-9)
