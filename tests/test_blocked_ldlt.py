"""Panel-blocked LDL^T vs the unblocked column kernel."""

import jax
import jax.numpy as jnp
import numpy as np

from ipmzoo.ops.blocked_ldlt import ldlt_blocked
from ipmzoo.ops.ldlt import ldlt, solve_ldlt


def _quasi_definite(n, m, seed=0):
    """[[H, B^T], [B, -C]] with H, C SPD — the augmented-KKT shape."""
    rng = np.random.default_rng(seed)
    Mh = rng.normal(size=(n, n))
    H = Mh @ Mh.T / n + np.eye(n)
    Mc = rng.normal(size=(m, m))
    C = Mc @ Mc.T / m + np.eye(m)
    B = rng.normal(size=(m, n))
    K = np.block([[H, B.T], [B, -C]])
    return jnp.asarray(K)


class TestBlockedLDLT:
    def test_matches_unblocked(self):
        K = _quasi_definite(130, 70)          # 200 > panel
        L0, D0 = ldlt(K)
        L1, D1 = ldlt_blocked(K, panel=64)
        np.testing.assert_allclose(np.asarray(L1), np.asarray(L0),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(D1), np.asarray(D0),
                                   rtol=1e-9, atol=1e-9)

    def test_reconstructs(self):
        K = _quasi_definite(90, 47, seed=1)
        L, D = ldlt_blocked(K, panel=32)
        rec = np.asarray(L) @ np.diag(np.asarray(D)) @ np.asarray(L).T
        np.testing.assert_allclose(rec, np.asarray(K), rtol=1e-9,
                                   atol=1e-9)

    def test_solve(self):
        K = _quasi_definite(100, 60, seed=2)
        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.normal(size=160))
        L, D = ldlt_blocked(K, panel=48)
        x = solve_ldlt(L, D, b)
        np.testing.assert_allclose(np.asarray(K) @ np.asarray(x),
                                   np.asarray(b), rtol=1e-8, atol=1e-8)

    def test_uneven_panel_tail(self):
        K = _quasi_definite(50, 23, seed=4)   # 73 = 32 + 32 + 9
        L0, D0 = ldlt(K)
        L1, D1 = ldlt_blocked(K, panel=32)
        np.testing.assert_allclose(np.asarray(L1), np.asarray(L0),
                                   rtol=1e-9, atol=1e-9)

    def test_small_falls_back(self):
        K = _quasi_definite(10, 5, seed=5)
        L0, D0 = ldlt(K)
        L1, D1 = ldlt_blocked(K)              # n < panel: identical path
        np.testing.assert_array_equal(np.asarray(L0), np.asarray(L1))

    def test_vmap(self):
        Ks = jnp.stack([_quasi_definite(40, 30, seed=s) for s in range(3)])
        Lb, Db = jax.vmap(lambda A: ldlt_blocked(A, panel=16))(Ks)
        for i in range(3):
            L, D = ldlt_blocked(Ks[i], panel=16)
            np.testing.assert_allclose(np.asarray(Lb[i]), np.asarray(L),
                                       rtol=1e-12, atol=1e-12)

    def test_jit(self):
        K = _quasi_definite(80, 50, seed=6)
        L0, D0 = ldlt_blocked(K, panel=64)
        L1, D1 = jax.jit(lambda A: ldlt_blocked(A, panel=64))(K)
        np.testing.assert_allclose(np.asarray(L0), np.asarray(L1),
                                   rtol=1e-12, atol=1e-12)

    def test_compiled_ipm_large_uses_blocked_and_converges(self):
        """A >2x2 augmented structure at n past the panel width: the auto
        LDL^T path (now blocked for single instances) still solves to
        reference tolerances."""
        from ipmzoo.formulations import (EqualityHandling, Settings)
        from ipmzoo.models import CompiledIPM, QPData

        rng = np.random.default_rng(7)
        n, m_eq = 150, 20
        M = rng.normal(size=(n, n))
        Q = M @ M.T / n + np.eye(n)
        C = rng.normal(size=(m_eq, n))
        x_feas = rng.uniform(-0.5, 0.5, size=n)
        data = QPData.make(
            Q=Q, c=rng.normal(size=n),
            A_eq=C, b_eq=C @ x_feas,
            l_x=np.full(n, -2.0), u_x=np.full(n, 2.0))
        settings = Settings(
            inequalities=__import__(
                "ipmzoo.formulations", fromlist=["Bounds"]).Bounds.NONE,
            equalities=True,
            equality_handling=EqualityHandling.REGULARIZATION)
        solver = CompiledIPM(settings, n=n, m_eq=m_eq, kernel="ldlt")
        res = solver.solve(data)
        assert bool(res.converged)
        assert float(res.gap) < 1e-8
