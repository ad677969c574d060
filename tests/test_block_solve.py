"""Block-elimination (Cholesky + Schur) kernel and solver mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import Settings
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.ops.block_solve import block2_factor, block2_matvec, \
    block2_solve


def make_blocks(n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = jnp.asarray(M @ M.T / n + np.eye(n))
    B = jnp.asarray(rng.normal(size=(m, n)))
    N = rng.normal(size=(m, m))
    C = jnp.asarray(N @ N.T / m + np.eye(m))
    return H, B, C


@pytest.mark.parametrize("n,m", [(8, 3), (40, 17), (100, 30)])
def test_block2_solves_kkt(n, m):
    H, B, C = make_blocks(n, m, seed=n)
    K = jnp.block([[H, B.T], [B, -C]])
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=n + m))
    f = block2_factor(H, B, C)
    dx, dy = block2_solve(f, b[:n], b[n:])
    sol = jnp.concatenate([dx, dy])
    np.testing.assert_allclose(np.asarray(K @ sol), np.asarray(b),
                               rtol=1e-8, atol=1e-8)


def test_block2_matvec():
    H, B, C = make_blocks(6, 2, seed=0)
    K = jnp.block([[H, B.T], [B, -C]])
    x = jnp.asarray(np.random.default_rng(2).normal(size=8))
    y1, y2 = block2_matvec(H, B, C, x[:6], x[6:])
    np.testing.assert_allclose(np.asarray(jnp.concatenate([y1, y2])),
                               np.asarray(K @ x), rtol=1e-12)


def test_block2_no_constraints():
    H, _, _ = make_blocks(5, 1, seed=3)
    B = jnp.zeros((0, 5))
    C = jnp.zeros((0, 0))
    f = block2_factor(H, B, C)
    b = jnp.asarray(np.random.default_rng(0).normal(size=5))
    dx, dy = block2_solve(f, b, jnp.zeros(0))
    np.testing.assert_allclose(np.asarray(H @ dx), np.asarray(b), atol=1e-9)


class TestSolverBlockMode:
    def test_matches_ldlt_mode(self):
        rng = np.random.default_rng(0)
        n, m = 16, 6
        M = rng.normal(size=(n, n))
        data = QPData.make(
            Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
            A_ineq=rng.normal(size=(m, n)),
            l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
            u_A_ineq=np.abs(rng.normal(size=m)) + 1,
            l_x=-5 * np.ones(n), u_x=5 * np.ones(n), dtype=jnp.float64)
        s_ldlt = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="ldlt")
        s_block = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="block")
        r1, r2 = s_ldlt.solve(data), s_block.solve(data)
        assert bool(r1.converged) and bool(r2.converged)
        assert int(r1.iterations) == int(r2.iterations)
        np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                                   atol=1e-12)

    def test_block_mode_rejects_non_2x2(self):
        from ipmzoo.formulations import InequalityHandling
        with pytest.raises(ValueError):
            # Slacks handling yields a 3-block augmented system? For the
            # demo formulation it reduces to 2x2 with x leading; use a
            # bounds-free equality-free formulation (1x1) instead.
            from ipmzoo.formulations import Bounds
            CompiledIPM(Settings(inequalities=Bounds.NONE,
                                 variable_bounds=Bounds.NONE),
                        n=4, kernel="block")

    def test_refinement_in_block_mode(self):
        rng = np.random.default_rng(5)
        n, m = 12, 4
        M = rng.normal(size=(n, n))
        data = QPData.make(
            Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
            A_ineq=rng.normal(size=(m, n)),
            l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
            u_A_ineq=np.abs(rng.normal(size=m)) + 1,
            l_x=-5 * np.ones(n), u_x=5 * np.ones(n), dtype=jnp.float64)
        s = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="block", refine=1)
        res = s.solve(data)
        assert bool(res.converged)


class TestExplicitInverse:
    """block2_factor_inv binds explicit H^{-1}/S^{-1} so direction
    solves are matvecs (the opt-in block2_factor_inv); must match the
    triangular-solve staging to roundoff."""

    def test_inv_matches_triangular(self):
        import numpy as np
        from ipmzoo.ops.block_solve import (block2_factor,
                                                block2_factor_inv,
                                                block2_solve,
                                                block2_solve_inv)
        rng = np.random.default_rng(0)
        n, m = 20, 6
        Mh = rng.normal(size=(n, n))
        H = jnp.asarray(Mh @ Mh.T / n + np.eye(n))
        B = jnp.asarray(rng.normal(size=(m, n)))
        Mc = rng.normal(size=(m, m))
        C = jnp.asarray(Mc @ Mc.T / m + np.eye(m))
        r1 = jnp.asarray(rng.normal(size=n))
        r2 = jnp.asarray(rng.normal(size=m))
        dx0, dy0 = block2_solve(block2_factor(H, B, C), r1, r2)
        dx1, dy1 = block2_solve_inv(block2_factor_inv(H, B, C), r1, r2)
        np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx0),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(dy1), np.asarray(dy0),
                                   atol=1e-10)

    def test_empty_dual_block(self):
        import numpy as np
        from ipmzoo.ops.block_solve import (block2_factor_inv,
                                                block2_solve_inv)
        rng = np.random.default_rng(1)
        n = 8
        Mh = rng.normal(size=(n, n))
        H = jnp.asarray(Mh @ Mh.T / n + np.eye(n))
        B = jnp.zeros((0, n))
        C = jnp.zeros((0, 0))
        r1 = jnp.asarray(rng.normal(size=n))
        dx, dy = block2_solve_inv(block2_factor_inv(H, B, C), r1,
                                  jnp.zeros((0,)))
        np.testing.assert_allclose(np.asarray(H @ dx), np.asarray(r1),
                                   atol=1e-10)
