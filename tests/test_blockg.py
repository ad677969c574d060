"""Signed block-Cholesky (ops/blockg.py) tests.

Covers: factor/solve parity with dense numpy on mixed-sign quasi-definite
block matrices, agreement with the block2 path on its 2x2 case, the
structural sign rule across formulation-lattice samples, and end-to-end
CompiledIPM(kernel='blockg') parity with the LDL^T path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.ops.blockg import (blockg_factor, blockg_matvec,
                                   blockg_solve)


def _spd(n, rng):
    M = rng.normal(size=(n, n))
    return M @ M.T / max(n, 1) + np.eye(n)


def _qd_blocks(sizes, signs, seed=0):
    """Random quasi-definite block matrix with the given diagonal signs.

    Quasi-definiteness constrains the *joint* primal submatrix to be SPD
    and the joint dual submatrix to be SND (coupling between + and -
    groups is free), so the generator builds those jointly and scatters
    them back into the interleaved group order."""
    rng = np.random.default_rng(seed)
    G = len(sizes)
    total = sum(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    pos = [i for i in range(G) if signs[i] > 0]
    neg = [i for i in range(G) if signs[i] < 0]
    npos = sum(sizes[i] for i in pos)
    nneg = sum(sizes[i] for i in neg)
    P = _spd(npos, rng)
    N = _spd(nneg, rng)
    C = rng.normal(size=(npos, nneg))
    dense = np.zeros((total, total))
    # index maps: position of each group inside the P / N submatrices
    p_off, n_off = {}, {}
    o = 0
    for i in pos:
        p_off[i] = o
        o += sizes[i]
    o = 0
    for i in neg:
        n_off[i] = o
        o += sizes[i]

    def sl(i):
        return slice(offs[i], offs[i] + sizes[i])

    for i in range(G):
        for j in range(G):
            si, sj = sizes[i], sizes[j]
            if signs[i] > 0 and signs[j] > 0:
                cell = P[p_off[i]:p_off[i] + si, p_off[j]:p_off[j] + sj]
            elif signs[i] < 0 and signs[j] < 0:
                cell = -N[n_off[i]:n_off[i] + si, n_off[j]:n_off[j] + sj]
            elif signs[i] > 0:
                cell = C[p_off[i]:p_off[i] + si, n_off[j]:n_off[j] + sj]
            else:
                cell = C[p_off[j]:p_off[j] + sj,
                         n_off[i]:n_off[i] + si].T
            dense[sl(i), sl(j)] = cell
    blocks = [[jnp.asarray(dense[sl(i), sl(j)]) for j in range(G)]
              for i in range(G)]
    return blocks, dense


class TestBlockG:
    @pytest.mark.parametrize("sizes,signs", [
        ((8, 5), (1.0, -1.0)),
        ((10, 6, 4), (1.0, 1.0, -1.0)),
        ((7, 5, 6, 3), (1.0, -1.0, 1.0, -1.0)),
        ((9, 0, 4), (1.0, 1.0, -1.0)),      # empty middle group
    ])
    def test_solve_matches_dense(self, sizes, signs):
        blocks, dense = _qd_blocks(sizes, signs)
        rng = np.random.default_rng(1)
        b = rng.normal(size=dense.shape[0])
        factors = blockg_factor(blocks, signs)
        x = blockg_solve(factors, jnp.asarray(b))
        np.testing.assert_allclose(dense @ np.asarray(x), b, rtol=1e-9,
                                   atol=1e-9)

    def test_matvec(self):
        sizes, signs = (6, 4, 5), (1.0, -1.0, -1.0)
        blocks, dense = _qd_blocks(sizes, signs, seed=2)
        rng = np.random.default_rng(3)
        x = rng.normal(size=dense.shape[0])
        parts = [jnp.asarray(x[:6]), jnp.asarray(x[6:10]),
                 jnp.asarray(x[10:])]
        out = np.concatenate([np.asarray(p)
                              for p in blockg_matvec(blocks, parts)])
        np.testing.assert_allclose(out, dense @ x, rtol=1e-12, atol=1e-12)

    def test_matches_block2(self):
        """G=2 with signs (+,-) is exactly the Cholesky+Schur path."""
        from ipmzoo.ops.block_solve import block2_factor, block2_solve
        blocks, dense = _qd_blocks((12, 7), (1.0, -1.0), seed=4)
        rng = np.random.default_rng(5)
        b = rng.normal(size=19)
        x_g = blockg_solve(blockg_factor(blocks, (1.0, -1.0)),
                           jnp.asarray(b))
        H, BT = blocks[0][0], blocks[0][1]
        B, negC = blocks[1][0], blocks[1][1]
        f2 = block2_factor(H, B, -negC)
        dx, dy = block2_solve(f2, jnp.asarray(b[:12]), jnp.asarray(b[12:]))
        np.testing.assert_allclose(np.asarray(x_g),
                                   np.concatenate([np.asarray(dx),
                                                   np.asarray(dy)]),
                                   rtol=1e-9, atol=1e-9)


def _sample_settings():
    """A diverse sample of quasi-definite formulation points."""
    out = [Settings()]
    out.append(Settings(inequalities=Bounds.LOWER,
                        inequality_handling=InequalityHandling.NAIVE_SLACKS))
    out.append(Settings(equalities=True,
                        equality_handling=EqualityHandling.REGULARIZATION))
    out.append(Settings(
        equalities=True,
        equality_handling=EqualityHandling.SLACKED_SLACKS))
    out.append(Settings(
        equalities=True,
        equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL,
        inequality_handling=InequalityHandling.SLACKS))
    out.append(Settings(inequalities=Bounds.NONE,
                        variable_bounds=Bounds.BOTH))
    return out


def _demo_data(n, m_ineq, m_eq, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T / n + np.eye(n)
    x_feas = rng.uniform(-0.5, 0.5, size=n)
    A = rng.normal(size=(m_ineq, n))
    C = rng.normal(size=(m_eq, n))
    mid = A @ x_feas if m_ineq else np.zeros(0)
    return QPData.make(
        Q=Q, c=rng.normal(size=n),
        A_ineq=A if m_ineq else None,
        l_A_ineq=mid - 1 if m_ineq else None,
        u_A_ineq=mid + 1 if m_ineq else None,
        A_eq=C if m_eq else None, b_eq=C @ x_feas if m_eq else None,
        l_x=np.full(n, -2.0), u_x=np.full(n, 2.0))


class TestSignRule:
    @pytest.mark.parametrize("idx", range(6))
    def test_diagonal_signs_structural(self, idx):
        """Evaluated augmented diagonal blocks at the initial iterate have
        the definiteness the primal/dual rule claims."""
        settings = _sample_settings()[idx]
        n, mi, me = 6, 3, 2
        mi = mi if settings.inequalities != Bounds.NONE else 0
        me = me if settings.equalities else 0
        solver = CompiledIPM(settings, n=n, m_ineq=mi, m_eq=me)
        if solver._indefinite:
            pytest.skip("indefinite formulation (LU path)")
        data = _demo_data(n, mi, me)
        state = solver.init_state(data)
        env = solver._env(data, state.vars, state.mu)
        blocks = solver._assemble_blocks(env)
        for i, sign in enumerate(solver.group_signs):
            cell = np.asarray(blocks[i][i])
            if cell.shape[0] == 0:
                continue
            ev = np.linalg.eigvalsh(0.5 * (cell + cell.T))
            assert (sign * ev > 0).all(), (
                f"group {i} ({solver.aug.variables[i].name}) sign {sign} "
                f"but eigs {ev}")


class TestCompiledIPMBlockG:
    @pytest.mark.parametrize("settings,mi,me", [
        (Settings(), 3, 0),
        (Settings(equalities=True,
                  equality_handling=EqualityHandling.SLACKED_SLACKS), 3, 2),
        (Settings(equalities=True,
                  equality_handling=EqualityHandling.REGULARIZATION,
                  inequality_handling=InequalityHandling.NAIVE_SLACKS),
         3, 2),
    ])
    def test_matches_ldlt_path(self, settings, mi, me):
        n = 8
        data = _demo_data(n, mi, me, seed=11)
        res_l = CompiledIPM(settings, n=n, m_ineq=mi, m_eq=me,
                            kernel="ldlt").solve(data)
        res_g = CompiledIPM(settings, n=n, m_ineq=mi, m_eq=me,
                            kernel="blockg").solve(data)
        assert bool(res_l.converged) and bool(res_g.converged)
        np.testing.assert_allclose(np.asarray(res_g.x),
                                   np.asarray(res_l.x), rtol=1e-6,
                                   atol=1e-8)

    def test_auto_selects_blockg_for_large_multiblock(self):
        settings = Settings(
            equalities=True,
            equality_handling=EqualityHandling.SLACKED_SLACKS)
        solver = CompiledIPM(settings, n=400, m_ineq=10, m_eq=10)
        assert solver._mode in ("block", "blockg")

    def test_refinement(self):
        data = _demo_data(8, 3, 0, seed=13)
        res = CompiledIPM(Settings(), n=8, m_ineq=3, kernel="blockg",
                          refine=1).solve(data)
        assert bool(res.converged)
