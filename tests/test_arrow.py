"""Banded+arrow structured KKT: detector, ops, and the ArrowIPM model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import Bounds, InequalityHandling, Settings
from ipmzoo.models import ArrowIPM, ArrowQPData, CompiledIPM, QPData
from ipmzoo.ops.banded import (arrow_factor, arrow_solve,
                                   band_to_blocks, bt_factor, bt_solve,
                                   detect_arrow)


def make_arrow_spd(n, b, t, seed, shuffle=False):
    """SPD banded+arrow matrix; optionally under a random symmetric
    permutation (to exercise the detector's RCM stage)."""
    rng = np.random.default_rng(seed)
    nb = n - t
    Q = np.zeros((n, n))
    for i in range(nb):
        lo, hi = max(0, i - b), min(nb, i + b + 1)
        Q[i, lo:hi] = rng.normal(size=hi - lo) * 0.1
    Q = (Q + Q.T) / 2
    strip = rng.normal(size=(t, n)) * 0.1
    Q[nb:, :] = strip
    Q[:, nb:] = strip.T
    Q[nb:, nb:] = (strip[:, nb:] + strip[:, nb:].T) / 2
    Q += np.eye(n) * (2 * b + t)
    if shuffle:
        p = rng.permutation(n)
        Q = Q[np.ix_(p, p)]
    return Q


class TestDetector:
    @pytest.mark.parametrize("n,b,t,shuffle", [
        (93, 8, 5, False), (128, 4, 3, False),
        (256, 16, 8, True), (200, 8, 0, True)])
    def test_exact_recovery(self, n, b, t, shuffle):
        Q = make_arrow_spd(n, b, t, seed=n + t, shuffle=shuffle)
        st = detect_arrow(Q)
        assert st.bandwidth == b and st.tip == t
        # the permutation must actually produce the claimed structure
        Qp = Q[np.ix_(st.perm, st.perm)]
        nb = n - st.tip
        ii, jj = np.nonzero(np.abs(np.triu(Qp[:nb, :nb], 1)) > 0)
        assert (np.abs(ii - jj) <= st.bandwidth).all()

    def test_dense_matrix_gets_no_structure(self):
        rng = np.random.default_rng(0)
        M = rng.normal(size=(40, 40))
        Q = M @ M.T + np.eye(40)
        st = detect_arrow(Q)
        assert st.tip <= 10            # nothing useful to peel
        assert st.bandwidth >= 20      # genuinely dense

    def test_diagonal(self):
        st = detect_arrow(np.eye(16))
        assert st.bandwidth == 1 and st.tip == 0


class TestOps:
    def test_bt_factor_solve(self):
        Q = make_arrow_spd(64, 8, 0, seed=1)
        D, E, U, C = band_to_blocks(jnp.asarray(Q), 8, 0)
        f = bt_factor(D, E)
        r = np.random.default_rng(2).normal(size=(64, 3))
        z = bt_solve(f, jnp.asarray(r.reshape(8, 8, 3)))
        np.testing.assert_allclose(
            Q @ np.asarray(z).reshape(64, 3), r, atol=1e-11)

    def test_arrow_factor_solve(self):
        n, b, t = 93, 8, 5
        Q = make_arrow_spd(n, b, t, seed=3)
        D, E, U, C = band_to_blocks(jnp.asarray(Q), b, t)
        f = arrow_factor(D, E, U, C)
        r = np.random.default_rng(4).normal(size=n)
        xb, xt = arrow_solve(f, jnp.asarray(r[:n - t]),
                             jnp.asarray(r[n - t:]))
        x = np.concatenate([np.asarray(xb), np.asarray(xt)])
        np.testing.assert_allclose(Q @ x, r, atol=1e-11)

    def test_band_to_blocks_rejects_ragged(self):
        with pytest.raises(ValueError):
            band_to_blocks(jnp.eye(11), 4, 2)   # banded part 9 % 4 != 0


def random_arrow_qp(n, b, t, seed, shuffle=True):
    rng = np.random.default_rng(seed)
    Q = make_arrow_spd(n, b, t, seed, shuffle=shuffle)
    c = rng.normal(size=n) * 3
    l = -np.abs(rng.normal(size=n)) - 0.1
    u = np.abs(rng.normal(size=n)) + 0.1
    return Q, c, l, u


class TestArrowIPM:
    def test_solves_vs_dense_path(self):
        n, b, t = 93, 8, 5
        Q, c, l, u = random_arrow_qp(n, b, t, seed=7)
        data, st, blk = ArrowQPData.from_dense(Q, c, l, u)
        assert (st.bandwidth, st.tip) == (b, t)
        solver = ArrowIPM.for_data(data, structure=st)
        res = solver.solve(data)
        assert bool(res.converged) and not bool(res.diverged)
        assert float(res.residual) < 1e-8 and float(res.gap) < 1e-8

        dense = CompiledIPM(
            Settings(inequalities=Bounds.NONE,
                     inequality_handling=InequalityHandling.SLACKS),
            n=n, dtype=jnp.float64)
        dres = dense.solve(QPData.make(Q=Q, c=c, l_x=l, u_x=u,
                                       dtype=jnp.float64))
        assert bool(dres.converged)
        np.testing.assert_allclose(np.asarray(res.x),
                                   np.asarray(dres.x), atol=1e-7)
        np.testing.assert_allclose(float(res.objective),
                                   float(dres.objective), rtol=1e-9)

    def test_pure_banded_no_tip(self):
        n, b = 64, 4
        Q, c, l, u = random_arrow_qp(n, b, 0, seed=9, shuffle=False)
        data, st, blk = ArrowQPData.from_dense(Q, c, l, u)
        assert st.tip == 0
        res = ArrowIPM.for_data(data, structure=st).solve(data)
        assert bool(res.converged)
        dense = CompiledIPM(
            Settings(inequalities=Bounds.NONE,
                     inequality_handling=InequalityHandling.SLACKS),
            n=n, dtype=jnp.float64)
        dres = dense.solve(QPData.make(Q=Q, c=c, l_x=l, u_x=u,
                                       dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(res.x),
                                   np.asarray(dres.x), atol=1e-7)

    def test_padding_path(self):
        # n - t not a multiple of the block: from_dense pads with benign
        # interior variables; solution in original order is unaffected
        n, b, t = 90, 8, 5   # nb = 85, pads to 88
        Q, c, l, u = random_arrow_qp(n, b, t, seed=11, shuffle=False)
        data, st, blk = ArrowQPData.from_dense(Q, c, l, u)
        assert data.c.shape[0] > n
        res = ArrowIPM.for_data(data, structure=st).solve(data)
        assert bool(res.converged)
        assert res.x.shape == (n,)
        dense = CompiledIPM(
            Settings(inequalities=Bounds.NONE,
                     inequality_handling=InequalityHandling.SLACKS),
            n=n, dtype=jnp.float64)
        dres = dense.solve(QPData.make(Q=Q, c=c, l_x=l, u_x=u,
                                       dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(res.x),
                                   np.asarray(dres.x), atol=1e-7)

    def test_batched(self):
        n, b, t = 61, 4, 3
        datas = []
        st0 = None
        for seed in range(4):
            Q, c, l, u = random_arrow_qp(n, b, t, seed=20, shuffle=False)
            rng = np.random.default_rng(100 + seed)
            c = rng.normal(size=n)
            data, st, blk = ArrowQPData.from_dense(
                Q, c, l, u, structure=st0)
            st0 = st
            datas.append(data)
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *datas)
        solver = ArrowIPM.for_data(datas[0], structure=st0)
        res = solver.solve_batch(batch)
        assert bool(jnp.all(res.converged))
        for i in range(4):
            single = solver.solve(datas[i])
            np.testing.assert_allclose(np.asarray(res.x[i]),
                                       np.asarray(single.x), atol=1e-9)


class TestCyclicReduction:
    @pytest.mark.parametrize("N,b", [(4, 8), (5, 8), (32, 16), (1, 8)])
    def test_cr_matches_dense(self, N, b):
        from ipmzoo.ops.banded import cr_factor, cr_solve
        n = N * b
        Q = make_arrow_spd(n, b, 0, seed=N * 10 + b)
        D, E, U, C = band_to_blocks(jnp.asarray(Q), b, 0)
        f = cr_factor(D, E)
        r = np.random.default_rng(1).normal(size=(n, 3))
        x = cr_solve(f, jnp.asarray(r.reshape(N, b, 3)))
        np.testing.assert_allclose(
            Q @ np.asarray(x).reshape(n, 3), r, atol=1e-11)

    def test_arrow_cr_matches_scan(self):
        n, b, t = 93, 8, 5
        Q = make_arrow_spd(n, b, t, seed=42)
        D, E, U, C = band_to_blocks(jnp.asarray(Q), b, t)
        r = np.random.default_rng(2).normal(size=n)
        outs = []
        for method in ("scan", "cr"):
            f = arrow_factor(D, E, U, C, method=method)
            xb, xt = arrow_solve(f, jnp.asarray(r[:n - t]),
                                 jnp.asarray(r[n - t:]))
            outs.append(np.concatenate([np.asarray(xb), np.asarray(xt)]))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-11,
                                   atol=1e-11)


def test_arrow_warm_start_reduces_iterations():
    n, b, t = 61, 4, 3
    Q, c, l, u = random_arrow_qp(n, b, t, seed=30, shuffle=False)
    data, st, blk = ArrowQPData.from_dense(Q, c, l, u)
    solver = ArrowIPM.for_data(data, structure=st)
    cold = solver.solve(data)
    assert bool(cold.converged)
    # perturb the linear term slightly and re-solve warm
    data2, _, _ = ArrowQPData.from_dense(Q, c * 1.01, l, u, structure=st)
    warm = solver.solve(data2, warm_start=cold.variables)
    cold2 = solver.solve(data2)
    assert bool(warm.converged) and bool(cold2.converged)
    assert int(warm.iterations) <= int(cold2.iterations)
    np.testing.assert_allclose(np.asarray(warm.x), np.asarray(cold2.x),
                               atol=1e-7)
