"""Nested-dissection sparse factorisation: parity with the dense LDL^T
on banded, grid, random-sparse and quasi-definite KKT patterns, plan
quality (flop reduction), and jit-compatibility."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.ops.ldlt import ldlt_solve
from ipmzoo.ops.ndiss import nd_factor, nd_plan, nd_solve, \
    nd_solve_matrix


def banded_qd(n, bw, seed=0):
    """Banded symmetric quasi-definite matrix (positive diag on the first
    half, negative on the second)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(1, bw + 1):
        v = rng.normal(size=n - d) * 0.3
        A += np.diag(v, d) + np.diag(v, -d)
    s = np.where(np.arange(n) < n // 2, 1.0, -1.0)
    A += np.diag(s * (bw + 1.0))
    return A


def grid_spd(side, seed=0):
    """2D grid Laplacian + jitter: the classic nested-dissection case."""
    n = side * side
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(side):
        for j in range(side):
            a = i * side + j
            for di, dj in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if ii < side and jj < side:
                    b = ii * side + jj
                    w = -1.0 - 0.1 * rng.random()
                    A[a, b] = A[b, a] = w
    np.fill_diagonal(A, 5.0 + rng.random(n))
    return A


def check_roundtrip(A, atol=1e-9, leaf=16):
    n = A.shape[0]
    pattern = A != 0
    plan = nd_plan(pattern, leaf=leaf)
    rng = np.random.default_rng(42)
    b = rng.normal(size=n)
    K = jnp.asarray(A)
    factors = nd_factor(K, plan)
    x = nd_solve(plan, factors, jnp.asarray(b))
    x_ref = ldlt_solve(K, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               atol=atol, rtol=1e-7)
    return plan


class TestParity:
    def test_banded(self):
        plan = check_roundtrip(banded_qd(200, 3, seed=1))
        assert plan.flops_nd < plan.flops_dense / 20

    def test_grid(self):
        plan = check_roundtrip(grid_spd(16, seed=2))
        assert plan.flops_nd < plan.flops_dense / 5

    def test_random_sparse(self):
        rng = np.random.default_rng(3)
        n = 150
        A = np.zeros((n, n))
        for _ in range(2 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                A[i, j] = A[j, i] = rng.normal() * 0.1
        np.fill_diagonal(A, 4.0)
        check_roundtrip(A)

    def test_kkt_quasidefinite(self):
        # [[Q, A^T], [A, -delta I]] with banded Q and local constraints —
        # the shape of an augmented IPM system
        rng = np.random.default_rng(4)
        n, m = 120, 30
        Q = banded_qd(n, 2, seed=5)
        Q = Q @ Q.T / 10 + np.eye(n)   # SPD, still banded (wider)
        Q[np.abs(Q) < 1e-12] = 0.0
        A = np.zeros((m, n))
        for i in range(m):
            j = (i * n) // m
            A[i, j:j + 3] = rng.normal(size=min(3, n - j))
        K = np.block([[Q, A.T], [A, -1e-4 * np.eye(m)]])
        check_roundtrip(K, atol=1e-7)

    def test_signed_amalgamated_top(self):
        # structural signs route the merged top block through the
        # two-stage Cholesky (ops/ndiss.py::_signed_top_factor); parity
        # against the dense LDL^T on a mixed quasi-definite KKT
        rng = np.random.default_rng(11)
        n, m = 120, 30
        Q = banded_qd(n, 2, seed=12)
        Q = Q @ Q.T / 10 + np.eye(n)
        Q[np.abs(Q) < 1e-12] = 0.0
        A = np.zeros((m, n))
        for i in range(m):
            j = (i * n) // m
            A[i, j:j + 3] = rng.normal(size=min(3, n - j))
        K = np.block([[Q, A.T], [A, -1e-4 * np.eye(m)]])
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        plan = nd_plan(K != 0, leaf=16, root_merge=64, signs=signs)
        assert plan.top_neg >= 0, "amalgamated signed top expected"
        Kj = jnp.asarray(K)
        b = rng.normal(size=n + m)
        factors = nd_factor(Kj, plan)
        x = nd_solve(plan, factors, jnp.asarray(b))
        x_ref = ldlt_solve(Kj, jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   atol=1e-7, rtol=1e-7)
        # mixed split: some negatives actually reached the top block
        assert 0 < plan.top_neg < plan.levels[-1].idx.shape[1]

    def test_tree_structured(self):
        # binary-tree coupling: separators are single vertices
        n = 127
        A = np.zeros((n, n))
        for i in range(1, n):
            p = (i - 1) // 2
            A[i, p] = A[p, i] = 0.5
        np.fill_diagonal(A, 3.0)
        plan = check_roundtrip(A, leaf=8)
        assert plan.flops_nd < plan.flops_dense / 50

    def test_multi_rhs(self):
        A = grid_spd(10, seed=6)
        plan = nd_plan(A != 0, leaf=12)
        K = jnp.asarray(A)
        factors = nd_factor(K, plan)
        B = np.random.default_rng(7).normal(size=(100, 4))
        X = nd_solve_matrix(plan, factors, jnp.asarray(B))
        np.testing.assert_allclose(np.asarray(K @ X), B, atol=1e-9)

    def test_dense_fallback(self):
        # a clique cannot be dissected; the plan degrades to one block
        # and still solves correctly
        rng = np.random.default_rng(8)
        M = rng.normal(size=(20, 20))
        A = M @ M.T + np.eye(20)
        check_roundtrip(A, leaf=4)


class TestIPMConsumer:
    """kernel='nd' end-to-end: the full Mehrotra loop factoring the
    augmented KKT through the dissection plan each iteration, with the
    plan derived lazily from the data's sparsity on the first solve."""

    def _sparse_qp(self, n=96, m=12, seed=13):
        from ipmzoo.models import QPData
        rng = np.random.default_rng(seed)
        Q = banded_qd(n, 2, seed=seed)
        Q = Q @ Q.T / 8 + np.eye(n)       # SPD, banded (wider)
        Q[np.abs(Q) < 1e-12] = 0.0
        A = np.zeros((m, n))
        for i in range(m):
            j = (i * n) // m
            A[i, j:j + 4] = rng.normal(size=min(4, n - j))
        return QPData(
            Q=jnp.asarray(Q), c=jnp.asarray(rng.normal(size=n)),
            A_ineq=jnp.asarray(A),
            l_A_ineq=jnp.asarray(-np.abs(rng.normal(size=m)) - 1),
            u_A_ineq=jnp.asarray(np.abs(rng.normal(size=m)) + 1),
            A_eq=jnp.zeros((0, n)), b_eq=jnp.zeros((0,)),
            l_x=jnp.full((n,), -2.0), u_x=jnp.full((n,), 2.0))

    def test_nd_matches_dense_kernel(self):
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM
        n, m = 96, 12
        data = self._sparse_qp(n, m)
        nd = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="nd",
                         nd_leaf=16)
        ref = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="jnp")
        r_nd = nd.solve(data)
        r_ref = ref.solve(data)
        assert bool(r_nd.converged) and bool(r_ref.converged)
        np.testing.assert_allclose(np.asarray(r_nd.x), np.asarray(r_ref.x),
                                   atol=1e-7)
        # the lazily derived plan must actually exploit the sparsity
        plan = nd._nd_plan
        assert plan is not None and plan.flops_nd < plan.flops_dense / 3

    def test_nd_solve_batch(self):
        # batched QPs share the structure (plan derived from instance 0)
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM
        n, m, B = 64, 8, 3
        insts = [self._sparse_qp(n, m, seed=20 + i) for i in range(B)]
        base = insts[0]
        # identical sparsity across the batch: keep instance 0's Q/A
        # structure, vary the dense vectors
        data = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
            type(base)(Q=base.Q, c=d.c, A_ineq=base.A_ineq,
                       l_A_ineq=d.l_A_ineq, u_A_ineq=d.u_A_ineq,
                       A_eq=base.A_eq, b_eq=base.b_eq,
                       l_x=base.l_x, u_x=base.u_x) for d in insts])
        nd = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="nd",
                         nd_leaf=16)
        ref = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="jnp")
        r_nd = nd.solve_batch(data)
        r_ref = ref.solve_batch(data)
        assert bool(jnp.all(r_nd.converged))
        np.testing.assert_allclose(np.asarray(r_nd.x),
                                   np.asarray(r_ref.x), atol=1e-7)

    def test_explicit_pattern(self):
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM
        n, m = 64, 8
        data = self._sparse_qp(n, m, seed=14)
        probe = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="nd")
        st = probe.init_state(data)
        env = probe._env(data, st.vars, jnp.asarray(1.0, probe.dtype))
        pattern = np.asarray(probe._assemble_kkt(env)) != 0
        nd = CompiledIPM(Settings(), n=n, m_ineq=m, kernel="nd",
                         nd_pattern=pattern, nd_leaf=16)
        res = nd.solve(data)
        assert bool(res.converged)


class TestJit:
    def test_factor_solve_under_jit(self):
        A = grid_spd(12, seed=9)
        plan = nd_plan(A != 0, leaf=16)

        @jax.jit
        def solve(K, b):
            return nd_solve(plan, nd_factor(K, plan), b)

        b = np.random.default_rng(10).normal(size=A.shape[0])
        x = solve(jnp.asarray(A), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(A @ np.asarray(x)), b,
                                   atol=1e-9)

    def test_disconnected(self):
        # two independent components solve as a forest
        A1 = grid_spd(6, seed=11)
        A2 = banded_qd(40, 2, seed=12)
        n1, n2 = A1.shape[0], A2.shape[0]
        A = np.zeros((n1 + n2, n1 + n2))
        A[:n1, :n1] = A1
        A[n1:, n1:] = A2
        check_roundtrip(A, leaf=8)


class TestPallasMethod:
    """On the GPU each level's batched factor/solves can run as the
    Pallas kernels (method='pl'); here they run in the Pallas
    interpreter.  Pin parity with the plain jnp path on a grid KKT."""

    def test_pl_equals_jnp(self):
        A = grid_spd(8, seed=13)
        n = A.shape[0]
        plan = nd_plan(A != 0, leaf=16)
        K = jnp.asarray(A, jnp.float64)
        b = jnp.asarray(np.random.default_rng(3).normal(size=n))
        f_j = nd_factor(K, plan, method="jnp")
        f_p = nd_factor(K, plan, method="pl", interpret=True)
        x_j = nd_solve(plan, f_j, b, method="jnp")
        x_p = nd_solve(plan, f_p, b, method="pl", interpret=True)
        np.testing.assert_allclose(np.asarray(x_p), np.asarray(x_j),
                                   atol=1e-10, rtol=1e-10)
        x_ref = ldlt_solve(K, b)
        np.testing.assert_allclose(np.asarray(x_p), np.asarray(x_ref),
                                   atol=1e-8, rtol=1e-7)


class TestAutoFallback:
    """kernel='nd' must never silently run a plan predicted to lose to
    the dense path (a large flop ratio can still lose to per-level
    overhead)."""

    def test_small_grid_falls_back_to_dense(self):
        from ipmzoo.models import CompiledIPM
        from ipmzoo.models.families import grid_qp
        fam = grid_qp(side=6, seed=0, dtype=jnp.float64)
        s = CompiledIPM(fam.settings, n=36, dtype=jnp.float64, tol=1e-7,
                        kernel="nd", nd_leaf=8)
        r = s.solve(fam.data)
        assert s.nd_fell_back and s._mode != "nd"
        assert bool(r.converged)

    def test_fallback_disabled_keeps_nd(self):
        from ipmzoo.models import CompiledIPM
        from ipmzoo.models.families import grid_qp
        fam = grid_qp(side=6, seed=0, dtype=jnp.float64)
        s = CompiledIPM(fam.settings, n=36, dtype=jnp.float64, tol=1e-7,
                        kernel="nd", nd_leaf=8, nd_fallback=False)
        r = s.solve(fam.data)
        assert not s.nd_fell_back and s._mode == "nd"
        assert bool(r.converged)

    def test_fallback_matches_nd_solution(self):
        from ipmzoo.models import CompiledIPM
        from ipmzoo.models.families import grid_qp
        fam = grid_qp(side=5, seed=1, dtype=jnp.float64)
        kw = dict(n=25, dtype=jnp.float64, tol=1e-8, kernel="nd")
        r_fb = CompiledIPM(fam.settings, **kw).solve(fam.data)
        r_nd = CompiledIPM(fam.settings, nd_fallback=False,
                           **kw).solve(fam.data)
        np.testing.assert_allclose(np.asarray(r_fb.x),
                                   np.asarray(r_nd.x), atol=1e-6)
