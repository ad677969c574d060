"""Two-float compensated arithmetic (ops/twofloat.py).

Error-free transformation exactness is checked in f64 (an f32 product /
sum error fits exactly in f64), compensated reductions against numpy
f64, and the payoff end-to-end: mixed-precision iterative refinement in
f32 recovers near-f64 forward accuracy on ill-conditioned systems where
plain f32 refinement stalls."""

import jax.numpy as jnp
import numpy as np

from ipmzoo.ops.twofloat import (comp_dot, comp_matvec, comp_norm2,
                                     comp_residual, df_sum, two_prod,
                                     two_sum)

F32 = jnp.float32


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


class TestErrorFree:
    def test_two_sum_exact(self):
        rng = np.random.default_rng(0)
        a = _f32(rng.normal(size=1000) * 10.0 ** rng.integers(-6, 6, 1000))
        b = _f32(rng.normal(size=1000) * 10.0 ** rng.integers(-6, 6, 1000))
        s, e = two_sum(a, b)
        lhs = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        rhs = np.asarray(s, np.float64) + np.asarray(e, np.float64)
        np.testing.assert_array_equal(lhs, rhs)

    def test_two_prod_exact(self):
        rng = np.random.default_rng(1)
        a = _f32(rng.normal(size=1000))
        b = _f32(rng.normal(size=1000))
        p, e = two_prod(a, b)
        lhs = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        rhs = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        np.testing.assert_array_equal(lhs, rhs)

    def test_df_sum_cancellation(self):
        # sum of (big, -big, tiny...) pairs: plain f32 sum loses the
        # tinies entirely; the pair sum keeps them
        n = 256
        big = np.full(n, 1e8, np.float32)
        tiny = np.full(n, 1.0, np.float32)
        vals = np.concatenate([big, -big, tiny]).astype(np.float32)
        rng = np.random.default_rng(2)
        rng.shuffle(vals)
        hi, lo = df_sum(_f32(vals), jnp.zeros(3 * n, F32))
        total = float(np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
        assert total == float(n)


class TestCompensatedOps:
    def test_comp_dot_vs_f64(self):
        rng = np.random.default_rng(3)
        a = rng.normal(size=4096).astype(np.float32)
        b = rng.normal(size=4096).astype(np.float32)
        ref = np.dot(a.astype(np.float64), b.astype(np.float64))
        hi, lo = comp_dot(_f32(a), _f32(b))
        got = float(np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
        assert abs(got - ref) <= 1e-10 * abs(ref)
        plain = float(np.dot(a, b))
        assert abs(got - ref) < abs(plain - ref) or plain == ref

    def test_comp_matvec_vs_f64(self):
        rng = np.random.default_rng(4)
        K = rng.normal(size=(64, 512)).astype(np.float32)
        x = rng.normal(size=512).astype(np.float32)
        ref = K.astype(np.float64) @ x.astype(np.float64)
        hi, lo = comp_matvec(_f32(K), _f32(x))
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)

    def test_comp_residual_beats_plain(self):
        """Near a solution, b - Kx is pure cancellation: the compensated
        residual tracks the f64 residual; the plain f32 one is noise."""
        rng = np.random.default_rng(5)
        n = 300
        M = rng.normal(size=(n, n))
        K = (M @ M.T / n + np.eye(n)).astype(np.float32)
        x_true = rng.normal(size=n)
        b = (K.astype(np.float64) @ x_true).astype(np.float32)
        x = np.linalg.solve(K.astype(np.float64),
                            b.astype(np.float64)).astype(np.float32)
        exact = b.astype(np.float64) - K.astype(np.float64) @ \
            x.astype(np.float64)
        comp = np.asarray(comp_residual(_f32(b), _f32(K), _f32(x)),
                          np.float64)
        plain = np.asarray(_f32(b) - _f32(K) @ _f32(x), np.float64)
        err_comp = np.linalg.norm(comp - exact)
        err_plain = np.linalg.norm(plain - exact)
        assert err_comp < 1e-3 * np.linalg.norm(exact)
        assert err_plain > 10 * err_comp

    def test_comp_norm2(self):
        rng = np.random.default_rng(6)
        r = rng.normal(size=2000).astype(np.float32) * 1e-4
        ref = np.linalg.norm(r.astype(np.float64))
        got = float(comp_norm2(_f32(r)))
        assert abs(got - ref) <= 1e-6 * ref

    def test_empty(self):
        hi, lo = df_sum(jnp.zeros(0, F32), jnp.zeros(0, F32))
        assert float(hi) == 0.0

    def test_f64_dtype_supported(self):
        rng = np.random.default_rng(7)
        a = jnp.asarray(rng.normal(size=100))     # f64 under x64
        b = jnp.asarray(rng.normal(size=100))
        s, e = two_prod(a, b)
        assert s.dtype == jnp.float64


class TestMixedPrecisionRefinement:
    def _ill_conditioned(self, n, cond, seed=0):
        rng = np.random.default_rng(seed)
        U, _ = np.linalg.qr(rng.normal(size=(n, n)))
        d = np.logspace(0, -np.log10(cond), n)
        K = (U * d) @ U.T
        return K.astype(np.float32)

    def test_refinement_reaches_f32_floor(self):
        from ipmzoo.ops.ldlt import ldlt, solve_ldlt
        n, cond = 200, 1e5
        K = self._ill_conditioned(n, cond)
        rng = np.random.default_rng(1)
        x_true = rng.normal(size=n)
        b = (K.astype(np.float64) @ x_true).astype(np.float32)
        x_ref = np.linalg.solve(K.astype(np.float64), b.astype(np.float64))

        Kj, bj = _f32(K), _f32(b)
        L, D = ldlt(Kj)

        def refine(hybrid, sweeps=4):
            x = solve_ldlt(L, D, bj)
            for _ in range(sweeps):
                if hybrid:
                    r = comp_residual(bj, Kj, x)
                else:
                    r = bj - Kj @ x
                x = x + solve_ldlt(L, D, r)
            return np.asarray(x, np.float64)

        err_plain = np.linalg.norm(refine(False) - x_ref) / \
            np.linalg.norm(x_ref)
        err_hybrid = np.linalg.norm(refine(True) - x_ref) / \
            np.linalg.norm(x_ref)
        # hybrid reaches the f32 representation floor; plain stalls at
        # ~cond * eps
        assert err_hybrid < 3e-6
        assert err_plain > 3 * err_hybrid

    def test_compiled_ipm_hybrid_refine(self):
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM, QPData
        rng = np.random.default_rng(8)
        n, mi = 24, 8
        M = rng.normal(size=(n, n))
        Q = M @ M.T / n + np.eye(n)
        xf = rng.uniform(-0.5, 0.5, size=n)
        A = rng.normal(size=(mi, n))
        data = QPData.make(Q=Q, c=rng.normal(size=n), A_ineq=A,
                           l_A_ineq=A @ xf - 1, u_A_ineq=A @ xf + 1,
                           l_x=np.full(n, -2.0), u_x=np.full(n, 2.0),
                           dtype=jnp.float32)
        ref = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                          tol=1e-5).solve(data)
        hyb = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                          tol=1e-5, refine=2,
                          hybrid_refine=True).solve(data)
        assert bool(ref.converged) and bool(hyb.converged)
        np.testing.assert_allclose(np.asarray(hyb.x), np.asarray(ref.x),
                                   rtol=1e-3, atol=1e-4)
