"""End-to-end IPM solves: reference-oracle parity and independent checks.

The oracle numbers come from running the reference implementation's
Optimizer on the demo QP (src/IpmZoo.cpp:360-367) with SlackedSlacks
handling, where its corrector is correct: it converges in 12 iterations to
res=1.932123e-10, gap=4.940198e-11, x=(1.2, 3.279374e-13).  (With Slacks
handling the reference's corrector is broken and it never converges; our
exact Taylor-remainder corrector converges in 7 iterations.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo.models import CompiledIPM, QPData


def demo_qp(dtype=jnp.float64):
    return QPData.make(
        Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
        A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
        l_x=[0.0, 0.0], u_x=[10.0, 10.0], dtype=dtype)


@pytest.fixture(scope="module")
def solvers():
    return {}


def get_solver(cache, settings, n, m_ineq=0, m_eq=0, **kw):
    key = (settings, n, m_ineq, m_eq, tuple(sorted(kw.items())))
    if key not in cache:
        cache[key] = CompiledIPM(settings, n, m_ineq, m_eq, **kw)
    return cache[key]


class TestDemoQP:
    def test_slacked_slacks_reference_parity(self, solvers):
        """Exact parity with the reference solver trace."""
        s = get_solver(solvers, Settings(
            inequality_handling=InequalityHandling.SLACKED_SLACKS), 2, 1)
        res = s.solve(demo_qp())
        assert bool(res.converged)
        assert int(res.iterations) == 12
        np.testing.assert_allclose(float(res.residual), 1.932123e-10,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(res.gap), 4.940198e-11, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(res.x), [1.2, 0.0], atol=1e-10)
        np.testing.assert_allclose(float(res.objective), -11.28, rtol=1e-9)

    def test_slacks_converges_where_reference_stalls(self, solvers):
        s = get_solver(solvers, Settings(
            inequality_handling=InequalityHandling.SLACKS), 2, 1)
        res = s.solve(demo_qp())
        assert bool(res.converged)
        assert int(res.iterations) <= 10
        np.testing.assert_allclose(np.asarray(res.x), [1.2, 0.0], atol=1e-8)
        np.testing.assert_allclose(float(res.objective), -11.28, rtol=1e-8)

    def test_naive_slacks(self, solvers):
        s = get_solver(solvers, Settings(
            inequality_handling=InequalityHandling.NAIVE_SLACKS), 2, 1)
        res = s.solve(demo_qp())
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), [1.2, 0.0], atol=1e-8)


def random_box_qp(n, seed):
    """Random strictly convex box-constrained QP with known-good data."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T / n + np.eye(n)
    c = rng.normal(size=n)
    l = -np.abs(rng.normal(size=n)) - 1.0
    u = np.abs(rng.normal(size=n)) + 1.0
    return QPData.make(Q=Q, c=c, l_x=l, u_x=u, dtype=jnp.float64)


def scipy_reference(data: QPData):
    from scipy import optimize
    Q = np.asarray(data.Q)
    c = np.asarray(data.c)
    res = optimize.minimize(
        lambda x: 0.5 * x @ Q @ x + c @ x,
        jac=lambda x: Q @ x + c,
        x0=np.zeros(len(c)),
        bounds=list(zip(np.asarray(data.l_x), np.asarray(data.u_x))),
        method="L-BFGS-B", tol=1e-12)
    return res.x, res.fun


class TestRandomQPs:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_box_qp_vs_scipy(self, solvers, seed):
        n = 8
        data = random_box_qp(n, seed)
        s = get_solver(solvers, Settings(
            inequalities=Bounds.NONE,
            inequality_handling=InequalityHandling.SLACKED_SLACKS), n, 0)
        res = s.solve(data)
        assert bool(res.converged)
        x_ref, f_ref = scipy_reference(data)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
        np.testing.assert_allclose(float(res.objective), f_ref, rtol=1e-8)

    def test_equality_constrained(self, solvers):
        # min 1/2 ||x||^2 - x1  s.t.  sum(x) = 1, -5 <= x <= 5.
        # EqualityHandling.NONE keeps a zero diagonal block (indefinite
        # augmented system, rejected at compile time — see
        # TestIndefiniteGuard); the penalty-with-extra-dual handling is the
        # quasi-definite formulation of the same problem and drives the
        # perturbation to zero with mu.
        # Analytic optimum: x = (1, 0, 0, 0), lambda = 0.
        n = 4
        data = QPData.make(
            Q=np.eye(n), c=[-1.0, 0, 0, 0],
            A_eq=np.ones((1, n)), b_eq=[1.0],
            l_x=-5 * np.ones(n), u_x=5 * np.ones(n), dtype=jnp.float64)
        s = get_solver(solvers, Settings(
            inequalities=Bounds.NONE, equalities=True,
            equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL,
            inequality_handling=InequalityHandling.SLACKED_SLACKS), n, 0, 1)
        res = s.solve(data)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 0, 0, 0],
                                   atol=1e-6)

    def test_general_inequality_qp(self, solvers):
        # min 1/2 x^T x  s.t.  x1 + x2 >= 2, 0 <= x <= 10 -> x = (1, 1)
        data = QPData.make(
            Q=np.eye(2), c=[0.0, 0.0],
            A_ineq=[[1.0, 1.0]], l_A_ineq=[2.0], u_A_ineq=[100.0],
            l_x=[0.0, 0.0], u_x=[10.0, 10.0], dtype=jnp.float64)
        s = get_solver(solvers, Settings(
            inequality_handling=InequalityHandling.SLACKED_SLACKS), 2, 1)
        res = s.solve(data)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-7)

    def test_equality_regularization(self, solvers):
        n = 3
        data = QPData.make(
            Q=np.eye(n), c=[-1.0, -2.0, -3.0],
            A_eq=[[1.0, 1.0, 1.0]], b_eq=[1.0],
            l_x=-10 * np.ones(n), u_x=10 * np.ones(n), dtype=jnp.float64)
        s = get_solver(solvers, Settings(
            inequalities=Bounds.NONE, equalities=True,
            equality_handling=EqualityHandling.REGULARIZATION,
            inequality_handling=InequalityHandling.SLACKED_SLACKS), n, 0, 1)
        res = s.solve(data)
        assert bool(res.converged)
        # analytic: x = c_neg + lam; sum(x)=1 -> (1+2+3) + 3 lam = 1
        lam = (1 - 6) / 3
        expected = np.array([1.0, 2.0, 3.0]) + lam
        # regularization perturbs by delta=1e-4 p; tolerance accordingly
        np.testing.assert_allclose(np.asarray(res.x), expected, atol=1e-3)


class TestBatched:
    def test_solve_batch(self, solvers):
        datas = [random_box_qp(6, seed) for seed in range(5)]
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
        s = get_solver(solvers, Settings(
            inequalities=Bounds.NONE,
            inequality_handling=InequalityHandling.SLACKED_SLACKS), 6, 0)
        res = s.solve_batch(batch)
        assert bool(jnp.all(res.converged))
        for i, d in enumerate(datas):
            x_ref, f_ref = scipy_reference(d)
            np.testing.assert_allclose(np.asarray(res.x[i]), x_ref, atol=1e-6)


class TestIndefiniteSystems:
    """Equalities with EqualityHandling.NONE keep a zero diagonal block:
    the augmented system is genuinely indefinite.  The reference hard-fails
    there (Optimizer.cpp:75); we route to signed-regularised LDL^T +
    refinement (batched-device-friendly), with partial-pivoting LU kept as an
    explicit fallback."""

    SETTINGS = Settings(
        inequalities=Bounds.NONE, variable_bounds=Bounds.NONE,
        equalities=True, equality_handling=EqualityHandling.NONE)

    def _eq_qp(self, n):
        # min 1/2||x||^2 - x1 s.t. sum(x) = 1 -> x = (1,0,...,0)
        return QPData.make(
            Q=np.eye(n), c=[-1.0] + [0.0] * (n - 1),
            A_eq=np.ones((1, n)), b_eq=[1.0], dtype=jnp.float64)

    def test_zero_diagonal_raises_for_ldlt(self):
        with pytest.raises(NotImplementedError):
            CompiledIPM(self.SETTINGS, n=3, m_eq=1, kernel="ldlt")

    def test_auto_selects_regldlt(self):
        s = CompiledIPM(self.SETTINGS, n=3, m_eq=1)
        assert s._mode == "regldlt"
        res = s.solve(self._eq_qp(3))
        assert bool(res.converged) and not bool(res.diverged)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 0.0, 0.0],
                                   atol=1e-9)

    def test_lu_solves_equality_qp(self):
        s = CompiledIPM(self.SETTINGS, n=3, m_eq=1, kernel="lu")
        assert s._mode == "lu"
        res = s.solve(self._eq_qp(3))
        assert bool(res.converged) and not bool(res.diverged)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 0.0, 0.0],
                                   atol=1e-9)

    def test_regldlt_matches_lu(self):
        n = 6
        rng = np.random.default_rng(3)
        M = rng.normal(size=(n, n))
        data = QPData.make(
            Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
            A_eq=rng.normal(size=(2, n)), b_eq=rng.normal(size=2),
            dtype=jnp.float64)
        res_reg = CompiledIPM(self.SETTINGS, n=n, m_eq=2).solve(data)
        res_lu = CompiledIPM(self.SETTINGS, n=n, m_eq=2,
                             kernel="lu").solve(data)
        assert bool(res_reg.converged) and bool(res_lu.converged)
        np.testing.assert_allclose(np.asarray(res_reg.x),
                                   np.asarray(res_lu.x),
                                   rtol=1e-8, atol=1e-8)

    def test_batched_indefinite_solves(self):
        # the point of regldlt: vmapped solves ride the batched LDL^T
        # kernels instead of XLA's generic pivoted LU
        n, m, batch = 8, 3, 16
        rng = np.random.default_rng(11)
        M = rng.normal(size=(batch, n, n))
        data = QPData.make(
            Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
            c=rng.normal(size=(batch, n)),
            A_eq=rng.normal(size=(batch, m, n)),
            b_eq=rng.normal(size=(batch, m)), dtype=jnp.float64)
        s = CompiledIPM(self.SETTINGS, n=n, m_eq=m)
        assert s._mode == "regldlt"
        res = s.solve_batch(data)
        assert bool(jnp.all(res.converged))
        # KKT check: Q x + c + A^T lam = 0, A x = b
        x = np.asarray(res.x)
        lam = np.asarray(res.variables["\\lambda_{C}"])
        Q = np.asarray(data.Q)
        r_stat = np.einsum("bij,bj->bi", Q, x) + np.asarray(data.c) + \
            np.einsum("bji,bj->bi", np.asarray(data.A_eq), lam)
        r_eq = np.einsum("bij,bj->bi", np.asarray(data.A_eq), x) - \
            np.asarray(data.b_eq)
        assert np.max(np.abs(r_stat)) < 1e-7
        assert np.max(np.abs(r_eq)) < 1e-7


class TestDivergenceGuard:
    def test_nan_data_flags_diverged(self):
        data = QPData.make(
            Q=[[np.nan, 0.0], [0.0, 1.0]], c=[0.0, 0.0],
            l_x=[-1.0, -1.0], u_x=[1.0, 1.0], dtype=jnp.float64)
        s = CompiledIPM(Settings(inequalities=Bounds.NONE), n=2)
        res = s.solve(data)
        assert bool(res.diverged)
        assert not bool(res.converged)
        # the NaN guard exits the loop early instead of burning max_iter
        assert int(res.iterations) < 5


class TestGondzio:
    def test_gondzio_correctors(self, solvers):
        """Gondzio rounds must preserve the solution and not increase
        iteration count."""
        rng = np.random.default_rng(3)
        n, m = 12, 5
        M = rng.normal(size=(n, n))
        data = QPData.make(
            Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
            A_ineq=rng.normal(size=(m, n)),
            l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
            u_A_ineq=np.abs(rng.normal(size=m)) + 1,
            l_x=-5 * np.ones(n), u_x=5 * np.ones(n), dtype=jnp.float64)
        plain = get_solver(solvers, Settings(), n, m)
        gz = get_solver(solvers, Settings(), n, m, gondzio=2)
        r0, r2 = plain.solve(data), gz.solve(data)
        assert bool(r0.converged) and bool(r2.converged)
        assert int(r2.iterations) <= int(r0.iterations)
        np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r0.x),
                                   atol=1e-7)
