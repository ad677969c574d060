"""Structured MPC (Riccati) solver tests.

Covers: the Riccati factor/solve pair against a dense materialisation of
the same block-tridiagonal KKT matrix, IPM convergence to the reference
tolerances, exact parity with the generic dense solver on the condensed
equivalent QP, vmap batching, and warm starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.models.mpc import (MPCData, RiccatiIPM, condense,
                                   random_mpc)
from ipmzoo.ops.riccati import (riccati_factor, riccati_kkt_dense,
                                    riccati_solve)


def _rand_lqr(T, ns, nu, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(T, ns, ns))
    Qt = np.einsum("kij,klj->kil", M, M) / ns + np.eye(ns)
    Mr = rng.normal(size=(T, nu, nu))
    Rt = np.einsum("kij,klj->kil", Mr, Mr) / nu + np.eye(nu)
    A = 0.5 * rng.normal(size=(T, ns, ns))
    B = rng.normal(size=(T, ns, nu))
    rx = rng.normal(size=(T, ns))
    ru = rng.normal(size=(T, nu))
    d = rng.normal(size=(T, ns))
    return tuple(jnp.asarray(a) for a in (Qt, Rt, A, B, rx, ru, d))


class TestRiccatiKernel:
    def test_matches_dense_kkt_solve(self):
        T, ns, nu = 7, 3, 2
        Qt, Rt, A, B, rx, ru, d = _rand_lqr(T, ns, nu)
        factors = riccati_factor(Qt, Rt, A, B)
        dx, du, dy = riccati_solve(factors, A, B, rx, ru, d)

        K = np.asarray(riccati_kkt_dense(Qt, Rt, A, B))
        rhs = np.concatenate([-np.asarray(rx).ravel(),
                              -np.asarray(ru).ravel(),
                              np.asarray(d).ravel()])
        sol = np.linalg.solve(K, rhs)
        nx = T * ns
        np.testing.assert_allclose(np.asarray(dx).ravel(), sol[:nx],
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(du).ravel(),
                                   sol[nx:nx + T * nu], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(dy).ravel(),
                                   sol[nx + T * nu:], rtol=1e-9, atol=1e-9)

    def test_horizon_one(self):
        Qt, Rt, A, B, rx, ru, d = _rand_lqr(1, 2, 1, seed=3)
        factors = riccati_factor(Qt, Rt, A, B)
        dx, du, dy = riccati_solve(factors, A, B, rx, ru, d)
        K = np.asarray(riccati_kkt_dense(Qt, Rt, A, B))
        rhs = np.concatenate([-np.asarray(rx).ravel(),
                              -np.asarray(ru).ravel(),
                              np.asarray(d).ravel()])
        sol = np.linalg.solve(K, rhs)
        got = np.concatenate([np.asarray(dx).ravel(),
                              np.asarray(du).ravel(),
                              np.asarray(dy).ravel()])
        np.testing.assert_allclose(got, sol, rtol=1e-9, atol=1e-9)

    def test_vmappable(self):
        T, ns, nu = 4, 2, 2
        batches = [_rand_lqr(T, ns, nu, seed=s) for s in range(3)]
        stacked = tuple(jnp.stack([b[i] for b in batches])
                        for i in range(7))

        def solve_one(Qt, Rt, A, B, rx, ru, d):
            f = riccati_factor(Qt, Rt, A, B)
            return riccati_solve(f, A, B, rx, ru, d)

        bdx, bdu, bdy = jax.vmap(solve_one)(*stacked)
        for i, b in enumerate(batches):
            dx, du, dy = solve_one(*b)
            np.testing.assert_allclose(np.asarray(bdx[i]), np.asarray(dx),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(np.asarray(bdu[i]), np.asarray(du),
                                       rtol=1e-12, atol=1e-12)


class TestRiccatiIPM:
    def test_converges_control_bounds(self):
        data = random_mpc(horizon=12, n_states=4, n_controls=2, seed=1)
        solver = RiccatiIPM(12, 4, 2)
        res = solver.solve(data)
        assert bool(res.converged)
        assert float(res.gap) < 1e-8
        assert float(res.residual) < 1e-8
        # primal feasibility of the returned trajectories
        u = np.asarray(res.u)
        assert (u >= np.asarray(data.l_u) - 1e-9).all()
        assert (u <= np.asarray(data.u_u) + 1e-9).all()
        x = np.asarray(res.x)
        A, B, c = map(np.asarray, (data.A, data.B, data.c))
        xprev = np.concatenate([np.asarray(data.x0)[None], x[:-1]])
        dyn = x - np.einsum("kij,kj->ki", A, xprev) - \
            np.einsum("kiu,ku->ki", B, u) - c
        assert np.abs(dyn).max() < 1e-8

    def test_converges_state_bounds(self):
        data = random_mpc(horizon=8, n_states=3, n_controls=2, seed=2,
                          state_bounds=True)
        solver = RiccatiIPM(8, 3, 2, state_bounds=True)
        res = solver.solve(data)
        assert bool(res.converged)
        x = np.asarray(res.x)
        assert (x >= np.asarray(data.l_x) - 1e-8).all()
        assert (x <= np.asarray(data.u_x) + 1e-8).all()

    def test_matches_condensed_dense_solver(self):
        """Same QP through the structured path and through state
        elimination + the generic dense IPM must agree."""
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM

        T, ns, nu = 5, 3, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=4,
                          state_bounds=True)
        solver = RiccatiIPM(T, ns, nu, state_bounds=True)
        res = solver.solve(data)
        assert bool(res.converged)

        qp, S, free = condense(data)
        dense = CompiledIPM(Settings(), n=T * nu, m_ineq=T * ns)
        dres = dense.solve(qp)
        assert bool(dres.converged)

        np.testing.assert_allclose(np.asarray(res.u).ravel(),
                                   np.asarray(dres.x), rtol=1e-6,
                                   atol=1e-6)
        # objectives differ by the constant from the eliminated states
        Qbar = np.zeros((T * ns, T * ns))
        Q = np.asarray(data.Q)
        for k in range(T):
            Qbar[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = Q[k]
        const = 0.5 * free @ Qbar @ free + np.asarray(data.q).ravel() @ free
        np.testing.assert_allclose(float(res.objective),
                                   float(dres.objective) + const,
                                   rtol=1e-6, atol=1e-6)

    def test_batch_vmap_matches_loop(self):
        T, ns, nu = 6, 3, 2
        bdata = random_mpc(horizon=T, n_states=ns, n_controls=nu, batch=4,
                           seed=5)
        solver = RiccatiIPM(T, ns, nu)
        bres = solver.solve_batch(bdata)
        assert bool(bres.converged.all())
        for i in range(4):
            one = jax.tree_util.tree_map(lambda a: a[i], bdata)
            res = solver.solve(one)
            np.testing.assert_allclose(np.asarray(bres.u[i]),
                                       np.asarray(res.u), rtol=1e-7,
                                       atol=1e-9)

    def test_warm_start_reduces_iterations(self):
        T, ns, nu = 10, 4, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=6)
        solver = RiccatiIPM(T, ns, nu)
        res = solver.solve(data)
        assert bool(res.converged)
        # perturbed instance, warm-started from the previous solution
        data2 = MPCData(
            A=data.A, B=data.B, c=data.c,
            x0=data.x0 + 0.01, Q=data.Q, q=data.q, R=data.R,
            r=data.r, l_u=data.l_u, u_u=data.u_u, l_x=data.l_x,
            u_x=data.u_x)
        cold = solver.solve(data2)
        warm = solver.solve(data2, warm_start=res.variables)
        assert bool(warm.converged)
        assert int(warm.iterations) <= int(cold.iterations)

    def test_gondzio_converges_and_matches(self):
        T, ns, nu = 10, 3, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=9)
        plain = RiccatiIPM(T, ns, nu).solve(data)
        gz = RiccatiIPM(T, ns, nu, gondzio=2).solve(data)
        assert bool(plain.converged) and bool(gz.converged)
        assert int(gz.iterations) <= int(plain.iterations)
        np.testing.assert_allclose(np.asarray(gz.u), np.asarray(plain.u),
                                   rtol=1e-6, atol=1e-7)

    def test_result_is_optimal_vs_perturbations(self):
        """Objective at the solution beats feasible perturbed controls."""
        T, ns, nu = 6, 2, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=7)
        solver = RiccatiIPM(T, ns, nu)
        res = solver.solve(data)
        assert bool(res.converged)
        A, B, c = map(np.asarray, (data.A, data.B, data.c))
        Q, q = np.asarray(data.Q), np.asarray(data.q)
        R, r = np.asarray(data.R), np.asarray(data.r)

        def obj(u):
            x, xs = np.asarray(data.x0), []
            for k in range(T):
                x = A[k] @ x + B[k] @ u[k] + c[k]
                xs.append(x)
            xs = np.stack(xs)
            return (0.5 * np.einsum("ki,kij,kj->", xs, Q, xs)
                    + np.einsum("ki,ki->", q, xs)
                    + 0.5 * np.einsum("ki,kij,kj->", u, R, u)
                    + np.einsum("ki,ki->", r, u))

        u_star = np.asarray(res.u)
        f_star = obj(u_star)
        rng = np.random.default_rng(0)
        for _ in range(5):
            pert = 1e-3 * rng.normal(size=u_star.shape)
            u_p = np.clip(u_star + pert, np.asarray(data.l_u),
                          np.asarray(data.u_u))
            assert obj(u_p) >= f_star - 1e-9
