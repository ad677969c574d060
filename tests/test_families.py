"""QP model families: every generator produces solvable, sane instances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.models import CompiledIPM
from ipmzoo.models.families import (FAMILIES, mpc, portfolio,
                                        projection, svm_dual)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_single_instance_solves(name):
    fam = FAMILIES[name](seed=1, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, m_ineq=fam.m_ineq,
                         m_eq=fam.m_eq, dtype=jnp.float64, tol=1e-8)
    res = solver.solve(fam.data)
    assert bool(res.converged), name
    assert not bool(res.diverged)


def test_portfolio_constraints_hold():
    fam = portfolio(n_assets=16, seed=2, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, m_eq=1, dtype=jnp.float64)
    res = solver.solve(fam.data)
    w = np.asarray(res.x)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)
    assert (w >= -1e-8).all() and (w <= 0.2 + 1e-7).all()


def test_mpc_rate_limits_hold():
    fam = mpc(horizon=5, seed=3, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, m_ineq=fam.m_ineq,
                         dtype=jnp.float64)
    res = solver.solve(fam.data)
    u = np.asarray(res.x)
    du = np.asarray(fam.data.A_ineq) @ u
    assert (np.abs(u) <= 1.0 + 1e-7).all()
    assert (du <= 0.5 + 1e-7).all() and (du >= -0.5 - 1e-7).all()


def test_svm_dual_box():
    fam = svm_dual(n_samples=24, seed=4, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, dtype=jnp.float64)
    res = solver.solve(fam.data)
    a = np.asarray(res.x)
    assert (a >= -1e-8).all() and (a <= 1.0 + 1e-7).all()


def test_projection_matches_scipy():
    from scipy import optimize
    fam = projection(n=10, m=4, seed=5, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, m_ineq=fam.m_ineq,
                         dtype=jnp.float64)
    res = solver.solve(fam.data)
    d = fam.data
    cons = optimize.LinearConstraint(np.asarray(d.A_ineq),
                                     np.asarray(d.l_A_ineq),
                                     np.asarray(d.u_A_ineq))
    p = -np.asarray(d.c)
    out = optimize.minimize(
        lambda x: 0.5 * x @ x - p @ x, np.zeros(fam.n),
        jac=lambda x: x - p,
        bounds=optimize.Bounds(np.asarray(d.l_x), np.asarray(d.u_x)),
        constraints=[cons], method="SLSQP",
        options={"ftol": 1e-14, "maxiter": 500})
    assert out.success
    np.testing.assert_allclose(np.asarray(res.x), out.x, atol=1e-6)


def test_batched_family_solve():
    fam = svm_dual(n_samples=12, batch=6, seed=6, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, dtype=jnp.float64)
    res = solver.solve_batch(fam.data)
    assert bool(jnp.all(res.converged))
    assert res.x.shape == (6, 12)


def test_elastic_net_matches_sklearn_like_oracle():
    """The split-QP solution reconstructs the elastic-net coefficients:
    verify the KKT subgradient conditions of the original problem."""
    from ipmzoo.models.families import elastic_net
    fam = elastic_net(n_features=8, n_samples=32, lam1=0.2, lam2=0.1,
                      seed=6, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, dtype=jnp.float64)
    res = solver.solve(fam.data)
    assert bool(res.converged)
    uv = np.asarray(res.x)
    nf = fam.n // 2
    w = uv[:nf] - uv[nf:]
    # rebuild A, y from the generator for the subgradient check
    rng = np.random.default_rng(6)
    A = rng.normal(size=(32, 8))
    w_true = rng.normal(size=8) * (rng.uniform(size=8) < 0.3)
    y = A @ w_true + 0.01 * rng.normal(size=32)
    g = A.T @ (A @ w - y) + 0.1 * w      # smooth part gradient
    # subgradient optimality: |g| <= lam1, equality where w != 0
    assert (np.abs(g) <= 0.2 + 1e-6).all()
    # strictly-active components (w bounded away from the kink)
    active = np.abs(w) > 1e-4
    np.testing.assert_allclose(g[active], -0.2 * np.sign(w[active]),
                               atol=1e-6)


def test_equality_qp_uses_regldlt_and_satisfies_constraints():
    from ipmzoo.models.families import equality_qp
    fam = equality_qp(n=12, m_eq=3, seed=7, dtype=jnp.float64)
    solver = CompiledIPM(fam.settings, n=fam.n, m_eq=fam.m_eq,
                         dtype=jnp.float64)
    assert solver._mode == "regldlt"
    res = solver.solve(fam.data)
    assert bool(res.converged)
    viol = np.asarray(fam.data.A_eq) @ np.asarray(res.x) - \
        np.asarray(fam.data.b_eq)
    assert np.max(np.abs(viol)) < 1e-8


def test_arrow_chain_detector_and_structured_solver():
    from ipmzoo.models import ArrowIPM, ArrowQPData
    from ipmzoo.models.families import arrow_chain
    fam = arrow_chain(n=60, bandwidth=4, tip=4, seed=8,
                      dtype=jnp.float64)
    sdata, st, blk = ArrowQPData.from_dense(
        np.asarray(fam.data.Q), np.asarray(fam.data.c),
        np.asarray(fam.data.l_x), np.asarray(fam.data.u_x))
    assert st.bandwidth == 4 and st.tip == 4
    ares = ArrowIPM.for_data(sdata, structure=st).solve(sdata)
    dres = CompiledIPM(fam.settings, n=fam.n,
                       dtype=jnp.float64).solve(fam.data)
    assert bool(ares.converged) and bool(dres.converged)
    np.testing.assert_allclose(np.asarray(ares.x), np.asarray(dres.x),
                               atol=1e-7)
