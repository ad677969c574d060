"""Numerical solver coverage across the formulation lattice.

Beyond symbolic parity (test_newton_parity covers all 384 points), this
exercises the *numerical* path for a representative slice of solvable
formulations on one QP with a known optimum, checking every handling
combination converges to the same solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo.models import CompiledIPM, QPData

# min 1/2 x^T Q x + c^T x s.t. 0.5 <= x1 + 2 x2 <= 3, sum(x) = 2,
# -4 <= x <= 4; verified optimum via scipy SLSQP below.
Q = np.array([[2.0, 0.5], [0.5, 1.0]])
C = np.array([-1.0, -2.0])


def data(with_eq: bool):
    return QPData.make(
        Q=Q, c=C,
        A_ineq=[[1.0, 2.0]], l_A_ineq=[0.5], u_A_ineq=[3.0],
        A_eq=np.ones((1, 2)) if with_eq else None,
        b_eq=[2.0] if with_eq else None,
        l_x=[-4.0, -4.0], u_x=[4.0, 4.0], dtype=jnp.float64)


def scipy_opt(with_eq: bool):
    from scipy import optimize
    cons = [optimize.LinearConstraint([[1.0, 2.0]], [0.5], [3.0])]
    if with_eq:
        cons.append(optimize.LinearConstraint([[1.0, 1.0]], [2.0], [2.0]))
    res = optimize.minimize(
        lambda x: 0.5 * x @ Q @ x + C @ x,
        jac=lambda x: Q @ x + C, x0=np.zeros(2),
        bounds=optimize.Bounds([-4, -4], [4, 4]),
        constraints=cons, method="SLSQP",
        options={"ftol": 1e-14, "maxiter": 300})
    assert res.success
    return res.x


X_INEQ = scipy_opt(False)
X_EQ = scipy_opt(True)


@pytest.mark.parametrize("ih", list(InequalityHandling))
@pytest.mark.parametrize("bounds", [Bounds.BOTH, Bounds.LOWER, Bounds.UPPER])
def test_inequality_formulations(ih, bounds):
    settings = Settings(inequalities=bounds, inequality_handling=ih)
    solver = CompiledIPM(settings, n=2, m_ineq=1)
    res = solver.solve(data(False))
    assert bool(res.converged), (ih, bounds)
    if bounds == Bounds.BOTH:
        np.testing.assert_allclose(np.asarray(res.x), X_INEQ, atol=1e-6)


@pytest.mark.parametrize("eh", [
    EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL,
    EqualityHandling.PENALTY_FUNCTION,
    EqualityHandling.REGULARIZATION,
])
def test_equality_handlings(eh):
    settings = Settings(equalities=True, equality_handling=eh,
                        inequality_handling=InequalityHandling.SLACKED_SLACKS)
    solver = CompiledIPM(settings, n=2, m_ineq=1, m_eq=1)
    res = solver.solve(data(True))
    assert bool(res.converged), eh
    atol = 1e-3 if eh == EqualityHandling.REGULARIZATION else 1e-5
    np.testing.assert_allclose(np.asarray(res.x), X_EQ, atol=atol)


def test_naive_slacks_with_equalities():
    settings = Settings(
        equalities=True,
        equality_handling=EqualityHandling.NAIVE_SLACKS,
        inequality_handling=InequalityHandling.NAIVE_SLACKS)
    solver = CompiledIPM(settings, n=2, m_ineq=1, m_eq=1)
    res = solver.solve(data(True))
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), X_EQ, atol=1e-5)
