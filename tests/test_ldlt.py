"""LDL^T kernel correctness: reconstruction, solves, batching, pivot floor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.ops import (batched_ldlt, batched_solve_ldlt, cholesky_solve,
                            ldlt, ldlt_solve, solve_ldlt)


def quasidefinite(n1, n2, seed):
    """Random symmetric quasi-definite [[H, A^T], [A, -S]] matrix."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n1, n1))
    H = H @ H.T + n1 * np.eye(n1)
    S = rng.normal(size=(n2, n2))
    S = S @ S.T + n2 * np.eye(n2)
    A = rng.normal(size=(n2, n1))
    return np.block([[H, A.T], [A, -S]])


@pytest.mark.parametrize("n1,n2", [(3, 2), (10, 7), (32, 16)])
def test_reconstruction(n1, n2):
    A = jnp.asarray(quasidefinite(n1, n2, seed=n1))
    L, D = ldlt(A)
    recon = L @ jnp.diag(D) @ L.T
    np.testing.assert_allclose(np.asarray(recon), np.asarray(A),
                               rtol=1e-9, atol=1e-9)
    # unit lower-triangular
    np.testing.assert_allclose(np.asarray(jnp.diagonal(L)), 1.0)
    assert np.allclose(np.asarray(jnp.triu(L, 1)), 0.0)


@pytest.mark.parametrize("n1,n2", [(5, 3), (20, 11)])
def test_solve(n1, n2):
    n = n1 + n2
    A = jnp.asarray(quasidefinite(n1, n2, seed=7 * n))
    b = jnp.asarray(np.random.default_rng(1).normal(size=n))
    x = ldlt_solve(A, b)
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b),
                               rtol=1e-8, atol=1e-8)


def test_multiple_rhs_reuse_factors():
    A = jnp.asarray(quasidefinite(8, 4, seed=3))
    L, D = ldlt(A)
    for seed in range(3):
        b = jnp.asarray(np.random.default_rng(seed).normal(size=12))
        x = solve_ldlt(L, D, b)
        np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b),
                                   rtol=1e-8, atol=1e-8)


def test_zero_pivot_floor():
    # A singular matrix: the zero pivot is floored, not NaN
    A = jnp.zeros((3, 3), jnp.float64)
    L, D = ldlt(A)
    assert np.all(np.isfinite(np.asarray(L)))
    assert np.all(np.asarray(D) == 1e-8)


def test_empty():
    A = jnp.zeros((0, 0), jnp.float64)
    L, D = ldlt(A)
    assert L.shape == (0, 0) and D.shape == (0,)
    b = jnp.zeros((0,))
    assert solve_ldlt(L, D, b).shape == (0,)


def test_batched():
    mats = np.stack([quasidefinite(6, 3, seed=s) for s in range(4)])
    A = jnp.asarray(mats)
    L, D = batched_ldlt(A, 1e-8)
    b = jnp.asarray(np.random.default_rng(0).normal(size=(4, 9)))
    x = batched_solve_ldlt(L, D, b)
    np.testing.assert_allclose(np.asarray(jnp.einsum("bij,bj->bi", A, x)),
                               np.asarray(b), rtol=1e-8, atol=1e-8)


def test_cholesky_solve_spd():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(12, 12))
    A = jnp.asarray(M @ M.T + 12 * np.eye(12))
    b = jnp.asarray(rng.normal(size=12))
    x = cholesky_solve(A, b)
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b),
                               rtol=1e-8, atol=1e-8)


def test_jit_and_grad_compatible():
    A = jnp.asarray(quasidefinite(4, 2, seed=9))
    b = jnp.ones(6)
    f = jax.jit(lambda A, b: jnp.sum(ldlt_solve(A, b) ** 2))
    v = f(A, b)
    assert np.isfinite(float(v))
