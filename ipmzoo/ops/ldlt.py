"""Dense LDL^T factorisation and solves, jit/vmap-compatible.

The augmented KKT system of an interior-point iteration is symmetric
quasi-definite, so an unpivoted LDL^T with a zero-pivot floor is stable
(Vanderbei 1995; the reference uses the same regularisation with floor
1e-8, /root/reference/src/NumericalOptimization/LinearSolvers.cpp:26-28).

Two factorisation paths:

* :func:`ldlt` — column-by-column ``lax.fori_loop``; the body is rank-1
  vectorised (one matvec per column).
  Works for any n, vmaps cleanly over batches.
* :func:`solve_ldlt` — two XLA ``TriangularSolve`` ops plus a diagonal
  scale, reusing the factors for multiple right-hand sides (the
  predictor and corrector share one factorisation per iteration).

``jax.scipy`` LU is deliberately not used on the hot path: LDL^T halves
the FLOPs, needs no pivot data movement, and its zero-pivot floor is the
behavioural anchor of the framework.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

PIVOT_FLOOR = 1e-8


def ldlt(A: jnp.ndarray, pivot_floor: float = PIVOT_FLOOR):
    """Factor symmetric A = L D L^T (unit lower L, diagonal D).

    Zero pivots are replaced by ``pivot_floor`` (quasi-definite
    regularisation). Returns (L, D) with L unit-lower-triangular dense and
    D a vector.
    """
    n = A.shape[-1]
    dtype = A.dtype
    if n == 0:
        return jnp.zeros((0, 0), dtype), jnp.zeros((0,), dtype)

    idx = jnp.arange(n)

    def body(j, carry):
        L, D = carry
        mask = (idx < j).astype(dtype)            # columns k < j
        lj = L[j, :] * mask                        # L[j, k<j]
        w = lj * D                                 # L[j,k] D[k]
        s = L @ w                                  # s_i = sum_k L[i,k] L[j,k] D[k]
        d = A[j, j] - jnp.dot(lj, w)
        d = jnp.where(d == 0, jnp.asarray(pivot_floor, dtype), d)
        col = (A[:, j] - s) / d
        col = jnp.where(idx > j, col, 0.0)
        L = L.at[:, j].set(col).at[j, j].set(1.0)
        D = D.at[j].set(d)
        return L, D

    L0 = jnp.zeros((n, n), dtype)
    D0 = jnp.zeros((n,), dtype)
    L, D = jax.lax.fori_loop(0, n, body, (L0, D0))
    return L, D


def solve_ldlt(L: jnp.ndarray, D: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L D L^T x = b using an existing factorisation."""
    if b.shape[-1] == 0:
        return b
    y = solve_triangular(L, b, lower=True, unit_diagonal=True)
    z = y / D
    return solve_triangular(L.T, z, lower=False, unit_diagonal=True)


def ldlt_solve(A: jnp.ndarray, b: jnp.ndarray,
               pivot_floor: float = PIVOT_FLOOR) -> jnp.ndarray:
    L, D = ldlt(A, pivot_floor)
    return solve_ldlt(L, D, b)


# Batched variants (leading batch axis). Used by the batched QP solver and
# by the Pallas kernels' reference implementations in tests.
batched_ldlt = jax.vmap(ldlt, in_axes=(0, None))
batched_solve_ldlt = jax.vmap(solve_ldlt)


def cholesky_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SPD solve via XLA's blocked Cholesky (used for normal-equations
    reductions whose condensed block is positive definite)."""
    L = jnp.linalg.cholesky(A)
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L.T, y, lower=False)
