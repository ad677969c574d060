"""Block elimination for 2x2 quasi-definite KKT systems.

The augmented system of most formulations is the 2x2 block structure

    K = [[ H,  B^T],      H (n x n) symmetric positive definite
         [ B,  -C ]]      C (m x m) symmetric positive definite

(H = Q + barrier diagonals, C = condensed slack/dual diagonals).  For
large n the right factorisation is not an element-sequential LDL^T
but two *blocked Cholesky* factorisations plus dense matmuls — all of
which XLA tiles onto the matrix units:

    H = Lh Lh^T                       (n^3/3 FLOPs, blocked)
    T = H^-1 B^T                      (triangular solves)
    S = C + B T                       (one n*m^2 + m*n^2 matmul)
    S = Ls Ls^T                       (m^3/3)

    solve:  y1 = H^-1 r1
            dy = S^-1 (T^T r1 - r2)
            dx = y1 - T dy

This is numerically the same elimination the symbolic layer performs to
reach the normal equations, executed at the block level with dense
kernels.  Used by ``CompiledIPM(kernel="block")`` (and auto-selected for
large problems).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def _cho_solve(L, b):
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L.T, y, lower=False)


def block2_factor(H: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray):
    """Factor K = [[H, B^T], [B, -C]]; returns opaque factors."""
    Lh = jnp.linalg.cholesky(H)
    if B.shape[0]:
        T = _cho_solve(Lh, B.T)               # (n, m)
        S = C + B @ T
        Ls = jnp.linalg.cholesky(S)
    else:
        T = jnp.zeros((H.shape[0], 0), H.dtype)
        Ls = jnp.zeros((0, 0), H.dtype)
    return (Lh, T, Ls)


def block2_solve(factors, r1: jnp.ndarray, r2: jnp.ndarray):
    """Solve K [dx; dy] = [r1; r2] with factors from block2_factor."""
    Lh, T, Ls = factors
    y1 = _cho_solve(Lh, r1)
    if r2.shape[0]:
        dy = _cho_solve(Ls, T.T @ r1 - r2)
        dx = y1 - T @ dy
    else:
        dy = r2
        dx = y1
    return dx, dy


def block2_matvec(H, B, C, x1, x2):
    """K [x1; x2] for the same block structure (iterative refinement)."""
    if B.shape[0]:
        return H @ x1 + B.T @ x2, B @ x1 - C @ x2
    return H @ x1, x2


def block2_factor_inv(H: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray):
    """Like :func:`block2_factor` but binds EXPLICIT inverses.

    A Mehrotra iteration issues 4+ direction solves against one
    factorisation (affine, corrector, Gondzio rounds); each 1-rhs
    TriangularSolve is latency-bound while an n-rhs solve runs at
    matmul throughput.  Paying one n-rhs solve pair up front to bind
    H^{-1} (and S^{-1}) turns every later direction into two matvecs.  Same elimination, same answer to roundoff."""
    n = H.shape[0]
    Lh = jnp.linalg.cholesky(H)
    eye_n = jnp.eye(n, dtype=H.dtype)
    Hinv = _cho_solve(Lh, eye_n)
    if B.shape[0]:
        T = Hinv @ B.T                        # H^-1 B^T  (n, m)
        S = C + B @ T
        Ls = jnp.linalg.cholesky(S)
        Sinv = _cho_solve(Ls, jnp.eye(S.shape[0], dtype=H.dtype))
    else:
        T = jnp.zeros((n, 0), H.dtype)
        Sinv = jnp.zeros((0, 0), H.dtype)
    return (Hinv, T, Sinv)


def block2_solve_inv(factors, r1: jnp.ndarray, r2: jnp.ndarray):
    """Solve with factors from :func:`block2_factor_inv` — matvecs only."""
    Hinv, T, Sinv = factors
    y1 = Hinv @ r1
    if r2.shape[0]:
        dy = Sinv @ (T.T @ r1 - r2)
        dx = y1 - T @ dy
    else:
        dy = r2
        dx = y1
    return dx, dy
