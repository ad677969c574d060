"""Panel-blocked LDL^T: matmul trailing updates for large single systems.

The unblocked :func:`ipmzoo.ops.ldlt.ldlt` processes one column per
``fori_loop`` step — n sequential rank-1-sized steps whose matvecs leave
the matrix units idle.  For a single large quasi-definite KKT matrix
the right shape is a *right-looking panel factorisation*: factor a (p x p)
diagonal panel sequentially (cheap), form the panel's block column with
one triangular solve, and apply the trailing update

    A22 <- A22 - L21 D1 L21^T

as a dense matmul XLA tiles onto the matrix units.  Sequential work drops from n
columns to n/p panels; the O(n^3) bulk runs at matmul throughput.

In exact arithmetic this computes the SAME factor as the unblocked
kernel — including the zero-pivot floor decisions (a column's pivot sees
the fully updated leading entries in both orderings; the floor semantics
follow the reference, /root/reference/src/NumericalOptimization/
LinearSolvers.cpp:26-28) — so it is a drop-in replacement wherever the
augmented system is quasi-definite but has more than the 2x2 block
structure `ops/block_solve.py` handles (e.g. SlackedSlacks equality
handling, whose augmented system keeps 3+ variable groups).

``n`` is static under jit, so the panel loop is a Python loop at trace
time: XLA sees a short chain of static-shape triangular solves and
matmuls (n/p stages), no dynamic shapes anywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .ldlt import PIVOT_FLOOR, ldlt

DEFAULT_PANEL = 128


def ldlt_blocked(A: jnp.ndarray, pivot_floor: float = PIVOT_FLOOR,
                 panel: int = DEFAULT_PANEL):
    """Factor symmetric A = L D L^T (unit lower L, D a vector) with
    panel-blocked trailing updates.  Matches :func:`ops.ldlt.ldlt`."""
    n = A.shape[-1]
    dtype = A.dtype
    if n == 0:
        return jnp.zeros((0, 0), dtype), jnp.zeros((0,), dtype)
    if n <= panel:
        return ldlt(A, pivot_floor)

    L = jnp.zeros((n, n), dtype)
    D = jnp.zeros((n,), dtype)
    for j in range(0, n, panel):
        p = min(panel, n - j)
        Ljj, Dj = ldlt(A[j:j + p, j:j + p], pivot_floor)
        L = L.at[j:j + p, j:j + p].set(Ljj)
        D = D.at[j:j + p].set(Dj)
        if j + p < n:
            # A21 = L21 D1 L11^T  =>  L21^T = D1^{-1} L11^{-1} A21^T
            T = solve_triangular(Ljj, A[j:j + p, j + p:], lower=True,
                                 unit_diagonal=True)
            L21 = (T / Dj[:, None]).T
            L = L.at[j + p:, j:j + p].set(L21)
            # trailing update A22 -= L21 D1 L21^T = L21 @ T (T = D1 L21^T)
            A = A.at[j + p:, j + p:].add(-(L21 @ T))
    return L, D
