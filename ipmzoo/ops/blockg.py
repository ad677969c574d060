"""Signed block-Cholesky factorisation over the symbolic group structure.

The augmented KKT system of a quasi-definite formulation is a G x G
block matrix whose diagonal blocks have *structurally known* signs: the
cell of a primal variable group (x, slacks, regularisation p) is
positive definite (Q/delta/barrier diagonals), the cell of a dual
(lambda) group is negative definite.  Vanderbei (1995) — the same result
behind the reference's pivot-floor LDL^T
(/root/reference/src/NumericalOptimization/LinearSolvers.cpp:26-28) —
guarantees a quasi-definite matrix factors as

    K = Lt Sigma Lt^T,   Sigma = diag(sigma_i I_{s_i}),  sigma_i = +-1

for ANY symmetric ordering, with block-lower-triangular Lt whose
diagonal blocks are ordinary Cholesky factors.  Eliminating *groups*
instead of scalar columns turns the factorisation into G stages of
XLA-native blocked Cholesky + triangular solves + one trailing-update
matmul per remaining pair — sequential depth G (2-6 in practice) instead
of n, with all O(n^3) work in matrix products.

This generalises ``ops/block_solve.py`` (its 2x2 Cholesky+Schur path is
the G=2, signs (+,-) case) to every quasi-definite augmented structure
the formulation lattice produces (e.g. SlackedSlacks equality handling,
which keeps 3+ variable groups after reduction).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def blockg_factor(blocks, signs):
    """Factor K = Lt Sigma Lt^T for a G x G block matrix.

    blocks: nested list, blocks[i][j] = (s_i, s_j) dense cell of K
    (full matrix, both triangles supplied).
    signs: length-G sequence of +-1.0 — the definiteness sign of each
    (updated) diagonal block; structurally known from the formulation.

    Returns opaque factors for :func:`blockg_solve`.
    """
    G = len(signs)
    work = [[blocks[i][j] for j in range(i + 1)] for i in range(G)]
    Ld = [None] * G                     # diagonal Cholesky factors
    Lt = [[None] * G for _ in range(G)]  # strictly-lower blocks

    for i in range(G):
        si = work[i][i].shape[0]
        Kii = signs[i] * work[i][i]
        Li = jnp.linalg.cholesky(Kii) if si else work[i][i]
        Ld[i] = Li
        # T_j = Li^{-1} K'[j][i]^T = sigma_i Lt[j][i]^T
        Ts = {}
        for j in range(i + 1, G):
            sj = work[j][i].shape[0]
            if si == 0 or sj == 0:
                Lt[j][i] = jnp.zeros((sj, si), work[j][i].dtype)
                Ts[j] = jnp.zeros((si, sj), work[j][i].dtype)
                continue
            T = solve_triangular(Li, work[j][i].T, lower=True)
            Ts[j] = T
            Lt[j][i] = signs[i] * T.T
        # trailing update: K'[j][l] -= sigma_i T_j^T T_l   (j >= l > i)
        for j in range(i + 1, G):
            for l in range(i + 1, j + 1):
                if work[j][l].shape[0] and work[j][l].shape[1] and si:
                    work[j][l] = work[j][l] - signs[i] * (Ts[j].T @ Ts[l])
    sizes = [blocks[i][i].shape[0] for i in range(G)]
    return (Ld, Lt, tuple(signs), tuple(sizes))


def blockg_solve(factors, b):
    """Solve K x = b with factors from :func:`blockg_factor`.

    b: (sum s_i,) packed right-hand side in group order."""
    Ld, Lt, signs, sizes = factors
    G = len(signs)
    offs = []
    off = 0
    for s in sizes:
        offs.append(off)
        off += s
    parts = [b[offs[i]:offs[i] + sizes[i]] for i in range(G)]

    # forward: Lt y = b
    y = [None] * G
    for i in range(G):
        if sizes[i] == 0:
            y[i] = parts[i]
            continue
        rhs = parts[i]
        for k in range(i):
            if sizes[k]:
                rhs = rhs - Lt[i][k] @ y[k]
        y[i] = solve_triangular(Ld[i], rhs, lower=True)
    # scale: z = Sigma y
    z = [signs[i] * y[i] for i in range(G)]
    # backward: Lt^T x = z
    x = [None] * G
    for i in reversed(range(G)):
        if sizes[i] == 0:
            x[i] = z[i]
            continue
        rhs = z[i]
        for k in range(i + 1, G):
            if sizes[k]:
                rhs = rhs - Lt[k][i].T @ x[k]
        x[i] = solve_triangular(Ld[i].T, rhs, lower=False)
    return jnp.concatenate(x) if x else b


def blockg_matvec(blocks, x_parts):
    """K x for the same block structure (iterative refinement)."""
    G = len(blocks)
    out = []
    for i in range(G):
        acc = None
        for j in range(G):
            cell = blocks[i][j] if j <= i else blocks[j][i].T
            if cell.shape[0] == 0 or cell.shape[1] == 0:
                continue
            t = cell @ x_parts[j]
            acc = t if acc is None else acc + t
        out.append(acc if acc is not None else
                   jnp.zeros((blocks[i][i].shape[0],), x_parts[0].dtype))
    return out
