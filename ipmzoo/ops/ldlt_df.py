"""Two-float (double-single) LDL^T factorisation and solves.

The pinned f32 convergence floor of the IPM is set by the working-
precision FACTORISATION (tests/test_precision_floor.py): once the
barrier brings cond(K) near 1/eps_f32, an f32 LDL^T no longer produces
descent directions, and neither compensated residuals nor iterative
refinement can recover them (refinement diverges when
cond(K) * eps_factor > 1).  This module factors the augmented KKT
system in *double-single* arithmetic — every matrix/vector value is an
unevaluated (hi, lo) pair of f32 words (:mod:`ipmzoo.ops.twofloat`),
giving an effective unit roundoff of ~2^-48 from pure f32
arithmetic — so the factorisation stays descent-producing down to the
reference's 1e-8 tolerance (/root/reference/src/NumericalOptimization/
Optimizer.cpp:124,133).

Algorithm parity: the same unpivoted column LDL^T with the Vanderbei
zero-pivot floor as :func:`ipmzoo.ops.ldlt.ldlt` (reference
/root/reference/src/NumericalOptimization/LinearSolvers.cpp:14-42,
floor comment :26-28), with every multiply/accumulate replaced by
error-free-transformation pair ops.  All ops are elementwise/reduction
jnp — jit/vmap-compatible, no Pallas needed (the pair arithmetic is
elementwise work; the target systems are the small-to-medium augmented KKTs
where accuracy, not throughput, is the binding constraint).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ldlt import PIVOT_FLOOR
from .twofloat import df_add, df_div, df_mul, df_neg, df_sum


def split_f64(x, dtype=jnp.float32):
    """Split a float64 array into an exact (hi, lo) working-dtype pair
    (test/CPU utility; on-device pairs are produced by the compensated
    pipeline itself)."""
    import numpy as np
    x = np.asarray(x, np.float64)
    hi = x.astype(dtype)
    lo = (x - hi.astype(np.float64)).astype(dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def ldlt_df(Ah, Al, pivot_floor: float = PIVOT_FLOOR):
    """Factor the symmetric pair (Ah, Al) = L D L^T in double-single.

    Returns (Lh, Ll, Dh, Dl): unit-lower L and diagonal D, each as an
    (hi, lo) pair.  Zero pivots (exact zero in the high word with a
    zero low word) get the quasi-definite floor, matching the f32/f64
    kernels' semantics."""
    n = Ah.shape[-1]
    dtype = Ah.dtype
    if n == 0:
        z2 = jnp.zeros((0, 0), dtype)
        z1 = jnp.zeros((0,), dtype)
        return z2, z2, z1, z1

    idx = jnp.arange(n)

    def body(j, carry):
        Lh, Ll, Dh, Dl = carry
        mask = (idx < j).astype(dtype)              # columns k < j
        lj = (Lh[j, :] * mask, Ll[j, :] * mask)     # exact masking
        w = df_mul(lj, (Dh, Dl))                    # L[j,k] D[k]
        # s_i = sum_k L[i,k] w[k]  (pair matvec: exact products,
        # tree-fold accumulation)
        ph, pl = df_mul((Lh, Ll), (w[0][None, :], w[1][None, :]))
        s = df_sum(ph, pl, axis=-1)
        # pivot d = A[j,j] - <l_j, w>
        th, tl = df_mul(lj, w)
        t = df_sum(th, tl)
        d = df_add((Ah[j, j], Al[j, j]), df_neg(t))
        zero = (d[0] == 0) & (d[1] == 0)
        d = (jnp.where(zero, jnp.asarray(pivot_floor, dtype), d[0]),
             jnp.where(zero, jnp.zeros((), dtype), d[1]))
        # column: (A[:,j] - s) / d, strictly-below-diagonal rows only
        c = df_div(df_add((Ah[:, j], Al[:, j]), df_neg(s)), d)
        keep = idx > j
        ch = jnp.where(keep, c[0], 0.0)
        cl = jnp.where(keep, c[1], 0.0)
        Lh = Lh.at[:, j].set(ch).at[j, j].set(1.0)
        Ll = Ll.at[:, j].set(cl)
        Dh = Dh.at[j].set(d[0])
        Dl = Dl.at[j].set(d[1])
        return Lh, Ll, Dh, Dl

    L0 = jnp.zeros((n, n), dtype)
    D0 = jnp.zeros((n,), dtype)
    return jax.lax.fori_loop(0, n, body, (L0, L0, D0, D0))


def solve_ldlt_df(Lh, Ll, Dh, Dl, bh, bl):
    """Solve L D L^T x = b on pairs, reusing a factorisation.

    Forward substitution (unit L), diagonal pair division, backward
    substitution (unit L^T); every update is a pair op, so the solve
    keeps the factorisation's ~2^-48 unit roundoff."""
    n = bh.shape[-1]
    if n == 0:
        return bh, bl
    dtype = bh.dtype
    idx = jnp.arange(n)

    def fwd(j, x):
        xj = (x[0][j], x[1][j])
        u = df_mul((Lh[:, j], Ll[:, j]), xj)
        m = (idx > j).astype(dtype)
        return df_add(x, (-u[0] * m, -u[1] * m))

    x = jax.lax.fori_loop(0, n, fwd, (bh, bl))
    x = df_div(x, (Dh, Dl))

    def bwd(t, x):
        j = n - 1 - t
        xj = (x[0][j], x[1][j])
        # (L^T)[i, j] = L[j, i]: update rows i < j
        u = df_mul((Lh[j, :], Ll[j, :]), xj)
        m = (idx < j).astype(dtype)
        return df_add(x, (-u[0] * m, -u[1] * m))

    return jax.lax.fori_loop(0, n, bwd, x)


def ldlt_solve_df(Ah, Al, bh, bl, pivot_floor: float = PIVOT_FLOOR):
    Lh, Ll, Dh, Dl = ldlt_df(Ah, Al, pivot_floor)
    return solve_ldlt_df(Lh, Ll, Dh, Dl, bh, bl)


batched_ldlt_df = jax.vmap(ldlt_df, in_axes=(0, 0, None))
batched_solve_ldlt_df = jax.vmap(solve_ldlt_df)
