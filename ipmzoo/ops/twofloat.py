"""Two-float (double-single) compensated arithmetic for f32 devices.

Accelerators are fastest in f32/bf16, but iterative refinement with
f32 residuals stalls: the computed residual ``b - K x`` loses exactly
the low bits refinement needs.  The classical fix is mixed-precision
refinement — factor in working precision, evaluate residuals in roughly
twice the precision.  This module builds that extended precision
from f32 alone, from *error-free transformations* (Dekker/Knuth):

    two_sum(a, b)   -> (s, e)  with  a + b = s + e   exactly
    two_prod(a, b)  -> (p, e)  with  a * b = p + e   exactly
                       (Dekker splitting; no FMA required)

and represents extended values as unevaluated (hi, lo) pairs.  The
reductions are *binary tree folds* of (hi, lo) pairs — log2(n)
elementwise steps, fully parallel (a sequential Neumaier sum
would serialise; the tree keeps the same ~2x-precision error bound).

Everything is elementwise/reshape ops — jit/vmap-compatible, O(m n)
work, negligible next to an O(n^3) factorisation.

The reference has no counterpart (it computes everything in f64 on the
host); this is part of the redesign: f32 factorisations plus
compensated residuals recover near-f64 refined solutions at f32 speed.
"""

from __future__ import annotations

import jax.numpy as jnp

# Dekker splitting constant: 2^ceil(p/2) + 1 for a p-bit mantissa.
_SPLIT = {jnp.dtype(jnp.float32): 4097.0,        # 2^12 + 1 (p = 24)
          jnp.dtype(jnp.float64): 134217729.0}   # 2^27 + 1 (p = 53)


def two_sum(a, b):
    """(s, e) with a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """(s, e) with a + b = s + e exactly, assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = jnp.asarray(_SPLIT[jnp.dtype(a.dtype)], a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with a * b = p + e exactly (Dekker; FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(a, b):
    """Add two (hi, lo) pairs -> normalised (hi, lo) pair."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def df_neg(a):
    """Negate a (hi, lo) pair (exact)."""
    return -a[0], -a[1]


def df_mul(a, b):
    """Multiply two (hi, lo) pairs -> normalised (hi, lo) pair."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def df_recip(b):
    """Pair reciprocal via one Newton step: y = y0 + y0 (1 - b y0).

    No zero guard — callers on the factorisation path floor their
    pivots first (the evaluator-level guard lives in
    models/codegen_df.p_recip)."""
    y0 = 1.0 / b[0]
    y0p = (y0, jnp.zeros_like(y0))
    one = (jnp.ones_like(y0), jnp.zeros_like(y0))
    r = df_add(one, df_neg(df_mul(b, y0p)))
    return df_add(y0p, df_mul(y0p, r))


def df_div(a, b):
    """Pair division a / b (relative error ~2 ulp of the pair format)."""
    return df_mul(a, df_recip(b))


def df_matvec(M, v):
    """Pair (m, n) matrix @ pair (n,) vector -> (m,) pair, with exact
    products and tree-fold accumulation."""
    ph, pl = df_mul((M[0], M[1]), (v[0][None, :], v[1][None, :]))
    return df_sum(ph, pl, axis=-1)


def df_sum(hi, lo, axis=-1):
    """Tree-fold reduction of (hi, lo) pairs along ``axis``."""
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    if n == 0:
        z = jnp.zeros(hi.shape[:-1], hi.dtype)
        return z, z
    while n > 1:
        if n % 2:
            hi = jnp.concatenate(
                [hi, jnp.zeros(hi.shape[:-1] + (1,), hi.dtype)], axis=-1)
            lo = jnp.concatenate(
                [lo, jnp.zeros(lo.shape[:-1] + (1,), lo.dtype)], axis=-1)
            n += 1
        h = n // 2
        hi, lo = df_add((hi[..., :h], lo[..., :h]),
                        (hi[..., h:], lo[..., h:]))
        n = h
    return hi[..., 0], lo[..., 0]


def comp_dot(a, b):
    """Compensated dot product; returns a (hi, lo) pair."""
    p, e = two_prod(a, b)
    hi, lo = df_sum(p, e)
    return hi, lo


def comp_matvec(K, x):
    """K @ x with compensated products and tree-fold accumulation.

    Returns a (hi, lo) pair of shape (m,)."""
    p, e = two_prod(K, x[None, :])
    return df_sum(p, e, axis=-1)


def comp_residual(b, K, x):
    """b - K @ x evaluated in double-single; returned rounded to the
    working dtype (the refinement correction only needs the high part,
    but it must be computed without cancellation)."""
    hi, lo = comp_matvec(K, x)
    s, e = two_sum(b, -hi)
    return s + (e - lo)


def comp_norm2(r):
    """||r||_2 with compensated squaring/accumulation (scalar, working
    dtype)."""
    p, e = two_prod(r, r)
    hi, lo = df_sum(p, e)
    return jnp.sqrt(hi + lo)
