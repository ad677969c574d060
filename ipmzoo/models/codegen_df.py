"""Two-float (double-single) staged evaluation of symbolic expressions.

``codegen.py`` stages expressions into working-precision (e.g. f32)
XLA ops.  Near convergence the residual rows it evaluates — e.g.
``Qx + c + A^T lambda`` — are pure cancellation: their f32 value carries
an ABSOLUTE error of ~eps * ||Qx||, so once the true residual drops
below that noise floor the Newton right-hand sides are garbage and the
solver's achievable accuracy is capped.

This module mirrors codegen's value model and dispatch semantics
exactly (same tags, same type-promotion rules, same ``v^T M`` rowvec
mechanism — see codegen.py and the reference Evaluation.cpp it
documents) but carries every value as an unevaluated (hi, lo) two-float
pair (:mod:`ipmzoo.ops.twofloat`).  Sums, products, matvecs and
reciprocals keep ~2x working precision, so evaluated residuals have
small RELATIVE error: f64-grade Newton right-hand sides and convergence
metrics from pure-f32 arithmetic.

Used by ``CompiledIPM(df_residuals=True)`` for the residual/metric
pipeline; KKT assembly and factorisation stay in working precision.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax.numpy as jnp
import numpy as np

from ..ops.twofloat import df_sum, quick_two_sum, two_prod, two_sum
from ..symbolic import expr as E  # noqa: F401  (parity with codegen)
from ..symbolic.expr import Expr, Kind
from . import codegen as cg

# ----------------------------------------------------------------------
# pair arithmetic (elementwise, broadcasting like jnp)
# ----------------------------------------------------------------------


def p_add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def p_neg(a):
    return (-a[0], -a[1])


def p_mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def p_recip(a):
    """Pair reciprocal with the safe-zero guard of codegen's
    ``_safe_reciprocal`` applied to the high word."""
    hi = a[0]
    big = np.sqrt(np.finfo(
        hi.dtype if hi.dtype in (jnp.float32, jnp.float64)
        else jnp.float32).max)
    zero = hi == 0
    safe_hi = jnp.where(zero, 1.0, hi)
    y0 = 1.0 / safe_hi
    # one Newton step in pairs: y = y0 + y0 * (1 - a * y0)
    ay = p_mul((safe_hi, jnp.where(zero, 0.0, a[1])),
               (y0, jnp.zeros_like(y0)))
    one = (jnp.ones_like(y0), jnp.zeros_like(y0))
    r = p_add(one, p_neg(ay))
    y = p_add((y0, jnp.zeros_like(y0)),
              p_mul((y0, jnp.zeros_like(y0)), r))
    return (jnp.where(zero, jnp.asarray(big, hi.dtype), y[0]),
            jnp.where(zero, 0.0, y[1]))


def p_dot(a, b):
    """Pair dot product -> scalar pair."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return df_sum(p, e)


def p_matvec(M, v):
    """Pair (m, n) matrix @ pair (n,) vector -> (m,) pair."""
    p, e = two_prod(M[0], v[0][None, :])
    e = e + (M[0] * v[1][None, :] + M[1] * v[0][None, :])
    return df_sum(p, e, axis=-1)


# ----------------------------------------------------------------------
# tagged pair values
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DFTV:
    """A tagged two-float trace-time value (mirrors codegen.TV)."""
    tag: str
    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def pair(self):
        return (self.hi, self.lo)

    @property
    def val(self) -> jnp.ndarray:
        """Rounded to working precision."""
        return self.hi + self.lo


def lift(tv: cg.TV) -> DFTV:
    """Promote a working-precision TV (exact, lo = 0)."""
    return DFTV(tv.tag, tv.val, jnp.zeros_like(tv.val))


def lift_env(env: cg.Env) -> "DFEnv":
    return {k: lift(v) for k, v in env.items()}


def scalar(x) -> DFTV:
    x = jnp.asarray(x)
    return DFTV("scalar", x, jnp.zeros_like(x))


def vector(x) -> DFTV:
    x = jnp.asarray(x)
    return DFTV("vector", x, jnp.zeros_like(x))


def pair_vector(hi, lo) -> DFTV:
    return DFTV("vector", hi, lo)


DFEnv = Dict[Expr, DFTV]


def _tv(tag, pair) -> DFTV:
    return DFTV(tag, pair[0], pair[1])


def negate_tv(x: DFTV) -> DFTV:
    return _tv(x.tag, p_neg(x.pair))


def invert_tv(x: DFTV) -> DFTV:
    assert x.tag != "matrix", \
        "dense-matrix inverse is never staged elementwise"
    return _tv(x.tag, p_recip(x.pair))


def _broadcast_zeros(a: DFTV, b: DFTV):
    if a.hi.ndim == 1 and b.hi.ndim == 1 and a.hi.shape != b.hi.shape:
        if a.hi.shape[0] == 0:
            a = DFTV(a.tag, jnp.zeros_like(b.hi), jnp.zeros_like(b.lo))
        elif b.hi.shape[0] == 0:
            b = DFTV(b.tag, jnp.zeros_like(a.hi), jnp.zeros_like(a.lo))
    return a, b


def add_tv(x: DFTV, y: DFTV) -> DFTV:
    """Mirrors codegen.add_tv's promotion rules on pairs."""
    if x.tag == "scalar" and y.tag == "scalar":
        return _tv("scalar", p_add(x.pair, y.pair))
    if x.tag == "diag" and y.tag == "diag":
        a, b = _broadcast_zeros(x, y)
        return _tv("diag", p_add(a.pair, b.pair))
    xv = x.tag in ("vector", "diag", "rowvec")
    yv = y.tag in ("vector", "diag", "rowvec")
    if xv and yv:
        a, b = _broadcast_zeros(x, y)
        tag = "rowvec" if (x.tag == "rowvec" or y.tag == "rowvec") \
            else "vector"
        return _tv(tag, p_add(a.pair, b.pair))
    if x.tag == "matrix" and y.tag == "diag":
        return _tv("matrix", p_add(x.pair, (jnp.diag(y.hi),
                                            jnp.diag(y.lo))))
    if x.tag == "diag" and y.tag == "matrix":
        return add_tv(y, x)
    if x.tag == "matrix" and y.tag == "matrix":
        return _tv("matrix", p_add(x.pair, y.pair))
    if x.tag == "scalar" and y.tag == "diag":
        return _tv("diag", p_add(y.pair, x.pair))
    if x.tag == "diag" and y.tag == "scalar":
        return _tv("diag", p_add(x.pair, y.pair))
    if x.tag == "scalar" and y.tag == "matrix":
        n = y.hi.shape[0]
        eye = jnp.eye(n, dtype=y.hi.dtype)
        return _tv("matrix", p_add(y.pair, (x.hi * eye, x.lo * eye)))
    if x.tag == "matrix" and y.tag == "scalar":
        return add_tv(y, x)
    raise TypeError(f"cannot add {x.tag} and {y.tag}")


def multiply_tv(x: DFTV, y: DFTV) -> DFTV:
    """Mirrors codegen.multiply_tv's shape dispatch on pairs."""
    xt, yt = x.tag, y.tag
    if xt == "scalar":
        return _tv(yt, p_mul(x.pair, y.pair))
    if yt == "scalar":
        return _tv(xt, p_mul(x.pair, y.pair))
    if xt in ("vector", "rowvec") and yt in ("vector", "rowvec"):
        return _tv("scalar", p_dot(x.pair, y.pair))
    if xt in ("vector", "diag", "rowvec") and \
            yt in ("vector", "diag", "rowvec"):
        if xt == "diag" and yt == "diag":
            return _tv("diag", p_mul(x.pair, y.pair))
        out_tag = yt if xt == "diag" else xt
        return _tv(out_tag, p_mul(x.pair, y.pair))
    if xt == "matrix" and yt == "vector":
        return _tv("vector", p_matvec(x.pair, y.pair))
    if xt == "rowvec" and yt == "matrix":
        return _tv("rowvec", p_matvec((y.hi.T, y.lo.T), x.pair))
    if xt == "vector" and yt == "matrix":
        return _tv("rowvec", p_matvec((y.hi.T, y.lo.T), x.pair))
    if xt == "matrix" and yt == "diag":
        return _tv("matrix", p_mul(x.pair, (y.hi[None, :], y.lo[None, :])))
    if xt == "diag" and yt == "matrix":
        return _tv("matrix", p_mul((x.hi[:, None], x.lo[:, None]), y.pair))
    raise TypeError(f"cannot multiply {xt} and {yt} in two-float "
                    "(dense matrix-matrix products are never staged on "
                    "the residual path)")


def transpose_tv(x: DFTV) -> DFTV:
    if x.tag == "matrix":
        return DFTV("matrix", x.hi.T, x.lo.T)
    if x.tag == "vector":
        return DFTV("rowvec", x.hi, x.lo)
    if x.tag == "rowvec":
        return DFTV("vector", x.hi, x.lo)
    return x


def evaluate(e: Expr, env: DFEnv, _memo=None) -> DFTV:
    if _memo is None:
        _memo = {}
    hit = env.get(e)
    if hit is not None:
        return hit
    hit = _memo.get(e)
    if hit is not None:
        return hit
    res = _evaluate(e, env, _memo)
    _memo[e] = res
    return res


def _evaluate(e: Expr, env: DFEnv, memo) -> DFTV:
    k = e.kind
    if k == Kind.NUMBER:
        return scalar(e.value)
    if k in (Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
             Kind.MATRIX, Kind.SYMMETRIC_MATRIX):
        raise KeyError(f"symbol {e!r} not bound in environment")
    if k == Kind.DIAGONAL_MATRIX:
        v = evaluate(e.child, env, memo)
        assert v.tag in ("vector", "rowvec")
        return DFTV("diag", v.hi, v.lo)
    if k == Kind.TRANSPOSE:
        return transpose_tv(evaluate(e.child, env, memo))
    if k == Kind.INVERT:
        return invert_tv(evaluate(e.child, env, memo))
    if k == Kind.LOG:
        # barriers only matter through their derivatives; parity with
        # the reference (Evaluation.cpp Log -> ASSERT(false)) and with
        # codegen would make this jnp.log, but a pair log is not needed
        # on any residual path
        v = evaluate(e.child, env, memo)
        return DFTV(v.tag, jnp.log(v.val), jnp.zeros_like(v.hi))
    if k == Kind.NEGATE:
        return negate_tv(evaluate(e.child, env, memo))
    if k == Kind.SUM:
        res = evaluate(e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = add_tv(res, evaluate(t, env, memo))
        return res
    if k == Kind.PRODUCT:
        res = evaluate(e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = multiply_tv(res, evaluate(t, env, memo))
        return res
    raise AssertionError(f"unknown kind {k}")


def as_vector(v: DFTV, size: int) -> DFTV:
    """Shape-checked vector view (still a pair)."""
    if v.tag in ("vector", "rowvec", "diag"):
        if v.hi.shape[0] == 0 and size > 0:
            z = jnp.zeros((size,), v.hi.dtype)
            return DFTV("vector", z, z)
        assert v.hi.shape == (size,), (v.hi.shape, size)
        return DFTV("vector", v.hi, v.lo)
    if v.tag == "scalar" and size == 1:
        return DFTV("vector", v.hi.reshape(1), v.lo.reshape(1))
    raise TypeError(f"cannot materialise {v.tag} as vector of {size}")


def as_vector_arr(v: DFTV, size: int) -> jnp.ndarray:
    """Shape-checked vector, rounded to the working dtype."""
    return as_vector(v, size).val


def as_block(v: DFTV, rows: int, cols: int):
    """Materialise a cell value as a dense (rows, cols) pair of blocks
    for two-float KKT assembly (mirrors codegen.as_block; used by the
    two-float factorisation path, where the augmented system itself is
    assembled and factored in pairs)."""
    if v.tag == "matrix":
        assert v.hi.shape == (rows, cols), (v.hi.shape, rows, cols)
        return v.hi, v.lo
    if v.tag == "diag":
        assert rows == cols and v.hi.shape == (rows,)
        return jnp.diag(v.hi), jnp.diag(v.lo)
    if v.tag == "scalar":
        assert rows == cols
        eye = jnp.eye(rows, dtype=v.hi.dtype)
        return v.hi * eye, v.lo * eye
    if v.tag in ("vector", "rowvec"):
        if cols == 1:
            return v.hi.reshape(rows, 1), v.lo.reshape(rows, 1)
        if rows == 1:
            return v.hi.reshape(1, cols), v.lo.reshape(1, cols)
    raise TypeError(f"cannot materialise {v.tag} as ({rows},{cols}) block")


def norm2(pairs) -> jnp.ndarray:
    """||concat(pairs)||_2 with compensated accumulation; rounded."""
    acc = None
    for (hi, lo) in pairs:
        if hi.shape[0] == 0:
            continue
        p, e = two_prod(hi, hi)
        e = e + 2.0 * hi * lo
        s = df_sum(p, e)
        acc = s if acc is None else p_add(acc, s)
    if acc is None:
        return jnp.asarray(0.0)
    return jnp.sqrt(acc[0] + acc[1])


def abs_sum(pairs) -> jnp.ndarray:
    """sum |x| over concatenated pairs; rounded."""
    acc = None
    for (hi, lo) in pairs:
        if hi.shape[0] == 0:
            continue
        sign = jnp.where(hi < 0, -1.0, 1.0).astype(hi.dtype)
        s = df_sum(sign * hi, sign * lo)
        acc = s if acc is None else p_add(acc, s)
    if acc is None:
        return jnp.asarray(0.0)
    return acc[0] + acc[1]
