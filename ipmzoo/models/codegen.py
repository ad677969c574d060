"""Trace-time staging of symbolic expressions into XLA computations.

This is the staged replacement for the reference's per-iteration
tree-walking interpreter (/root/reference/src/NumericalOptimization/
Evaluation.cpp): instead of interpreting the expression DAG against an
environment every iteration at runtime, we walk it ONCE while tracing a
jitted function, emitting jnp operations.  The compiled XLA program
contains only the numeric ops — all symbolic structure is burned in at
compile time, eliminating every host round-trip.

Value model (mirrors the reference's EvalResult variant, Evaluation.h:12-20):

  ``scalar``  0-d array
  ``vector``  1-d array
  ``diag``    1-d array representing a diagonal matrix (never densified
              unless a cell must be materialised)
  ``matrix``  2-d array
  ``rowvec``  1-d array representing a transposed vector.  The reference
              defers ``v^T * M`` products ("unhandled" list,
              Evaluation.cpp:42-45,154-172); we instead track the
              transposition in the type and compute ``v^T M = (M^T v)^T``,
              which XLA fuses identically.

Shape conventions: empty (size-0) operands broadcast as zeros in
additions, mirroring the reference's elementwise rules
(Evaluation.cpp:202-257) so formulations with absent constraint groups
still stage correctly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import jax.numpy as jnp
import numpy as np

from ..symbolic import expr as E
from ..symbolic.expr import Expr, Kind


@dataclasses.dataclass(frozen=True)
class TV:
    """A tagged trace-time value."""
    tag: str          # 'scalar' | 'vector' | 'diag' | 'matrix' | 'rowvec'
    val: jnp.ndarray

    @property
    def is_vec_like(self) -> bool:
        return self.tag in ("vector", "diag", "rowvec")


def scalar(x) -> TV:
    return TV("scalar", jnp.asarray(x))


def vector(x) -> TV:
    return TV("vector", jnp.asarray(x))


def diag(x) -> TV:
    return TV("diag", jnp.asarray(x))


def matrix(x) -> TV:
    return TV("matrix", jnp.asarray(x))


Env = Dict[Expr, TV]


def _safe_reciprocal(x: jnp.ndarray) -> jnp.ndarray:
    """Elementwise 1/x with 0 mapped to sqrt(dtype max).

    Mirrors the reference guard (Evaluation.cpp:267-271) that keeps
    eliminated-diagonal inverses finite when a slack hits exactly zero.
    """
    big = np.sqrt(np.finfo(x.dtype if x.dtype in (jnp.float32, jnp.float64)
                           else jnp.float32).max)
    return jnp.where(x == 0, jnp.asarray(big, dtype=x.dtype), 1.0 / jnp.where(x == 0, 1.0, x))


def _unary(x: TV, fn: Callable) -> TV:
    return TV(x.tag, fn(x.val))


def negate_tv(x: TV) -> TV:
    return _unary(x, jnp.negative)


def invert_tv(x: TV) -> TV:
    """Elementwise inverse for scalar/vector/diag values.

    Dense-matrix inverses (the H^{-1} the normal-equations elimination
    introduces) are never inverted elementwise: the solver pre-factors
    and binds them into the environment (CompiledIPM._bind_matrix_inverts),
    so evaluation short-circuits before reaching here.  Reaching this
    assert means an unbound matrix inverse leaked into a staged
    expression."""
    assert x.tag != "matrix", \
        "dense-matrix inverse must be pre-bound in the environment"
    return _unary(x, _safe_reciprocal)


def _broadcast_zeros(a: jnp.ndarray, b: jnp.ndarray):
    """If one 1-d operand is empty, treat it as zeros of the other's size."""
    if a.ndim == 1 and b.ndim == 1 and a.shape != b.shape:
        if a.shape[0] == 0:
            a = jnp.zeros_like(b)
        elif b.shape[0] == 0:
            b = jnp.zeros_like(a)
    return a, b


def add_tv(x: TV, y: TV) -> TV:
    """Elementwise addition with the reference's type-promotion rules."""
    if x.tag == "scalar" and y.tag == "scalar":
        return scalar(x.val + y.val)
    if x.tag == "diag" and y.tag == "diag":
        a, b = _broadcast_zeros(x.val, y.val)
        return diag(a + b)
    if x.is_vec_like and y.is_vec_like:
        a, b = _broadcast_zeros(x.val, y.val)
        tag = "rowvec" if (x.tag == "rowvec" or y.tag == "rowvec") else "vector"
        return TV(tag, a + b)
    if x.tag == "matrix" and y.tag == "diag":
        return matrix(x.val + jnp.diag(y.val))
    if x.tag == "diag" and y.tag == "matrix":
        return matrix(jnp.diag(x.val) + y.val)
    if x.tag == "matrix" and y.tag == "matrix":
        return matrix(x.val + y.val)
    # Identity convention: simplification rewrites e.g. diag(v) diag(v)^-1
    # to the literal 1, which in an additive matrix context means the
    # identity matrix (the same convention the symbolic layer renders as
    # I and as_block materialises as s*eye).  Scalars therefore add onto
    # the diagonal of diag/matrix operands.
    if x.tag == "scalar" and y.tag == "diag":
        return diag(y.val + x.val)
    if x.tag == "diag" and y.tag == "scalar":
        return diag(x.val + y.val)
    if x.tag == "scalar" and y.tag == "matrix":
        n = y.val.shape[0]
        return matrix(y.val + x.val * jnp.eye(n, dtype=y.val.dtype))
    if x.tag == "matrix" and y.tag == "scalar":
        return add_tv(y, x)
    raise TypeError(f"cannot add {x.tag} and {y.tag}")


def multiply_tv(x: TV, y: TV) -> TV:
    """Product with the reference's shape-dispatch semantics
    (Evaluation.cpp:23-50), extended with a ``rowvec`` tag that replaces
    the reference's ``v^T * M`` deferral mechanism."""
    xt, yt = x.tag, y.tag
    if xt == "scalar":
        return _unary(y, lambda v: x.val * v)
    if yt == "scalar":
        return _unary(x, lambda v: v * y.val)
    # inner products: ANY product of two (row)vectors is a dot product —
    # the reference has no row/column distinction (both are ValVector and
    # vec*vec -> dot, Evaluation.cpp:29-31); canonical product reordering
    # during simplification relies on exactly these semantics (e.g.
    # `x^T c^T c c` groups as (x.c)(c.c) and is correct by commutativity)
    if xt in ("vector", "rowvec") and yt in ("vector", "rowvec"):
        return scalar(jnp.dot(x.val, y.val))
    # elementwise when a diagonal is involved; diag*diag stays diag
    if xt in ("vector", "diag", "rowvec") and yt in ("vector", "diag", "rowvec"):
        if xt == "diag" and yt == "diag":
            return diag(x.val * y.val)
        out_tag = yt if xt == "diag" else xt
        return TV(out_tag, x.val * y.val)
    # matrix-vector forms
    if xt == "matrix" and yt == "vector":
        return vector(x.val @ y.val)
    if xt == "rowvec" and yt == "matrix":
        # v^T M = (M^T v)^T — the staged form of the reference's deferral
        return TV("rowvec", y.val.T @ x.val)
    if xt == "vector" and yt == "matrix":
        # kept total for parity with the deferral fallback
        return TV("rowvec", y.val.T @ x.val)
    # matrix scaling by a diagonal
    if xt == "matrix" and yt == "diag":
        return matrix(x.val * y.val[None, :])
    if xt == "diag" and yt == "matrix":
        return matrix(x.val[:, None] * y.val)
    if xt == "matrix" and yt == "matrix":
        return matrix(x.val @ y.val)
    raise TypeError(f"cannot multiply {xt} and {yt}")


def transpose_tv(x: TV) -> TV:
    if x.tag == "matrix":
        return matrix(x.val.T)
    if x.tag == "vector":
        return TV("rowvec", x.val)
    if x.tag == "rowvec":
        return vector(x.val)
    return x  # scalars and diagonals are symmetric


def evaluate(e: Expr, env: Env, _memo=None) -> TV:
    """Stage ``e`` into jnp ops under the bindings in ``env``.

    ``env`` entries short-circuit evaluation (they double as a memo for
    shorthand residual vectors, like the reference environment).
    """
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


def _evaluate(e: Expr, env: Env, memo) -> TV:
    k = e.kind
    if k == Kind.NUMBER:
        return scalar(e.value)
    if k in (Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
             Kind.MATRIX, Kind.SYMMETRIC_MATRIX):
        raise KeyError(f"symbol {e!r} not bound in environment")
    if k == Kind.DIAGONAL_MATRIX:
        v = evaluate(e.child, env, memo)
        assert v.tag in ("vector", "rowvec"), \
            f"diag of non-vector {v.tag} ({e!r})"
        return diag(v.val)
    if k == Kind.TRANSPOSE:
        return transpose_tv(evaluate(e.child, env, memo))
    if k == Kind.INVERT:
        return invert_tv(evaluate(e.child, env, memo))
    if k == Kind.LOG:
        v = evaluate(e.child, env, memo)
        return _unary(v, jnp.log)
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


def as_block(v: TV, rows: int, cols: int) -> jnp.ndarray:
    """Materialise a cell value as a dense (rows, cols) block for KKT
    assembly.  Scalars broadcast onto the diagonal (a superset of the
    reference, which rejects scalar cells)."""
    if v.tag == "matrix":
        assert v.val.shape == (rows, cols), (v.val.shape, rows, cols)
        return v.val
    if v.tag == "diag":
        assert rows == cols and v.val.shape == (rows,)
        return jnp.diag(v.val)
    if v.tag == "scalar":
        assert rows == cols
        return v.val * jnp.eye(rows, dtype=v.val.dtype)
    if v.tag in ("vector", "rowvec"):
        # 1-column / 1-row blocks
        if cols == 1:
            return v.val.reshape(rows, 1)
        if rows == 1:
            return v.val.reshape(1, cols)
    raise TypeError(f"cannot materialise {v.tag} as ({rows},{cols}) block")


def as_vector(v: TV, size: int) -> jnp.ndarray:
    if v.tag in ("vector", "rowvec", "diag"):
        if v.val.shape[0] == 0 and size > 0:
            return jnp.zeros((size,), dtype=v.val.dtype)
        assert v.val.shape == (size,), (v.val.shape, size)
        return v.val
    if v.tag == "scalar" and size == 1:
        return v.val.reshape(1)
    raise TypeError(f"cannot materialise {v.tag} as vector of {size}")


#: module-generic alias: codegen_df's variant rounds its pair to the
#: working dtype, so solver code can swap modules freely
as_vector_arr = as_vector
