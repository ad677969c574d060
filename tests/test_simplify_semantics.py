"""Property test: simplification preserves numerical semantics.

Random well-typed expressions are generated from a shape-aware grammar
(scalars, n-vectors, n x n matrices), then evaluated with the staged
evaluator before and after ``simplify()``.  Any rewrite that changes the
value of an expression is a simplifier bug.  This is the semantic
counterweight to the string-equality golden tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.models import codegen as cg
from ipmzoo.symbolic import (diagonal_matrix, invert, named_scalar,
                                 named_vector, negate, number, product,
                                 sum_expr, symmetric_matrix, transpose,
                                 variable)

N = 4  # vector dimension for all generated expressions


class Gen:
    """Shape-typed random expression generator.

    Shapes: 's' scalar, 'v' column vector, 'd' diagonal matrix,
    'm' square matrix.  Leaves are drawn from a fixed symbol pool so
    cancellation/collection rules actually fire.
    """

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.scalars = [named_scalar("\\alpha"), named_scalar("\\beta")]
        self.vectors = [variable("x"), variable("y"), named_vector("c")]
        self.matrices = [symmetric_matrix("Q")]

    def leaf(self, shape):
        r = self.rng
        if shape == "s":
            if r.random() < 0.4:
                return number(float(r.integers(-3, 4)))
            return self.scalars[r.integers(len(self.scalars))]
        if shape == "v":
            return self.vectors[r.integers(len(self.vectors))]
        if shape == "d":
            return diagonal_matrix(self.vectors[r.integers(len(self.vectors))])
        return self.matrices[0]

    def expr(self, shape, depth):
        r = self.rng
        if depth <= 0 or r.random() < 0.3:
            return self.leaf(shape)
        op = r.integers(4)
        if op == 0:  # sum of same shape
            k = int(r.integers(2, 4))
            return sum_expr([self.expr(shape, depth - 1) for _ in range(k)])
        if op == 1:  # negation
            return negate(self.expr(shape, depth - 1))
        if op == 2:  # scalar scaling
            if shape == "s":
                return product([self.expr("s", depth - 1),
                                self.expr("s", depth - 1)])
            return product([self.expr("s", depth - 1),
                            self.expr(shape, depth - 1)])
        # op == 3: shape-specific products
        if shape == "v":
            pick = r.integers(3)
            if pick == 0:   # diag * vector
                return product([self.expr("d", depth - 1),
                                self.expr("v", depth - 1)])
            if pick == 1:   # matrix * vector
                return product([self.leaf("m"), self.expr("v", depth - 1)])
            return product([invert(self.expr("d", depth - 1)),
                            self.expr("v", depth - 1)])
        if shape == "d":
            if r.random() < 0.5:
                return product([self.expr("d", depth - 1),
                                self.expr("d", depth - 1)])
            return invert(self.expr("d", depth - 1))
        if shape == "s":  # inner product
            return product([transpose(self.expr("v", depth - 1)),
                            self.expr("v", depth - 1)])
        return self.leaf(shape)


def env(seed):
    rng = np.random.default_rng(seed)
    # strictly positive values keep diagonal inverses well-conditioned
    def vec():
        return cg.vector(jnp.asarray(0.5 + rng.random(N)))
    M = rng.random((N, N))
    return {
        named_scalar("\\alpha"): cg.scalar(jnp.asarray(0.5 + rng.random())),
        named_scalar("\\beta"): cg.scalar(jnp.asarray(0.5 + rng.random())),
        variable("x"): vec(),
        variable("y"): vec(),
        named_vector("c"): vec(),
        symmetric_matrix("Q"): cg.matrix(jnp.asarray(M + M.T + N * np.eye(N))),
    }


def _value(v: cg.TV):
    if v.tag == "diag":
        return np.diag(np.asarray(v.val))
    return np.asarray(v.val)


@pytest.mark.parametrize("seed", range(40))
@pytest.mark.parametrize("shape", ["s", "v", "d"])
def test_simplify_preserves_value(seed, shape):
    g = Gen(1000 * seed + ord(shape))
    e = g.expr(shape, depth=4)
    simplified = e.simplify()
    env_vals = env(seed)
    v0 = cg.evaluate(e, dict(env_vals))
    v1 = cg.evaluate(simplified, dict(env_vals))
    a, b = _value(v0), _value(v1)
    if a.shape != b.shape:
        # a rewrite may turn diag into scalar-equivalents etc.; compare
        # as operators applied to a probe vector
        probe = np.arange(1.0, N + 1.0)
        def apply(x):
            x = np.asarray(x)
            if x.ndim == 0:
                return x * probe
            if x.ndim == 1:
                return x
            return x @ probe
        a, b = apply(a), apply(b)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9,
                               err_msg=f"{e.key} -> {simplified.key}")


@pytest.mark.parametrize("seed", range(20))
def test_differentiate_then_simplify_consistent(seed):
    """d/dx of a scalar expression: simplify before vs after
    differentiation must agree numerically."""
    g = Gen(seed + 7777)
    e = g.expr("s", depth=3)
    x = variable("x")
    if not e.contains(x):
        pytest.skip("expression does not involve x")
    try:
        d1 = e.differentiate(x).simplify()
        d2 = e.simplify().differentiate(x).simplify()
    except NotImplementedError:
        pytest.skip("derivative of inverse not implemented (as in the "
                    "reference)")
    env_vals = env(seed)
    a = _value(cg.evaluate(d1, dict(env_vals)))
    b = _value(cg.evaluate(d2, dict(env_vals)))
    if a.shape != b.shape:
        probe = np.arange(1.0, N + 1.0)
        def apply(x_):
            x_ = np.asarray(x_)
            if x_.ndim == 0:
                return x_ * probe
            if x_.ndim == 1:
                return x_
            return x_ @ probe
        a, b = apply(a), apply(b)
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8,
                               err_msg=f"{e.key}")
