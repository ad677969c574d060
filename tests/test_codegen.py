"""Staged evaluation semantics (models/codegen.py).

Mirrors the behaviours the reference exercises in
test/Evaluation_test.cpp: scalar/vector/matrix evaluation, matvec,
transpose handling, quadratic forms, type-promotion rules between
vectors and diagonals, and error handling for unbound symbols.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.models import codegen as cg
from ipmzoo.symbolic import (diagonal_matrix, invert, matrix,
                                 named_scalar, named_vector, negate, number,
                                 product, sum_expr, symmetric_matrix,
                                 transpose, variable)

x = variable("x")
y = variable("y")
Q = symmetric_matrix("Q")
A = matrix("A")
alpha = named_scalar("\\alpha")


def env():
    return {
        x: cg.vector(jnp.asarray([1.0, 2.0, 3.0])),
        y: cg.vector(jnp.asarray([4.0, 5.0, 6.0])),
        Q: cg.matrix(jnp.asarray([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0],
                                  [0.0, 1.0, 4.0]])),
        A: cg.matrix(jnp.asarray([[1.0, 0.0, 2.0], [0.0, 1.0, 0.0]])),
        alpha: cg.scalar(jnp.asarray(2.5)),
    }


class TestBasicEval:
    def test_number(self):
        v = cg.evaluate(number(3.5), {})
        assert v.tag == "scalar" and float(v.val) == 3.5

    def test_matvec(self):
        v = cg.evaluate(product([A, x]), env())
        assert v.tag == "vector"
        np.testing.assert_allclose(np.asarray(v.val), [7.0, 2.0])

    def test_quadratic_form(self):
        # x^T Q x = [1,2,3] Q [1,2,3]
        e = product([transpose(x), Q, x])
        v = cg.evaluate(e, env())
        assert v.tag in ("scalar",)
        xv = np.array([1.0, 2.0, 3.0])
        Qv = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 4.0]])
        np.testing.assert_allclose(float(v.val), xv @ Qv @ xv)

    def test_scalar_scaling(self):
        v = cg.evaluate(product([alpha, x]), env())
        np.testing.assert_allclose(np.asarray(v.val), [2.5, 5.0, 7.5])

    def test_dot_product(self):
        v = cg.evaluate(product([transpose(x), y]), env())
        np.testing.assert_allclose(float(v.val), 32.0)

    def test_rowvec_times_matrix(self):
        # x^T Q stays a row vector; (x^T Q) y is a scalar
        v = cg.evaluate(product([transpose(x), Q]), env())
        assert v.tag == "rowvec"
        s = cg.evaluate(product([transpose(x), Q, y]), env())
        xv = np.array([1.0, 2, 3])
        Qv = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 4.0]])
        np.testing.assert_allclose(float(s.val),
                                   xv @ Qv @ np.array([4.0, 5, 6]))

    def test_diag_rules(self):
        e = product([diagonal_matrix(x), y])
        v = cg.evaluate(e, env())
        assert v.tag == "vector"
        np.testing.assert_allclose(np.asarray(v.val), [4.0, 10.0, 18.0])
        d = cg.evaluate(product([diagonal_matrix(x), diagonal_matrix(y)]),
                        env())
        assert d.tag == "diag"

    def test_invert_is_elementwise_with_zero_guard(self):
        z = variable("z")
        e = invert(diagonal_matrix(z))
        v = cg.evaluate(e, {z: cg.vector(jnp.asarray([2.0, 0.0, 4.0]))})
        out = np.asarray(v.val)
        np.testing.assert_allclose(out[[0, 2]], [0.5, 0.25])
        assert out[1] > 1e10  # zero mapped to a large finite value

    def test_sum_with_negate(self):
        v = cg.evaluate(sum_expr([x, negate(y)]), env())
        np.testing.assert_allclose(np.asarray(v.val), [-3.0, -3.0, -3.0])

    def test_empty_operand_broadcasts_as_zero(self):
        w = variable("w")
        e = sum_expr([x, w])
        v = cg.evaluate(e, {**env(), w: cg.vector(jnp.zeros((0,)))})
        np.testing.assert_allclose(np.asarray(v.val), [1.0, 2.0, 3.0])

    def test_unbound_symbol_raises(self):
        with pytest.raises(KeyError):
            cg.evaluate(variable("unbound"), {})

    def test_env_short_circuits(self):
        # entries bound in env shadow structural evaluation (memoisation
        # of shorthand residual vectors relies on this)
        e = product([A, x])
        v = cg.evaluate(e, {**env(), e: cg.vector(jnp.asarray([9.0, 9.0]))})
        np.testing.assert_allclose(np.asarray(v.val), [9.0, 9.0])


class TestBlocks:
    def test_as_block_diag(self):
        b = cg.as_block(cg.diag(jnp.asarray([1.0, 2.0])), 2, 2)
        np.testing.assert_allclose(np.asarray(b), [[1, 0], [0, 2.0]])

    def test_as_block_scalar_is_scaled_identity(self):
        b = cg.as_block(cg.scalar(jnp.asarray(-0.5)), 3, 3)
        np.testing.assert_allclose(np.asarray(b), -0.5 * np.eye(3))

    def test_as_vector_empty(self):
        v = cg.as_vector(cg.vector(jnp.zeros((0,))), 3)
        np.testing.assert_allclose(np.asarray(v), np.zeros(3))
