"""Expression-core semantics: differentiation, simplification, interning.

Covers the behaviours the reference exercises in test/Expr_test.cpp and
test/ExprFactory_test.cpp (quadratic forms, cancellation, canonical order,
factor extraction, intern identity), re-expressed against our API.
"""

import pytest

from ipmzoo.symbolic import (ZERO, UNITY, diagonal_matrix, invert,
                                 intern_cache_size, log, matrix, named_scalar,
                                 named_vector, negate, number, product,
                                 sum_expr, symmetric_matrix, transpose,
                                 variable)


x = variable("x")
y = variable("y")
Q = symmetric_matrix("Q")
A = matrix("A")
c = named_vector("c")
mu = named_scalar("\\mu")


class TestInterning:
    def test_pointer_identity(self):
        assert variable("x") is x
        assert sum_expr([x, y]) is sum_expr([x, y])
        assert product([x, y]) is product([x, y])
        assert number(2.0) is number(2)

    def test_empty_and_singleton_identities(self):
        assert sum_expr([]) is ZERO
        assert product([]) is UNITY
        assert sum_expr([x]) is x
        assert product([x]) is x

    def test_cache_grows(self):
        n0 = intern_cache_size()
        variable("a_fresh_variable_name")
        assert intern_cache_size() == n0 + 1


class TestSimplification:
    def test_identity_elements(self):
        assert sum_expr([x, ZERO]).simplify() is x
        assert product([x, UNITY]).simplify() is x
        assert product([x, ZERO]).simplify() is ZERO

    def test_cancellation(self):
        assert (x - x).simplify() is ZERO
        assert product([x, invert(x)]).simplify() is UNITY
        assert negate(negate(x)).simplify() is x
        assert transpose(transpose(x)).simplify() is x
        assert invert(invert(x)).simplify() is x

    def test_numeric_folding(self):
        e = sum_expr([number(1), x, number(2)]).simplify()
        assert e is sum_expr([number(3), x]).simplify()
        e = product([number(2), x, number(3)]).simplify()
        assert e is product([number(6), x]).simplify()

    def test_coefficient_collection(self):
        e = sum_expr([x, y, product([number(1.3), x])]).simplify()
        assert e is sum_expr([y, product([number(2.3), x])]).simplify()

    def test_commutative_canonical_order(self):
        assert sum_expr([y, x]).simplify() is sum_expr([x, y]).simplify()
        # numbers sort before variables
        s = sum_expr([x, number(2)]).simplify()
        assert s.terms[0] is number(2)

    def test_negation_hoisting(self):
        e = product([x, negate(y)]).simplify()
        assert e is negate(product([x, y])).simplify()
        e = negate(sum_expr([negate(x), negate(y)])).simplify()
        assert e is sum_expr([x, y]).simplify()

    def test_transpose_algebra(self):
        e = transpose(product([A, x])).simplify()
        assert e is product([transpose(x), transpose(A)]).simplify()
        assert transpose(Q).simplify() is Q
        assert transpose(diagonal_matrix(x)).simplify() is diagonal_matrix(x)

    def test_invert_algebra(self):
        e = invert(product([diagonal_matrix(x), diagonal_matrix(y)]))
        s = e.simplify()
        assert s is product([invert(diagonal_matrix(y)),
                             invert(diagonal_matrix(x))]).simplify()

    def test_factor_extraction(self):
        # Ax + Ay = A(x + y): complexity 4 -> 3.5
        e = sum_expr([product([A, x]), product([A, y])]).simplify()
        assert e is product([A, sum_expr([x, y])])

    def test_distribution_when_not_larger(self):
        # A(x + y) stays factored (equal complexity favours... distribution
        # accepted when complexity does not increase); both forms simplify
        # to the same fixpoint either way.
        e = product([A, sum_expr([x, y])]).simplify()
        e2 = sum_expr([product([A, x]), product([A, y])]).simplify()
        assert e is e2

    def test_diag_cancellation_in_products(self):
        # diag(x) * diag(x)^-1 = 1 — load-bearing for Gaussian elimination
        e = product([diagonal_matrix(x), invert(diagonal_matrix(x))])
        assert e.simplify() is UNITY

    def test_zero_transpose_and_diag(self):
        assert transpose(ZERO).simplify() is ZERO
        assert diagonal_matrix(ZERO).simplify() is ZERO
        assert diagonal_matrix(UNITY).simplify() is UNITY


class TestDifferentiation:
    def test_leaf_rules(self):
        assert x.differentiate(x) is UNITY
        assert y.differentiate(x) is ZERO
        assert c.differentiate(x) is ZERO

    def test_quadratic_form(self):
        # d/dx 1/2 x^T Q x = Q x for symmetric Q
        e = product([number(0.5), transpose(x), Q, x])
        d = e.differentiate(x).simplify()
        assert d is product([Q, x])

    def test_linear_form(self):
        # d/dx c^T x = c (a column vector, via the transpose special case)
        e = product([transpose(c), x])
        assert e.differentiate(x).simplify() is c

    def test_general_matrix_quadratic(self):
        # d/dx x^T M x = M x + M^T x for non-symmetric M
        M = matrix("M")
        e = product([transpose(x), M, x])
        d = e.differentiate(x).simplify()
        expected = sum_expr([product([M, x]),
                             product([transpose(M), x])]).simplify()
        assert d is expected

    def test_log_barrier(self):
        # d/ds -mu e^T log(s) = -mu S^{-1} e
        e_vec = named_vector("e")
        s = variable("s")
        b = negate(product([mu, transpose(e_vec), log(s)]))
        d = b.differentiate(s).simplify()
        expected = negate(product([mu, invert(diagonal_matrix(s)),
                                   e_vec])).simplify()
        assert d is expected

    def test_complementarity_form(self):
        # diag(s) * d/ds(-lambda^T s - mu e^T log s) = -(S lambda + mu e)
        e_vec = named_vector("e")
        s = variable("s")
        lam = variable("\\lambda")
        L = sum_expr([negate(product([transpose(lam), s])).simplify(),
                      negate(product([mu, transpose(e_vec),
                                      log(s)])).simplify()])
        row = product([diagonal_matrix(s), L.differentiate(s)]).simplify()
        expected = negate(sum_expr([
            product([diagonal_matrix(s), lam]),
            product([mu, e_vec])])).simplify()
        assert row is expected

    def test_diag_wrap_special_case(self):
        # d/ds (Lambda s) where Lambda = diag(lambda): derivative of the
        # diagonal factor times trailing variable wraps the variable:
        # d/d(lambda) (diag(lambda) s) = diag(s)
        lam = variable("\\lambda")
        s = variable("s")
        e = product([diagonal_matrix(lam), s])
        d = e.differentiate(lam).simplify()
        assert d is diagonal_matrix(s)

    def test_chain_through_transpose_negate(self):
        e = negate(transpose(x))
        assert e.differentiate(x).simplify() is negate(UNITY).simplify()

    def test_sum_rule(self):
        e = sum_expr([product([A, x]), product([transpose(c), x])])
        d = e.differentiate(x).simplify()
        expected = sum_expr([A, c]).simplify()
        assert d is expected


class TestStructuralOps:
    def test_contains(self):
        e = product([transpose(x), Q, x])
        assert e.contains(x)
        assert e.contains(Q)
        assert not e.contains(y)

    def test_replace(self):
        e = product([A, x])
        r = e.replace(x, y)
        assert r is product([A, y])

    def test_replace_nested(self):
        e = sum_expr([product([mu, x]), negate(product([mu, y]))])
        r = e.replace(mu, ZERO)
        assert r.simplify() is ZERO

    def test_variables(self):
        e = sum_expr([product([A, x]), product([diagonal_matrix(y), x])])
        assert e.variables() == frozenset({x, y})

    def test_complexity(self):
        assert number(1).complexity() == 0.5
        assert x.complexity() == 1.0
        assert transpose(x).complexity() == 1.5
        assert sum_expr([x, y]).complexity() == 2.0


class TestToString:
    def test_basic(self):
        assert x.to_string() == "x"
        assert number(0.5).to_string() == "0.5"
        assert number(2).to_string() == "2"

    def test_condensed_latex(self):
        e = product([number(0.5), transpose(x), Q, x])
        assert e.to_string(condensed=True) == "0.5 x^T Q x"
        assert diagonal_matrix(variable("s")).to_string(True) == "S"
        assert log(x).to_string(True) == "\\log(x)"
        assert invert(diagonal_matrix(variable("s"))).to_string(True) == \
            "S^{-1}"

    def test_non_condensed_parens(self):
        e = sum_expr([x, y])
        assert e.to_string() == "(x + y)"
        assert e.to_string(True) == "x + y"

    def test_negative_sum_rendering(self):
        e = sum_expr([x, negate(y)])
        assert e.to_string(True) == "x - y"
