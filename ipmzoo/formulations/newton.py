"""KKT conditions, symbolic Newton systems, and block reductions.

Pipeline (mirrors /root/reference/src/SymbolicOptimization.cpp:359-567):

  first-order conditions:  dL/dv for every variable, with barrier-gradient
      rows premultiplied by diag(v) to become complementarity rows
      ``diag(v) dL - mu e``; unslacked bounds get explicit dual rows
      ``(diag(x) - diag(l)) lambda - mu e``.
  newton system:           lhs[i][j] = d c_i / d v_j, rhs = -c_i.
  augmented system:        eliminate trailing rows while the leading row's
      scan shows them reducible (entries in {0, 1, -1}), recording
      back-substitution formulas (delta definitions).
  normal equations:        additionally eliminate the leading (Q) block,
      leaving the condensed system.

The output of this module is the *lowering artifact* for the solver:
block structure, elimination order and back-substitution formulas that
:mod:`ipmzoo.models.codegen` stages into a jitted iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..symbolic import expr as E
from ..symbolic.expr import Expr
from .problem import Problem, build_problem, build_symbols, lagrangian
from .settings import (EqualityHandling, ProblemStage, Settings,
                       VariableNames)


def delta_variable(var: Expr) -> Expr:
    assert E.is_variable(var)
    return E.variable("\\Delta " + var.to_string())


@dataclasses.dataclass
class NewtonSystem:
    lhs: list              # list[list[Expr]] square symbolic block matrix
    rhs: list              # list[Expr]
    variables: list        # list[Expr] column variables
    delta_definitions: list  # list[(delta_var, definition Expr)]

    def copy(self) -> "NewtonSystem":
        return NewtonSystem([row[:] for row in self.lhs], self.rhs[:],
                            self.variables[:], self.delta_definitions[:])


@dataclasses.dataclass
class ShorthandRhs:
    shorthand_rhs: list       # list[Expr]: -r_{var} symbols
    vector_definitions: list  # list[(r_vec symbol, definition Expr)]


def first_order_conditions(settings: Settings,
                           names: VariableNames = VariableNames()):
    """Return (conditions, variables) of the barrier problem's KKT system."""
    if settings.equality_handling == EqualityHandling.PENALTY_FUNCTION:
        settings = dataclasses.replace(
            settings,
            equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL)
    problem = build_problem(settings, names,
                            ProblemStage.FOR_OPTIMALITY_CONDITIONS)
    lag = lagrangian(problem)
    variables = problem.all_variables()

    conditions = []
    for v in variables:
        d = lag.differentiate(v).simplify()
        inv_v = E.invert(E.diagonal_matrix(v))
        if d.contains(inv_v):
            # Barrier-gradient row: premultiply by diag(v) to get the
            # complementarity form diag(v) dL - mu e.
            d = E.product([E.diagonal_matrix(v), d]).simplify()
        conditions.append(d)

    # Unslacked bounds: add explicit complementarity rows for their duals.
    o = build_symbols(names)
    for b in problem.variable_bounds:
        assert b.lower_dual is not None or b.upper_dual is not None
        e_vec = (o.e_var if b.expr is o.x
                 else o.e_ineq if b.expr is o.s_A_ineq else o.e_eq)
        if b.lower is not None:
            assert b.lower_dual is not None
            conditions.append(
                E.product([E.diagonal_matrix(b.expr) -
                           E.diagonal_matrix(b.lower), b.lower_dual]) -
                E.product([o.mu, e_vec]))
            variables.append(b.lower_dual)
        if b.upper is not None:
            assert b.upper_dual is not None
            conditions.append(
                E.product([E.diagonal_matrix(b.upper) -
                           E.diagonal_matrix(b.expr), b.upper_dual]) -
                E.product([o.mu, e_vec]))
            variables.append(b.upper_dual)

    return conditions, variables


def newton_system(settings: Settings,
                  names: VariableNames = VariableNames()) -> NewtonSystem:
    """The full symbolic Newton system: Jacobian of the KKT conditions."""
    conditions, variables = first_order_conditions(settings, names)
    lhs, rhs = [], []
    for c in conditions:
        lhs.append([c.differentiate(v).simplify() for v in variables])
        rhs.append(E.negate(c).simplify())
    return NewtonSystem(lhs, rhs, list(variables), [])


def _augmented_size(lhs: list) -> int:
    """Scan the first row for the first reducible entry (0, 1 or -1)."""
    neg_unity = E.negate(E.UNITY)
    reducible = {E.ZERO, E.UNITY, neg_unity}
    i = 0
    while i < len(lhs) and lhs[0][i] not in reducible:
        i += 1
    return i


def delta_definition(lhs: list, rhs: list, variables: list,
                     source_row: int) -> Expr:
    """Back-substitution formula for the variable eliminated at source_row:
    Delta v = (lhs[r][r])^-1 (rhs[r] - sum_j lhs[r][j] Delta v_j)."""
    row = lhs[source_row]
    source_expr = row[source_row]
    terms = [E.product([row[i], delta_variable(variables[i])])
             for i in range(len(row))]
    del terms[source_row]
    s = E.sum_expr(terms)
    return E.product([E.invert(source_expr),
                      E.sum_expr([rhs[source_row], E.negate(s)])]).simplify()


def gaussian_elimination(lhs: list, rhs: list, source_row: int) -> None:
    """Symbolically eliminate source_row/column in place."""
    n = len(lhs)
    assert len(rhs) == n and source_row < n
    targets = [i for i in range(n)
               if i != source_row and lhs[i][source_row] is not E.ZERO]
    assert targets, "nothing to eliminate"
    source = lhs[source_row]
    source_expr = source[source_row]
    for t in targets:
        target = lhs[t]
        factor = E.product([E.negate(target[source_row]),
                            E.invert(source_expr)]).simplify()

        def weighted_add(src: Expr, tgt: Expr) -> Expr:
            fs = E.product([factor, src]).simplify()
            return E.sum_expr([tgt, fs]).simplify()

        for i in range(len(source)):
            target[i] = weighted_add(source[i], target[i])
        rhs[t] = weighted_add(rhs[source_row], rhs[t])

    del lhs[source_row]
    for row in lhs:
        del row[source_row]
    del rhs[source_row]


def augmented_system(ns: NewtonSystem) -> NewtonSystem:
    """Eliminate trailing complementarity/slack rows down to the augmented
    (quasi-definite) system, recording back-substitution formulas."""
    ns = ns.copy()
    size = _augmented_size(ns.lhs)
    while len(ns.lhs) > size:
        last = len(ns.lhs) - 1
        dvar = delta_variable(ns.variables[last])
        ddef = delta_definition(ns.lhs, ns.rhs, ns.variables, last)
        ns.delta_definitions.append((dvar, ddef))
        gaussian_elimination(ns.lhs, ns.rhs, last)
        ns.variables.pop()
    return ns


def normal_equations(ns: NewtonSystem) -> NewtonSystem:
    """Continue elimination past the augmented system, removing the leading
    (x) block to reach the condensed normal-equations system."""
    ns = augmented_system(ns)
    if len(ns.lhs) > 1:
        dvar = E.variable("\\Delta " + ns.variables[0].to_string())
        ddef = delta_definition(ns.lhs, ns.rhs, ns.variables, 0)
        ns.delta_definitions.append((dvar, ddef))
        gaussian_elimination(ns.lhs, ns.rhs, 0)
        ns.variables.pop(0)
    return ns


def shorthand_rhs(ns: NewtonSystem) -> ShorthandRhs:
    """Replace each rhs entry with -r_{var}, recording r definitions."""
    assert len(ns.variables) == len(ns.rhs)
    out = ShorthandRhs([], [])
    for var, rhs in zip(ns.variables, ns.rhs):
        vec = E.named_vector("r_{" + var.to_string() + "}")
        out.shorthand_rhs.append(E.negate(vec))
        out.vector_definitions.append((vec, E.negate(rhs).simplify()))
    return out
