"""IPM formulation lattice: which constraints exist and how they are slacked.

Mirrors the reference formulation space (Bounds x InequalityHandling x
EqualityHandling x problem stage; /root/reference/include/
SymbolicOptimization.h:28-64) so every derivation the reference can produce,
this framework can produce — and then lower to a device program.
"""

from __future__ import annotations

import dataclasses
import enum


class Bounds(enum.Enum):
    NONE = "none"
    LOWER = "lower"
    UPPER = "upper"
    BOTH = "both"

    @property
    def has_lower(self) -> bool:
        return self in (Bounds.LOWER, Bounds.BOTH)

    @property
    def has_upper(self) -> bool:
        return self in (Bounds.UPPER, Bounds.BOTH)


class InequalityHandling(enum.Enum):
    #: A x - s = 0 with box bounds kept on the slack s.
    SLACKS = "slacks"
    #: A x - s = 0, then s - g = l, s + h = u with nonnegative slacks g, h.
    SLACKED_SLACKS = "slacked_slacks"
    #: A x - g = l, A x + h = u directly, with nonnegative slacks g, h.
    NAIVE_SLACKS = "naive_slacks"


class EqualityHandling(enum.Enum):
    NONE = "none"
    SLACKS = "slacks"
    SLACKED_SLACKS = "slacked_slacks"
    NAIVE_SLACKS = "naive_slacks"
    #: quadratic penalty (1/2 mu^-1) ||Cx - d||^2 added to the objective
    PENALTY_FUNCTION = "penalty_function"
    #: penalty reformulated with an explicit dual: Cx - d - (mu/2) lambda = 0
    PENALTY_FUNCTION_WITH_EXTRA_DUAL = "penalty_function_with_extra_dual"
    #: proximal regularization: objective + 1/2 p^T p, Cx - d + delta p = 0
    REGULARIZATION = "regularization"


class ProblemStage(enum.Enum):
    """Which stage of the derivation pipeline a problem object represents."""
    ORIGINAL = "original"
    SLACKED = "slacked"
    SLACKED_WITH_BARRIERS = "slacked_with_barriers"
    FOR_OPTIMALITY_CONDITIONS = "for_optimality_conditions"


@dataclasses.dataclass(frozen=True)
class Settings:
    """A point in the formulation lattice."""
    inequalities: Bounds = Bounds.BOTH
    variable_bounds: Bounds = Bounds.BOTH
    equalities: bool = False
    equality_handling: EqualityHandling = EqualityHandling.NONE
    inequality_handling: InequalityHandling = InequalityHandling.SLACKED_SLACKS


@dataclasses.dataclass(frozen=True)
class VariableNames:
    """Symbol names used in derivations (LaTeX fragments allowed)."""
    x: str = "x"
    A_eq: str = "C"
    b_eq: str = "d"
    p_eq: str = "p"
    delta_eq: str = "\\delta"
    A_ineq: str = "A"
    s_A_ineq: str = "s"
    s_A_ineq_l: str = "g"
    s_A_ineq_u: str = "h"
    s_x_l: str = "y"
    s_x_u: str = "z"
    s_A_eq: str = "t"
    s_A_eq_l: str = "v"
    s_A_eq_u: str = "w"
    l_A_ineq: str = "l_A"
    u_A_ineq: str = "u_A"
    l_x: str = "l_x"
    u_x: str = "u_x"
    Q: str = "Q"
    c: str = "c"
