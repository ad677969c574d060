"""Symbolic expression IR: interned DAGs, differentiation, simplification.

This package is the trace-time front half of the framework: it derives
KKT/Newton systems symbolically; :mod:`ipmzoo.models` stages them into
XLA programs.
"""

from .expr import (Expr, Kind, ZERO, UNITY, clear_caches, diagonal_matrix,
                   format_number, intern_cache_size, invert, is_diagonal,
                   is_invert, is_log, is_matrix, is_named_leaf,
                   is_named_scalar, is_named_vector, is_negate, is_number,
                   is_product, is_sum, is_symmetric_matrix, is_transpose,
                   is_variable, log, matrix, named_scalar, named_vector,
                   negate, number, product, sum_expr, symmetric_matrix,
                   transpose, variable)

__all__ = [
    "Expr", "Kind", "ZERO", "UNITY", "clear_caches", "diagonal_matrix",
    "format_number", "intern_cache_size", "invert", "is_diagonal",
    "is_invert", "is_log", "is_matrix", "is_named_leaf", "is_named_scalar",
    "is_named_vector", "is_negate", "is_number", "is_product", "is_sum",
    "is_symmetric_matrix", "is_transpose", "is_variable", "log", "matrix",
    "named_scalar", "named_vector", "negate", "number", "product",
    "sum_expr", "symmetric_matrix", "transpose", "variable",
]
