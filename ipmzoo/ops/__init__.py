"""Device kernels: factorisations and solves."""

from ..utils.precision import apply_default_matmul_precision

apply_default_matmul_precision()

from .banded import (arrow_factor, arrow_solve, bt_factor, bt_solve,
                     cr_factor, cr_solve, detect_arrow)
from .ldlt import (PIVOT_FLOOR, batched_ldlt, batched_solve_ldlt,
                   cholesky_solve, ldlt, ldlt_solve, solve_ldlt)
from .ldlt_df import ldlt_df, ldlt_solve_df, solve_ldlt_df
from .sharded_ldlt import shard_kkt, sharded_ldlt, sharded_ldlt_solve

__all__ = ["PIVOT_FLOOR", "batched_ldlt", "batched_solve_ldlt",
           "cholesky_solve", "ldlt", "ldlt_solve", "solve_ldlt",
           "arrow_factor", "arrow_solve", "bt_factor", "bt_solve",
           "cr_factor", "cr_solve", "detect_arrow",
           "ldlt_df", "ldlt_solve_df", "solve_ldlt_df",
           "shard_kkt", "sharded_ldlt", "sharded_ldlt_solve"]
