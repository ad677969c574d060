"""ipmzoo — a symbolic + numerical interior-point-method
framework for convex quadratic programming.

Capabilities (re-designed for accelerators from the reference
albfre/ipm-zoo):

* :mod:`ipmzoo.symbolic` — interned expression IR with differentiation
  and simplification (trace-time, pure Python).
* :mod:`ipmzoo.formulations` — the IPM formulation lattice: slacked
  problems, Lagrangians, KKT conditions, Newton systems and their block
  reductions (augmented system, normal equations).
* :mod:`ipmzoo.models` — staging of derived systems into jitted XLA
  programs: the Mehrotra predictor-corrector solver as a
  ``lax.while_loop`` with zero per-iteration host round-trips.
* :mod:`ipmzoo.ops` — device kernels: dense/batched LDL^T and
  Cholesky factorisation (jnp reference + Pallas GPU kernels).
* :mod:`ipmzoo.native` — C++ host tier: LDL^T and Bunch-Kaufman
  reference solvers via a ctypes-loaded shared library.
* :mod:`ipmzoo.parallel` — batched (vmap/shard_map) and
  block-separable (Schur complement) multi-chip solving over a
  ``jax.sharding.Mesh``.
* :mod:`ipmzoo.frontend` — CLI demos and LaTeX/web emitters of the
  derivations.
"""

__version__ = "0.1.0"

# Convenience top-level API: the names a user needs for the common path.
from .formulations import (Bounds, EqualityHandling,  # noqa: E402
                           InequalityHandling, Settings, VariableNames)


def __getattr__(name):
    # heavier imports (jax) stay lazy so `import ipmzoo` is instant
    if name in ("CompiledIPM", "QPData", "SolveResult", "IPMState",
                "RiccatiIPM", "MPCData", "MPCSolveResult",
                "ArrowIPM", "ArrowQPData", "ArrowSolveResult"):
        from . import models
        return getattr(models, name)
    if name == "SchurIPM":
        from .parallel.schur import SchurIPM
        return SchurIPM
    raise AttributeError(name)
