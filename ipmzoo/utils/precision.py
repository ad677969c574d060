"""Default matmul precision policy for the library.

On the GPU, XLA may run an f32 ``dot``/``conv`` at its DEFAULT
precision in TF32 on the tensor cores, which keeps about three decimal
digits (relative error ~1e-3).  For an interior-point library whose
convergence tests assert duality gaps of 1e-6..1e-8, silently computing
every KKT assembly, residual, and factorisation matmul to 1e-3 is wrong:
the Pallas kernels (exact f32 elementwise arithmetic) would disagree
with the XLA engines, and the XLA full-solve paths could never reach
the pinned f32 floor on the card.

Importing any jax-touching subpackage of ipmzoo therefore pins
``jax_default_matmul_precision`` to ``highest`` (``chip_smoke.py``
checks on the card that an f32 product then agrees with the f64 one to
1e-5).  Callers who want the throughput-over-accuracy trade-off back
(e.g. embedding these ops inside a bf16 training step) can either set
the environment variable ``IPMZOO_MATMUL_PRECISION`` to ``default`` /
``bfloat16`` / ... before importing, or re-update the jax config after
import — this module only sets the global default, it never wraps
individual calls.

The reference implementation has no analogue: its CPU doubles
(the reference's src/NumericalOptimization/Evaluation.cpp) are always
exact-precision.  This is the device port of that guarantee.
"""

from __future__ import annotations

import os

import jax

_APPLIED = False


def apply_default_matmul_precision() -> None:
    """Pin ``jax_default_matmul_precision`` (idempotent, env-overridable).

    Runs once per process; respects an explicit user choice made either
    through ``IPMZOO_MATMUL_PRECISION`` or by having already set the jax
    config themselves (a non-None existing value is left alone).
    """
    global _APPLIED
    if _APPLIED:
        return
    _APPLIED = True
    want = os.environ.get("IPMZOO_MATMUL_PRECISION", "highest").lower()
    if want in ("", "default", "none"):
        return
    if jax.config.jax_default_matmul_precision is not None:
        return  # the user already chose; don't fight them
    try:
        jax.config.update("jax_default_matmul_precision", want)
    except Exception as e:  # unrecognized value (e.g. a typo in the env
        # var) must not turn into an import crash of the whole library
        import warnings
        warnings.warn(
            f"IPMZOO_MATMUL_PRECISION={want!r} not accepted by jax "
            f"({e}); leaving the matmul precision at its default",
            stacklevel=2)
