"""Where each batched factorisation runs: the one place that knows the
platform.

The engines (the batched :class:`~ipmzoo.models.ipm.CompiledIPM`
factor, nested-dissection levels, Schur blocks, the arrow reduction)
ask this module instead of testing ``jax.default_backend()``
themselves.

* ``gpu``: the batched LDL^T runs as the Pallas kernel compiled through
  Triton (:mod:`.pallas_ldlt`) up to :data:`PALLAS_MAX_DIM`; above it,
  and on every other platform, as the plain vmapped XLA path.
* A Pallas kernel runs on another platform only when the caller asks
  for ``interpret=True`` (the tests do); asking for it on such a
  platform without ``interpret`` is an error, never a silent
  interpreter run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax

#: platforms that have a compiled Pallas kernel
KERNEL_PLATFORMS = ("gpu",)
#: largest matrix order the Pallas LDL^T takes under 'auto': on the
#: card it won at n = 24 (padded to 32) and was no faster at n = 64
#: (PERF.md, "Kernel decisions on H100")
PALLAS_MAX_DIM = 32
#: the batched operations ('factor', 'solve' with one rhs) 'auto' runs
#: as Pallas kernels on the GPU
PALLAS_OPS = ("factor", "solve")

_PALLAS = ("pallas", "pl")
_XLA = ("jnp", "xla")


class Route(NamedTuple):
    kernel: str          # "pallas" | "xla"
    interpret: bool = False


def batched_ldlt_route(requested: str, n: int, op: str = "factor", *,
                       interpret: bool = False,
                       platform: Optional[str] = None) -> Route:
    """Resolve a request for the batched LDL^T operation ``op`` (one of
    :data:`PALLAS_OPS`) on matrices of order ``n`` to a :class:`Route`.

    ``requested``: 'auto', 'pallas' (alias 'pl') or 'jnp' (alias
    'xla').  ``platform`` defaults to ``jax.default_backend()``."""
    if op not in ("factor", "solve"):
        raise ValueError(f"unknown batched LDL^T operation {op!r}")
    platform = platform or jax.default_backend()
    if requested in _XLA:
        return Route("xla")
    if requested == "auto":
        if interpret:
            return Route("pallas", True)
        ok = (platform in KERNEL_PLATFORMS and n <= PALLAS_MAX_DIM
              and op in PALLAS_OPS)
        return Route("pallas" if ok else "xla")
    if requested not in _PALLAS:
        raise ValueError(f"unknown kernel request {requested!r}; expected "
                         "'auto', 'pallas'/'pl' or 'jnp'/'xla'")
    if interpret:
        return Route("pallas", True)
    if platform not in KERNEL_PLATFORMS:
        raise ValueError(
            f"no compiled Pallas kernel on platform {platform!r} (have: "
            f"{KERNEL_PLATFORMS}); pass interpret=True to run the kernel "
            "in the Pallas interpreter")
    return Route("pallas")


def arrow_method(requested: str, n_blocks: int) -> str:
    """Banded engine of the arrow factorisation: 'auto' is cyclic
    reduction ('cr') from 8 blocks up, the sequential scan below."""
    if requested == "auto":
        return "cr" if n_blocks >= 8 else "scan"
    if requested not in ("cr", "scan"):
        raise ValueError(f"unknown arrow method {requested!r}; expected "
                         "'auto', 'cr' or 'scan'")
    return requested
