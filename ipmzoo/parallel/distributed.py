"""Multi-host initialisation and elastic-run helpers.

On a multi-host cluster every host runs the same program; call
:func:`initialize` once at startup and every mesh construction in
:mod:`.mesh` then spans the global device set, with XLA routing
collectives over ICI within a slice and DCN across slices.  The
reference framework is strictly single-process (SURVEY §2.5); this
module is the framework's launcher surface.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialise jax.distributed (no-op when single-process).

    With no arguments, relies on the cluster environment's auto-detection
    (GCE metadata / megascale env vars); arguments override for manual
    launches (e.g. CPU multi-process testing).
    """
    import jax
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_primary() -> bool:
    import jax
    return jax.process_index() == 0


def local_batch_slice(global_batch: int):
    """The [start, stop) slice of a globally sharded batch that this
    process should materialise (for per-host data loading)."""
    import jax
    per = global_batch // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)
