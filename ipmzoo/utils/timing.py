"""Slope timing of device work.

A host clock around one call that ends in ``block_until_ready``
measures the work plus two constants: the host's dispatch of the
program and the synchronisation at the end.  On the GPU both are tens
of microseconds, as long as a short kernel itself, so a per-call time
overstates such kernels.  Two-point slope timing removes the constants:
enqueue ``k`` chained repetitions of the workload followed by ONE
transfer to the host, for two values of ``k``; the per-repetition device
time is the slope

    t_per_rep = (T(k2) - T(k1)) / (k2 - k1)

in which the dispatch and synchronisation constants cancel.  The
repetition counts auto-scale until the timing delta clears the host
clock's noise, so microsecond kernels are measured as accurately as
millisecond solves.  The benchmark's numbers are slope-timed.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np

#: wall-clock delta (s) the two-point measurement must reach before the
#: slope is trusted: well above the host clock's and the dispatcher's
#: jitter
MIN_DELTA = 0.02

#: repetition-count ceiling (runaway guard for sub-microsecond bodies)
MAX_REPS = 4096


def sync(tree) -> None:
    """Force completion of everything ``tree`` depends on by
    transferring its first leaf to the host in full (slicing would
    dispatch, and on first use compile, a fresh gather program).  The
    transfer's cost is constant across repetition counts, so slope
    timing cancels it."""
    leaves = jax.tree_util.tree_leaves(tree)
    if leaves:
        np.asarray(jax.device_get(leaves[0]))


def _slope(timed: Callable[[int], float], k1: int = 2, k2: int = 8,
           min_delta: float = MIN_DELTA, max_reps: int = MAX_REPS) -> float:
    """Auto-scaling two-point slope: grow k2 until the delta clears the
    noise floor (or the rep ceiling is hit)."""
    t1 = timed(k1)
    while True:
        t2 = timed(k2)
        if t2 - t1 >= min_delta or k2 >= max_reps:
            return max((t2 - t1) / (k2 - k1), 1e-12)
        k1, t1 = k2, t2
        k2 *= 4


def measure_chain(fn: Callable, init, *, trials: int = 3,
                  min_delta: float = MIN_DELTA) -> float:
    """Per-call device seconds for ``fn`` (an endofunction: out -> in).

    Chaining makes repetitions sequentially dependent so the device
    cannot overlap them.  ``min`` over ``trials`` rejects host-side
    scheduling noise."""

    def timed(k: int) -> float:
        best = float("inf")
        for _ in range(trials):
            x = init
            t0 = time.perf_counter()
            for _ in range(k):
                x = fn(x)
            sync(x)
            best = min(best, time.perf_counter() - t0)
        return best

    # warm: compile + one full sync so timing starts from an idle device
    x = fn(init)
    sync(x)
    return _slope(timed, min_delta=min_delta)


def measure_call(fn: Callable, *args, trials: int = 3,
                 min_delta: float = MIN_DELTA) -> float:
    """Per-call device seconds for ``fn(*args)`` (independent calls).

    The device executes enqueued programs serially, so back-to-back
    independent calls still measure true per-call time; the slope
    cancels dispatch + sync constants exactly as in
    :func:`measure_chain`."""

    def timed(k: int) -> float:
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            out = None
            for _ in range(k):
                out = fn(*args)
            sync(out)
            best = min(best, time.perf_counter() - t0)
        return best

    out = fn(*args)
    sync(out)
    return _slope(timed, min_delta=min_delta)
