#!/usr/bin/env python
"""Profile one batched solve (BASELINE config 4) on the GPU and reduce
the trace to the device's busy and idle time and its top kernels.

    python tools/trace_batched.py [out_dir]      # default .trace

Compiles and runs ``CompiledIPM.solve_batch_compact`` on the 10,240 QPs
once, then traces a second call with ``jax.profiler``.  Busy time is the
union of the kernel intervals on the device's stream lines; the idle
share is 1 - busy / (last kernel end - first kernel start).  Kernels
are grouped by name and ranked by summed device time.
"""

from __future__ import annotations

import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stream_events(plane):
    """(name, start_ns, end_ns) of the kernels on a device plane: the
    events of its 'Stream' lines, or of every line but the XLA module and
    op summaries if it has none."""
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    if not streams:
        streams = [ln for ln in lines
                   if ln.name not in ("XLA Modules", "XLA Ops", "Steps")]
    return [(ev.name, ev.start_ns, ev.start_ns + ev.duration_ns)
            for ln in streams for ev in ln.events]


def reduce_trace(path: str, top: int = 15) -> dict:
    """Busy/idle share and top kernels of the first GPU plane in the
    ``.xplane.pb`` at ``path``."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(f"no GPU plane in {path}: "
                         f"{[p.name for p in pd.planes]}")
    evs = sorted(_stream_events(planes[0]), key=lambda e: e[1])
    if not evs:
        raise SystemExit("no kernel ran on the device in the traced window")
    busy, cur_s, cur_e = 0.0, evs[0][1], evs[0][2]
    for _, s, e in evs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, _, e in evs) - evs[0][1]
    per = collections.Counter()
    count = collections.Counter()
    for name, s, e in evs:
        per[name] += e - s
        count[name] += 1
    return {"span_s": span * 1e-9, "busy_s": busy * 1e-9,
            "idle_share": 1.0 - busy / span, "kernels": len(evs),
            "top": [(name, per[name] * 1e-9, count[name])
                    for name, _ in per.most_common(top)]}


def main():
    import jax
    import jax.numpy as jnp
    from bench import make_batch
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM

    out = sys.argv[1] if len(sys.argv) > 1 else ".trace"
    data = make_batch(10240, 16, 8, jnp.float32)
    solver = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float32,
                         tol=1e-6)
    jax.block_until_ready(solver.solve_batch_compact(data))
    with jax.profiler.trace(out):
        t0 = time.perf_counter()
        jax.block_until_ready(solver.solve_batch_compact(data))
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    r = reduce_trace(path)
    print(f"{jax.devices()[0].device_kind}: traced solve {wall:.4f} s "
          f"(host clock, profiler on); device span {r['span_s']:.4f} s, "
          f"busy {r['busy_s']:.4f} s, idle share {r['idle_share']:.3f}, "
          f"{r['kernels']} kernels")
    for name, t, c in r["top"]:
        print(f"  {t * 1e3:9.3f} ms  {c:6d}x  {name[:110]}")


if __name__ == "__main__":
    main()
