#!/usr/bin/env python
"""Measure the nd-vs-dense crossover on 2D-grid QPs.

For each grid side g: build the grid QP, time one IPM step under
kernel='nd' (nd_fallback=False) and under the dense auto kernel — both
INSIDE a compiled fori_loop, slope over two trip counts (cancels the
once-per-solve nd prework and the program-launch floor), nd/dense
rounds interleaved, median of 3 — and print the measured speedup next
to the cost model's prediction (ops/ndiss.py::nd_predicted_speedup)
plus the plan stats the model is fitted from.  Finally print the
model's five constants fitted to these times by non-negative least
squares on relative error:

    python tools/nd_crossover.py [g1 g2 ...]       # default 16 24 32 48 64
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def loop_pair(s, data, k1=2, k2=8):
    from jax import lax
    from ipmzoo.utils.timing import measure_call
    stepf = s._step_impl
    pre_fn = getattr(s, "_nd_prework", None)

    def make(K):
        @jax.jit
        def k_steps(state):
            pre = pre_fn(data) if (pre_fn is not None and
                                   s._mode == "nd") else None
            return lax.fori_loop(
                0, K, lambda i, st: stepf(st, data, nd_pre=pre), state)
        return k_steps

    f1, f2 = make(k1), make(k2)
    state = s.init_state(data)
    measure_call(f1, state)
    measure_call(f2, state)
    return lambda: (measure_call(f2, state) -
                    measure_call(f1, state)) / (k2 - k1)


def main():
    sides = [int(a) for a in sys.argv[1:]] or [16, 24, 32, 48, 64]
    from ipmzoo.models import CompiledIPM
    from ipmzoo.models.families import grid_qp
    from ipmzoo.ops.ndiss import nd_predicted_speedup

    print(f"backend={jax.default_backend()}, "
          f"{jax.devices()[0].device_kind}", flush=True)
    rows = []
    for g in sides:
        n = g * g
        fam = grid_qp(side=g, seed=0, dtype=jnp.float32)
        data = fam.data
        nd = CompiledIPM(fam.settings, n=n, dtype=jnp.float32, tol=1e-5,
                         kernel="nd", nd_leaf=64, nd_fallback=False)
        nd._ensure_nd_plan(data)
        plan = nd._nd_plan
        dense = CompiledIPM(fam.settings, n=n, dtype=jnp.float32,
                            tol=1e-5)
        nd_t = loop_pair(nd, data)
        dn_t = loop_pair(dense, data)
        ts_n, ts_d = [], []
        for _ in range(3):
            ts_n.append(nd_t())
            ts_d.append(dn_t())
        t_nd = float(np.median(ts_n))
        t_dense = float(np.median(ts_d))

        print(f"g={g:3d} n={n:5d}: nd {t_nd * 1e3:7.3f} ms "
              f"({len(plan.levels)} levels, flops_nd="
              f"{plan.flops_nd:.3e}) vs dense {t_dense * 1e3:7.3f} ms "
              f"= {t_dense / t_nd:5.2f}x "
              f"(model predicts {nd_predicted_speedup(plan):5.2f}x)",
              flush=True)
        rows.append((n, len(plan.levels), plan.flops_nd, t_nd, t_dense))
    fit(rows)


def fit(rows):
    """Fit t_nd = T_LEVEL*levels + 2*flops/RATE and t_dense = FLOOR +
    A n^2 + B n^3 by NNLS, each row scaled by 1/t (relative error)."""
    from scipy.optimize import nnls
    n, lev, fl, t_nd, t_de = (np.asarray(c, np.float64) for c in zip(*rows))
    (t_level, inv_rate), _ = nnls(
        np.stack([lev, 2 * fl], 1) / t_nd[:, None], np.ones_like(t_nd))
    (floor, a, b), _ = nnls(
        np.stack([np.ones_like(n), n ** 2, n ** 3], 1) / t_de[:, None],
        np.ones_like(t_de))
    print(f"fit: ND_T_LEVEL = {t_level:.3g}, ND_FLOP_RATE = "
          f"{1 / inv_rate if inv_rate else float('inf'):.3g}, "
          f"DENSE_T_FLOOR = {floor:.3g}, DENSE_A = {a:.3g}, "
          f"DENSE_B = {b:.3g}", flush=True)


if __name__ == "__main__":
    main()
