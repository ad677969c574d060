#!/usr/bin/env python
"""Time the batched Pallas LDL^T kernels against the plain XLA path on
the GPU, and the batched IPM solve end to end with each.

    python tools/ldlt_kernel_probe.py [--tiles 32:4,64:1] [--e2e]

For each shape (B instances of order n) and each tile (instances per
program : warps per program) it checks the kernel against the f64 reference (ops/ldlt.py) and prints
the median device time per call of

* factor:  Pallas ``batched_ldlt_pallas`` vs vmapped ``ldlt``;
* solve:   1-rhs Pallas solve vs vmapped ``solve_ldlt``.

``--e2e`` then sets each kernel's fastest tile at the first shape and
times ``CompiledIPM.solve_batch_compact`` on the 10,240 QPs of BASELINE
config 4 in turns: with the Pallas factor and solve
(``kernel='auto'``), with the Pallas factor and the XLA solve, and with
the plain path (``kernel='jnp'``).  Times are host wall clock
around calls that end in ``block_until_ready``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def time_call(fn, *args, reps: int = 20) -> float:
    """Median seconds per call (first call excluded: it compiles)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def qd_batch(B: int, n: int, seed: int = 0) -> np.ndarray:
    """Random quasi-definite [[H, A^T], [A, -S]] matrices, n1 = 2n/3."""
    rng = np.random.default_rng(seed)
    n1 = max(1, (2 * n) // 3)
    n2 = n - n1
    H = rng.normal(size=(B, n1, n1))
    H = H @ np.swapaxes(H, 1, 2) + n1 * np.eye(n1)
    S = rng.normal(size=(B, n2, n2))
    S = S @ np.swapaxes(S, 1, 2) + n2 * np.eye(n2)
    A = rng.normal(size=(B, n2, n1))
    top = np.concatenate([H, np.swapaxes(A, 1, 2)], axis=2)
    bot = np.concatenate([A, -S], axis=2)
    return np.concatenate([top, bot], axis=1)


def probe_shape(B: int, n: int, tiles):
    """Returns {tile: {op: seconds}} of the Pallas kernels."""
    from ipmzoo.ops import pallas_ldlt as P
    from ipmzoo.ops.ldlt import ldlt, solve_ldlt

    A64 = qd_batch(B, n)
    rng = np.random.default_rng(1)
    b64 = rng.normal(size=(B, n))
    A, b = (jnp.asarray(x, jnp.float32) for x in (A64, b64))

    xfac = jax.jit(jax.vmap(lambda a: ldlt(a)))
    xsol = jax.jit(jax.vmap(solve_ldlt))
    L, D = xfac(A)
    with jax.enable_x64(True):               # f64 reference on the card
        Dr = np.asarray(jax.vmap(lambda a: ldlt(a))(jnp.asarray(A64))[1])
    t_x = {"factor": time_call(xfac, A), "solve": time_call(xsol, L, D, b)}
    print(f"B={B} n={n} xla: " + ", ".join(
        f"{kk} {v * 1e6:.1f} us" for kk, v in t_x.items()), flush=True)
    out = {}
    for tile in tiles:
        P.FACTOR_TILE = P.SOLVE_TILE = tile
        pfac = jax.jit(P.batched_ldlt_pallas)
        psol = jax.jit(P.batched_solve_ldlt_pallas)
        try:
            Lp, Dp = pfac(A)
            x = psol(Lp, Dp, b)
        except Exception as e:  # report and go on with the next block
            print(f"  tile={tile}: FAILED {type(e).__name__}: {e}"[:3000],
                  flush=True)
            continue
        d_err = float(np.max(np.abs(np.asarray(Dp) - Dr) / np.abs(Dr)))
        res = float(np.max(np.abs(np.einsum(
            "bij,bj->bi", A64, np.asarray(x, np.float64)) - b64))
            / np.max(np.abs(b64)))
        t_p = {"factor": time_call(pfac, A),
               "solve": time_call(psol, Lp, Dp, b)}
        out[tile] = t_p
        print(f"  tile={tile}: D rel err {d_err:.2e}, residual "
              f"{res:.2e}; pallas: " +
              ", ".join(f"{kk} {v * 1e6:.1f} us ({t_x[kk] / v:.2f}x)"
                        for kk, v in t_p.items()), flush=True)
    return out


def probe_e2e(rounds: int = 2):
    from bench import make_batch
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    from ipmzoo.ops import routes
    data = make_batch(10240, 16, 8, jnp.float32)
    variants = {"pallas factor+solve": ("auto", ("factor", "solve")),
                "pallas factor, xla solve": ("auto", ("factor",)),
                "xla (kernel=jnp)": ("jnp", ())}
    solvers = {}
    for name, (kern, ops) in variants.items():
        routes.PALLAS_OPS = ops          # read while the solve traces
        s = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float32,
                        tol=1e-6, kernel=kern)
        t0 = time.perf_counter()
        res = jax.block_until_ready(s.solve_batch_compact(data))
        conv = float(jnp.mean(res.converged.astype(jnp.float32)))
        its = int(jnp.sum(res.iterations))
        print(f"e2e {name}: first call {time.perf_counter() - t0:.1f} s,"
              f" converged {conv:.5f}, iterations {its}", flush=True)
        solvers[name] = s
    names = list(solvers)
    order = (names + names[::-1]) * rounds
    ts = {k: [] for k in solvers}
    for kern in order:
        s = solvers[kern]
        t0 = time.perf_counter()
        jax.block_until_ready(s.solve_batch_compact(data))
        ts[kern].append(time.perf_counter() - t0)
    for k, v in ts.items():
        print(f"e2e {k}: solve s {[round(x, 5) for x in v]} "
              f"median {np.median(v):.5f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", default="32:4,32:1,64:1,128:1,64:2,128:4")
    ap.add_argument("--shapes", default="10240x24,512x64")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    print(f"jax {jax.__version__}, {jax.devices()[0].platform}, "
          f"{jax.devices()[0].device_kind}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tiles = [tuple(int(v) for v in t.split(":"))
             for t in args.tiles.split(",")]
    first = None
    for shp in args.shapes.split(","):
        B, n = (int(x) for x in shp.split("x"))
        res = probe_shape(B, n, tiles)
        first = res if first is None else first
    if args.e2e and first:
        from ipmzoo.ops import pallas_ldlt as P
        P.FACTOR_TILE = min(first, key=lambda t: first[t]["factor"])
        P.SOLVE_TILE = min(first, key=lambda t: first[t]["solve"])
        print(f"e2e tiles: factor {P.FACTOR_TILE}, solve {P.SOLVE_TILE}",
              flush=True)
        probe_e2e()


if __name__ == "__main__":
    main()
