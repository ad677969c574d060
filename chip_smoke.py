#!/usr/bin/env python
"""Bring-up check: the batched QP solve and its kernels on the GPU.

    python chip_smoke.py                # one card, phases 1-5
    python chip_smoke.py --four-cards   # the paths across 4 cards only

Phases, in order, in this one process (each check prints its error
beside its limit; the first miss ends the run with a non-zero exit):

1. device: a GPU is present; its name, power limit, the matmul
   precision in force and the compile-cache directory; an f32 matrix
   product agrees with the f64 one (no TF32).
2. kernel: the batched Pallas LDL^T factor and solve (ops/pallas_ldlt.py)
   at B = 10,240 x n = 24 and B = 512 x n = 64 against ops/ldlt.py in
   f64 on the card.
3. main path: BASELINE config 4 (10,240 QPs, n = 16, m_ineq = 8, f32,
   tol 1e-6) through ``CompiledIPM.solve_batch_compact``; 64 instances
   against SciPy in f64 on the host.
4. dense path: BASELINE config 3 (16 QPs, n = 1024, m = 128, f32, tol
   1e-5) against the same problems solved in f64 on the card.
5. Schur path: ``bench_schur``'s problem (8 x 64 blocks of n = 64,
   m_c = 16, f32, tol 1e-8) against an f64 solve on the card.

``--four-cards`` runs the dp-sharded batch, the Schur solve over a mesh
and the row-sharded ``kernel='sharded'`` IPM on four cards, each against
its one-card solve.  The last line of standard output is the JSON
object ``{"ok": true, "device": {...}}``; it is printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

#: the SciPy reference's instances out of phase 3's batch
N_REFERENCE = 64


def check(name: str, value: float, limit: float) -> None:
    """Print ``value`` beside its limit; end the run if it misses."""
    print(f"  {name}: {value:.3e} (limit {limit:.0e})", flush=True)
    if not value <= limit:
        raise SystemExit(f"chip_smoke: {name} = {value:.3e} exceeds "
                         f"{limit:.0e}")


def require_gpu():
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX sees {backend!r}")
    return jax.devices()


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str):
    import jax
    import jax.numpy as jnp
    devs = require_gpu()
    print(f"phase 1 device: {devs[0].device_kind} x{len(devs)}, "
          f"jax {jax.__version__}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"  card: {card}")
    print(f"  matmul precision: {jax.config.jax_default_matmul_precision}")
    print(f"  compile cache: {cache_dir}")
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 1024, 1024))
    p32 = jnp.asarray(a, jnp.float32) @ jnp.asarray(b, jnp.float32)
    p64 = jnp.asarray(a) @ jnp.asarray(b)
    err = float(jnp.max(jnp.abs(p32 - p64)) / jnp.max(jnp.abs(p64)))
    check("f32 vs f64 matmul, max rel error", err, 1e-5)
    return devs


# ---------------------------------------------------------------------------
# phase 2: the batched LDL^T kernels
# ---------------------------------------------------------------------------

def qd_batch(B: int, n1: int, n2: int, seed: int = 0) -> np.ndarray:
    """Random quasi-definite [[H, A^T], [A, -S]] matrices, H and S
    positive definite (the construction of tests/test_pallas_kernels.py,
    vectorised over the batch)."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(B, n1, n1))
    H = H @ np.swapaxes(H, 1, 2) + n1 * np.eye(n1)
    S = rng.normal(size=(B, n2, n2))
    S = S @ np.swapaxes(S, 1, 2) + n2 * np.eye(n2)
    A = rng.normal(size=(B, n2, n1))
    return np.concatenate(
        [np.concatenate([H, np.swapaxes(A, 1, 2)], axis=2),
         np.concatenate([A, -S], axis=2)], axis=1)


def phase_kernel(shapes=((10240, 16, 8), (512, 48, 16))):
    import jax
    import jax.numpy as jnp
    from ipmzoo.ops.ldlt import ldlt, solve_ldlt
    from ipmzoo.ops.pallas_ldlt import (batched_ldlt_pallas,
                                        batched_solve_ldlt_pallas)
    factor = jax.jit(batched_ldlt_pallas)
    solve = jax.jit(batched_solve_ldlt_pallas)
    for B, n1, n2 in shapes:
        n = n1 + n2
        A64 = jnp.asarray(qd_batch(B, n1, n2))
        b64 = jnp.asarray(np.random.default_rng(1).normal(size=(B, n)))
        A32, b32 = A64.astype(jnp.float32), b64.astype(jnp.float32)
        hlo = factor.lower(A32).as_text() + solve.lower(
            A32, A32[:, 0], b32).as_text()
        if "__gpu$xla.gpu.triton" not in hlo:
            raise SystemExit("chip_smoke: the kernels did not lower to "
                             "compiled Triton calls")
        (L, D), t_f = timed(factor, A32)
        x, t_s = timed(solve, L, D, b32)
        _, Dr = jax.vmap(ldlt)(A64)
        print(f"phase 2 kernel: B={B} n={n}: factor {t_f:.2f} s, solve "
              f"{t_s:.2f} s (first calls, compile included)", flush=True)
        check("D vs f64 ops/ldlt.py, max rel error",
              float(jnp.max(jnp.abs(D - Dr) / jnp.abs(Dr))), 1e-4)
        res = jnp.einsum("bij,bj->bi", A64, x.astype(jnp.float64)) - b64
        check("solve, max |K x - b| / max |b|",
              float(jnp.max(jnp.abs(res)) / jnp.max(jnp.abs(b64))), 1e-4)
        xr = jax.vmap(solve_ldlt)(*jax.vmap(ldlt)(A64), b64)
        check("solve vs f64 ops/ldlt.py, max |x - x64| / max |x64|",
              float(jnp.max(jnp.abs(x - xr)) / jnp.max(jnp.abs(xr))), 1e-4)


# ---------------------------------------------------------------------------
# phase 3: the batched solve, BASELINE config 4
# ---------------------------------------------------------------------------

def scipy_reference(Q, c, A, l, u, lx, ux):
    """min 1/2 x'Qx + c'x  s.t.  l <= A x <= u, lx <= x <= ux, in f64 by
    SciPy's SLSQP (an implementation independent of this package).
    Returns (x, f)."""
    from scipy.optimize import minimize
    Q, c, A, l, u = (np.asarray(v, np.float64) for v in (Q, c, A, l, u))
    cons = [{"type": "ineq", "fun": lambda x: A @ x - l,
             "jac": lambda x: A},
            {"type": "ineq", "fun": lambda x: u - A @ x,
             "jac": lambda x: -A}]
    x0 = np.clip(np.zeros_like(c), lx, ux)
    r = minimize(lambda x: 0.5 * x @ Q @ x + c @ x, x0,
                 jac=lambda x: Q @ x + c, method="SLSQP",
                 bounds=list(zip(np.asarray(lx, np.float64),
                                 np.asarray(ux, np.float64))),
                 constraints=cons,
                 options={"ftol": 1e-12, "maxiter": 1000})
    if not r.success:
        raise SystemExit(f"chip_smoke: SciPy reference failed: {r.message}")
    return r.x, float(r.fun)


def compare_with_scipy(data, x, f, idx):
    """Max x error and max objective error / max(1, |f_ref|) over the
    instances ``idx`` of the batched QPData ``data``."""
    x_err = f_err = 0.0
    for i in idx:
        xr, fr = scipy_reference(
            data.Q[i], data.c[i], data.A_ineq[i], data.l_A_ineq[i],
            data.u_A_ineq[i], data.l_x[i], data.u_x[i])
        x_err = max(x_err, float(np.max(np.abs(np.asarray(x[i]) - xr))))
        f_err = max(f_err, abs(float(f[i]) - fr) / max(1.0, abs(fr)))
    return x_err, f_err


def phase_main(batch: int = 10240, n: int = 16, m: int = 8,
               tol: float = 1e-6):
    import jax
    import jax.numpy as jnp
    from bench import make_batch
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    data = make_batch(batch, n, m, jnp.float32)
    solver = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float32,
                         tol=tol)
    res, t_first = timed(solver.solve_batch_compact, data)
    res, t_solve = timed(solver.solve_batch_compact, data)
    (jit_fn,) = solver._compact_cache.values()
    n_triton = jit_fn.lower(data).as_text().count("__gpu$xla.gpu.triton")
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    iters = int(jnp.sum(res.iterations))
    print(f"phase 3 main path: {batch} QPs n={n} m={m} f32 tol {tol:g}: "
          f"compile+first solve {t_first:.1f} s, solve {t_solve:.4f} s "
          f"(second call), {iters} iterations, converged {conv:.5f}, "
          f"{n_triton} Triton kernel calls in the program", flush=True)
    check("unconverged share", 1.0 - conv, 0.01)
    if n_triton == 0:
        raise SystemExit("chip_smoke: the batched solve runs no compiled "
                         "Triton kernel")
    idx = np.random.default_rng(1234).choice(
        batch, size=min(N_REFERENCE, batch), replace=False)
    host = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), data)
    x_err, f_err = compare_with_scipy(host, np.asarray(res.x, np.float64),
                                      np.asarray(res.objective, np.float64),
                                      idx)
    check(f"objective vs SciPy on {len(idx)} instances, "
          "max |f - f_ref| / max(1, |f_ref|)", f_err, 1e-5)
    check(f"x vs SciPy on {len(idx)} instances, max |x - x_ref|",
          x_err, 2e-3)


# ---------------------------------------------------------------------------
# phase 4: the dense path, BASELINE config 3
# ---------------------------------------------------------------------------

def phase_dense(batch: int = 16, n: int = 1024, m: int = 128,
                kernel: str = "blockg"):
    import jax
    import jax.numpy as jnp
    from bench import make_batch
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    data = make_batch(batch, n, m, jnp.float32)
    out = {}
    for dt, tol in ((jnp.float32, 1e-5), (jnp.float64, 1e-8)):
        s = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=dt, tol=tol,
                        kernel=kernel, scale_tol=True, gondzio=2)
        d = jax.tree_util.tree_map(lambda v: v.astype(dt), data)
        out[dt], t = timed(s.solve_batch, d)
        conv = float(jnp.mean(out[dt].converged.astype(jnp.float32)))
        print(f"phase 4 dense path: {batch} QPs n={n} m={m} "
              f"{jnp.dtype(dt).name} tol {tol:g} kernel={kernel}: "
              f"{t:.1f} s (compile included), converged {conv:.3f}",
              flush=True)
        check(f"{jnp.dtype(dt).name} unconverged share", 1.0 - conv, 0.0)
    r32, r64 = out[jnp.float32], out[jnp.float64]
    f32 = np.asarray(r32.objective, np.float64)
    f64 = np.asarray(r64.objective, np.float64)
    check("objective f32 vs f64, max rel error",
          float(np.max(np.abs(f32 - f64) / np.maximum(1.0, np.abs(f64)))),
          1e-4)
    x = np.asarray(r32.x, np.float64)
    A = np.asarray(data.A_ineq, np.float64)
    ax = np.einsum("bmn,bn->bm", A, x)
    viol = max(
        float(np.max(np.asarray(data.l_x, np.float64) - x)),
        float(np.max(x - np.asarray(data.u_x, np.float64))),
        float(np.max(np.asarray(data.l_A_ineq, np.float64) - ax)),
        float(np.max(ax - np.asarray(data.u_A_ineq, np.float64))), 0.0)
    check("f32 primal infeasibility (bounds, l <= A x <= u)", viol, 1e-5)


# ---------------------------------------------------------------------------
# phase 5: the Schur path, bench_schur's problem
# ---------------------------------------------------------------------------

def schur_problem(inst: int, blocks: int, n: int, m_c: int, dtype):
    """bench_schur's coupled block-separable QPs (the same seeds)."""
    import jax
    import jax.numpy as jnp
    from ipmzoo.parallel.schur import BlockQPData

    def make(seed):
        r = np.random.default_rng(seed)
        M = r.normal(size=(blocks, n, n))
        Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
        return BlockQPData(
            Q=jnp.asarray(Q, dtype),
            c=jnp.asarray(r.normal(size=(blocks, n)), dtype),
            F=jnp.asarray(r.normal(size=(blocks, m_c, n)) / blocks, dtype),
            l_x=jnp.full((blocks, n), -3.0, dtype),
            u_x=jnp.full((blocks, n), 3.0, dtype),
            g=jnp.asarray(r.normal(size=(m_c,)) * 0.1, dtype))

    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[make(s) for s in range(inst)])


def phase_schur(inst: int = 8, blocks: int = 64, n: int = 64, m_c: int = 16):
    import jax.numpy as jnp
    from ipmzoo.parallel.schur import SchurIPM
    out = {}
    for dt in (jnp.float32, jnp.float64):
        s = SchurIPM(n=n, m_c=m_c, dtype=dt, tol=1e-8, refine=2,
                     max_iter=60, two_float="auto", block_kernel="auto")
        out[dt], t = timed(s.solve_batch,
                           schur_problem(inst, blocks, n, m_c, dt))
        conv = float(jnp.mean(out[dt].converged.astype(jnp.float32)))
        print(f"phase 5 Schur path: {inst} x {blocks} blocks n={n} "
              f"m_c={m_c} {jnp.dtype(dt).name} tol 1e-8 (two_float="
              f"{s.two_float}): {t:.1f} s (compile included), "
              f"{int(jnp.max(out[dt].iterations))} iterations, converged "
              f"{conv:.3f}", flush=True)
        check(f"{jnp.dtype(dt).name} unconverged share", 1.0 - conv, 0.0)
    err = float(jnp.max(jnp.abs(out[jnp.float32].x.astype(jnp.float64)
                                - out[jnp.float64].x)))
    check("x f32 vs f64, max abs error", err, 1e-6)


# ---------------------------------------------------------------------------
# --four-cards: the paths across devices
# ---------------------------------------------------------------------------

def phase_four_cards(devs, batch: int = 10240, n: int = 16, m: int = 8,
                     blocks: int = 64, nb: int = 64, m_c: int = 16,
                     tp_n: int = 1792, tp_m: int = 256, tol: float = 1e-6):
    import jax
    import jax.numpy as jnp
    from bench import make_batch
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    from ipmzoo.parallel.mesh import batch_sharding, make_mesh
    from ipmzoo.parallel.schur import SchurIPM
    nd = len(devs)

    # dp: nd x batch QPs sharded over the cards vs the same batch (the
    # same compaction schedule) on one card
    data = make_batch(nd * batch, n, m, jnp.float32)
    mesh = make_mesh(devices=devs)
    solver = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float32,
                         tol=tol)
    sharded = jax.device_put(data, batch_sharding(mesh))
    res_n, t_n = timed(solver.solve_batch_compact, sharded)
    res_1, t_1 = timed(solver.solve_batch_compact,
                       jax.device_put(data, devs[0]))
    conv = float(jnp.mean(res_n.converged.astype(jnp.float32)))
    print(f"four cards, dp: {nd} x {batch} QPs over {nd} cards: "
          f"{t_n:.1f} s, one card {t_1:.1f} s (compile included), "
          f"converged {conv:.5f}", flush=True)
    check("dp unconverged share", 1.0 - conv, 0.01)
    check("dp x vs one card, max abs error",
          float(np.max(np.abs(np.asarray(res_n.x) -
                              np.asarray(res_1.x)))), 1e-5)

    # Schur: one coupled QP of `blocks` blocks over the cards vs local
    bdata = jax.tree_util.tree_map(
        lambda a: a[0], schur_problem(1, blocks, nb, m_c, jnp.float32))
    kw = dict(dtype=jnp.float32, tol=1e-8, refine=2, max_iter=60)
    r_sh, t_sh = timed(SchurIPM(nb, m_c, mesh=mesh, axis="dp", **kw)
                       .solve_sharded, bdata)
    r_lo, _ = timed(SchurIPM(nb, m_c, **kw).solve, bdata)
    print(f"four cards, Schur: {blocks} blocks n={nb} m_c={m_c} over "
          f"{nd} cards: {t_sh:.1f} s (compile included), converged "
          f"{bool(r_sh.converged)}", flush=True)
    if not bool(r_sh.converged):
        raise SystemExit("chip_smoke: sharded Schur solve did not converge")
    check("Schur x sharded vs local, max abs error",
          float(jnp.max(jnp.abs(r_sh.x - r_lo.x))), 1e-6)

    # tp: one QP whose KKT (aug_dim = tp_n + tp_m) is row-sharded
    tp = make_batch(1, tp_n, tp_m, jnp.float32)
    one = jax.tree_util.tree_map(lambda v: v[0], tp)
    mesh_tp = make_mesh((nd,), ("tp",), devs)
    kw = dict(n=tp_n, m_ineq=tp_m, dtype=jnp.float32, tol=1e-5,
              scale_tol=True)
    s_tp = CompiledIPM(Settings(), kernel="sharded", mesh=mesh_tp,
                       mesh_axis="tp", **kw)
    r_tp, t_tp = timed(s_tp.solve, one)
    r_de, _ = timed(CompiledIPM(Settings(), **kw).solve, one)
    print(f"four cards, tp: one QP aug_dim={s_tp.aug_dim} row-sharded "
          f"over {nd} cards: {t_tp:.1f} s (compile included), "
          f"{int(r_tp.iterations)} iterations, converged "
          f"{bool(r_tp.converged)}", flush=True)
    if not (bool(r_tp.converged) and bool(r_de.converged)):
        raise SystemExit("chip_smoke: tp or dense solve did not converge")
    check("tp x sharded vs dense, max abs error",
          float(jnp.max(jnp.abs(r_tp.x - r_de.x))), 1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths across 4 cards")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)     # the f64 references
    require_gpu()
    from ipmzoo.utils.cache import enable_compile_cache
    from ipmzoo.utils.precision import apply_default_matmul_precision
    apply_default_matmul_precision()    # as importing ipmzoo.ops does
    cache_dir = enable_compile_cache()
    devs = phase_device(cache_dir)
    if args.four_cards:
        if len(devs) < 4:
            raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, "
                             f"have {len(devs)}")
        devs = devs[:4]
        phase_four_cards(devs)
    else:
        devs = devs[:1]
        phase_kernel()
        phase_main()
        phase_dense()
        phase_schur()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
