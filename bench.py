#!/usr/bin/env python
"""Benchmark engines: IPM iterations/s on the batched-QP workload
(BASELINE.md config 4) and the other BASELINE configurations, one
engine per run, on the GPU.

    BENCH_MODE=solve|steps|sharded|tf|kkt|mpc|arrow|nd|schur|normal|aug \
        python bench.py

Runs the named engine (default 'solve') in this process on the device
JAX sees, and fails if that device is not a GPU.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}

Baseline: the reference implementation (single-threaded C++ tree-walking
interpreter + dense LDL^T) solves the same QP class (n=16, m_ineq=8 box
QP, SlackedSlacks) at ~10 iterations per 15.0 ms = 662 iterations/s on
one core of a development host CPU (measured with a harness around the
reference's Optimizer, stdout suppressed; see tests/golden/README for
provenance).  The reference solves QPs one at a time; its batch-of-10k
throughput is the same 662 it/s.

Every time is two-point slope-timed (ipmzoo/utils/timing.py): k
repetitions and one host transfer, for two values of k, so dispatch and
synchronisation constants cancel.  The default engine is FULL SOLVES
(init -> converged, >= 99% of instances must converge, counted per
instance) through CompiledIPM.solve_batch_compact; every engine is
convergence-gated, so a throughput regression that broke convergence
fails the benchmark instead of scoring.
"""

import json
import os
import sys

import numpy as np

REFERENCE_ITERS_PER_SEC = 662.0   # reference C++, one host core, n=16 m=8
# reference LDL^T factor+solve measured at 2.88 GFLOP/s on one core of
# the same host (n=48 dense, its LinearSolvers driven by a timing harness)
REFERENCE_LDLT_GFLOPS = 2.88


def _ref_its_per_s(dim: int) -> float:
    """Flop-derived reference iterations/s on a given config.

    The reference solves ONE instance at a time, factoring the dense
    augmented KKT (dimension ``dim``) once per IPM iteration with its
    single-threaded LDL^T (/root/reference/src/NumericalOptimization/
    LinearSolvers.cpp:14-74) measured at REFERENCE_LDLT_GFLOPS on one
    host core; per-iteration flops = factor (2/3 dim^3) + two solves
    (4 dim^2 each).  This makes ``vs_baseline`` a same-config
    apples-to-apples ratio on every engine instead of comparing e.g.
    n=1024 solves against the reference's 2-variable demo."""
    flops = 2.0 * dim ** 3 / 3.0 + 2 * 4.0 * dim ** 2
    return REFERENCE_LDLT_GFLOPS * 1e9 / flops

BATCH = int(os.environ.get("BENCH_BATCH", 10240))
N = int(os.environ.get("BENCH_N", 16))
M_INEQ = int(os.environ.get("BENCH_M", 8))
STEPS = int(os.environ.get("BENCH_STEPS", 10))
# default tolerance = the pinned f32 convergence floor
# (tests/test_precision_floor.py): the headline number is a full solve at
# the tightest tolerance the working precision provably supports.
TOL = float(os.environ.get("BENCH_TOL", 1e-6))


def make_batch(batch, n, m, dtype):
    import jax.numpy as jnp
    from ipmzoo.models import QPData
    rng = np.random.default_rng(0)
    M = rng.normal(size=(batch, n, n)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n, dtype=np.float32)
    return QPData(
        Q=jnp.asarray(Q, dtype),
        c=jnp.asarray(rng.normal(size=(batch, n)), dtype),
        A_ineq=jnp.asarray(rng.normal(size=(batch, m, n)), dtype),
        l_A_ineq=jnp.asarray(-np.abs(rng.normal(size=(batch, m))) - 1, dtype),
        u_A_ineq=jnp.asarray(np.abs(rng.normal(size=(batch, m))) + 1, dtype),
        A_eq=jnp.zeros((batch, 0, n), dtype),
        b_eq=jnp.zeros((batch, 0), dtype),
        l_x=jnp.full((batch, n), -5.0, dtype),
        u_x=jnp.full((batch, n), 5.0, dtype))


def _solver(dtype=None, **kw):
    import jax.numpy as jnp
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    kw.setdefault("tol", TOL)
    return CompiledIPM(Settings(), n=N, m_ineq=M_INEQ,
                       dtype=dtype or jnp.float32, **kw)


def bench_solve(data, backend):
    """FULL batched solves (compaction-scheduled), convergence-checked.

    Value = sum of per-instance iterations actually spent / wall time
    per whole-batch solve (slope-timed), i.e. useful iterations/s."""
    import jax.numpy as jnp
    from ipmzoo.utils.timing import measure_call

    solver = _solver()
    res = solver.solve_batch_compact(data)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    if conv < 0.99:
        raise RuntimeError(f"solve convergence too low: {conv}")
    iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
    t = measure_call(solver.solve_batch_compact, data)
    label = (f"IPM iterations/s, {BATCH} batched QPs FULLY SOLVED to "
             f"tol={TOL:g} ({conv * 100:.2f}% converged, compacted "
             f"batch, n={N}, m={M_INEQ}, {backend})")
    return label, iters / t, "iterations/s", REFERENCE_ITERS_PER_SEC


def bench_steps(data, backend):
    """Raw vmapped-step iteration throughput (hardware it/s).

    Convergence-gated: the same solver must first FULLY SOLVE the batch
    (>=99%) so a fast-but-wrong step cannot score."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from ipmzoo.utils.timing import measure_chain

    solver = _solver()
    res = solver.solve_batch_compact(data)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    if conv < 0.99:
        raise RuntimeError(f"step-path convergence too low: {conv}")

    stepv = jax.vmap(solver._step_impl)
    K = 10

    @jax.jit
    def k_steps(state):
        return lax.fori_loop(0, K, lambda i, s: stepv(s, data), state)

    state = jax.jit(jax.vmap(solver.init_state))(data)
    t = measure_chain(k_steps, state)
    label = (f"IPM iterations/s, {BATCH} batched QPs, vmapped step "
             f"(convergence-gated at {conv * 100:.2f}%, n={N}, "
             f"m={M_INEQ}, {backend})")
    return label, BATCH * K / t, "iterations/s", REFERENCE_ITERS_PER_SEC


def bench_sharded(data, backend):
    """dp-sharded batched stepping over all visible devices, with
    strong-scaling efficiency vs a single-device run of the same batch.

    On a single chip efficiency is trivially 100%; on a pod slice the
    batch shards over the mesh with no hot-path communication, and the
    report makes the >=80% scaling target (BASELINE.md) measurable."""
    from ipmzoo.parallel.scaling import dp_scaling_report

    solver = _solver()
    report = dp_scaling_report(solver, data, steps=10)
    print(report.summary(), file=sys.stderr)
    label = (f"IPM iterations/s, {BATCH} batched QPs, dp-sharded over "
             f"{report.n_devices} device(s), strong-scaling efficiency "
             f"{100 * report.efficiency:.1f}% vs 1 device "
             f"(n={N}, m={M_INEQ}, {backend})")
    return (label, report.iters_per_s_ndev, "iterations/s",
            REFERENCE_ITERS_PER_SEC)


def bench_mpc(backend):
    """Structured MPC: batched Riccati IPM solves (block-tridiagonal KKT,
    O(T) per iteration vs the condensed dense path's O(T^3))."""
    import jax.numpy as jnp
    from ipmzoo.models.mpc import RiccatiIPM, random_mpc
    from ipmzoo.utils.timing import measure_call

    T = int(os.environ.get("BENCH_MPC_T", 32))
    ns = int(os.environ.get("BENCH_MPC_NS", 8))
    nu = int(os.environ.get("BENCH_MPC_NU", 4))
    batch = int(os.environ.get("BENCH_MPC_BATCH", 256))
    data = random_mpc(horizon=T, n_states=ns, n_controls=nu, batch=batch,
                      seed=0, dtype=jnp.float32)
    solver = RiccatiIPM(T, ns, nu, dtype=jnp.float32, tol=1e-5,
                        max_iter=40)
    res = solver.solve_batch(data)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    if conv < 0.95:
        raise RuntimeError(f"mpc convergence too low: {conv}")
    iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
    t = measure_call(solver.solve_batch, data)
    label = (f"IPM iterations/s, {batch} structured MPC QPs fully solved "
             f"(Riccati, T={T}, ns={ns}, nu={nu}, {backend}, "
             f"{conv * 100:.1f}% converged)")
    # reference baseline: the same MPC posed densely over the horizon
    # (states + dynamics duals + controls, dim ~ T*(2 ns + nu)) and
    # factored by its measured-GFLOP/s dense LDL^T each iteration
    return label, iters / t, "iterations/s", _ref_its_per_s(T * (2 * ns + nu))


def bench_arrow(backend):
    """Structured banded+arrow IPM vs the dense path on the same QP
    (n=4096, bandwidth 16, tip 8): per-iteration step time INSIDE a
    compiled fori_loop (what ``solve()``'s while_loop actually runs —
    chained single-step timing would charge the structured path a
    per-program launch floor the real solve never pays), slope-timed
    over the trip count and INTERLEAVED arrow/dense (median of 3
    alternating rounds)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from ipmzoo.formulations import Bounds, InequalityHandling, Settings
    from ipmzoo.models import ArrowIPM, ArrowQPData, CompiledIPM, QPData
    from ipmzoo.utils.timing import measure_call

    n = int(os.environ.get("BENCH_ARROW_N", 4096))
    b = int(os.environ.get("BENCH_ARROW_B", 16))
    t = int(os.environ.get("BENCH_ARROW_T", 8))
    dt = jnp.float32
    rng = np.random.default_rng(0)
    nb = n - t
    Q = np.zeros((n, n), np.float32)
    for i in range(nb):
        lo, hi = max(0, i - b), min(nb, i + b + 1)
        Q[i, lo:hi] = rng.normal(size=hi - lo) * 0.1
    Q = (Q + Q.T) / 2
    strip = rng.normal(size=(t, n)).astype(np.float32) * 0.1
    Q[nb:, :] = strip
    Q[:, nb:] = strip.T
    Q[nb:, nb:] = (strip[:, nb:] + strip[:, nb:].T) / 2
    Q += np.eye(n, dtype=np.float32) * (2 * b + t)
    c = rng.normal(size=n).astype(np.float32)
    l = np.full(n, -1.0, np.float32)
    u = np.full(n, 1.0, np.float32)

    # block >= bandwidth is free to choose; default: the native
    # bandwidth (BENCH_ARROW_BLOCK overrides)
    blk_env = int(os.environ.get("BENCH_ARROW_BLOCK", 0))
    data, st, blk = ArrowQPData.from_dense(Q, c, l, u, dtype=dt,
                                           block=blk_env or None)
    method = os.environ.get("BENCH_ARROW_METHOD", "auto")
    solver = ArrowIPM.for_data(data, structure=st, dtype=dt, tol=1e-5,
                               method=method)
    print(f"arrow: block={blk}, N={data.D.shape[0]}, method={method}",
          file=sys.stderr)
    res = solver.solve(data)
    if not bool(res.converged):
        raise RuntimeError("arrow solver did not converge")

    dense = CompiledIPM(
        Settings(inequalities=Bounds.NONE,
                 inequality_handling=InequalityHandling.SLACKS),
        n=n, dtype=dt, tol=1e-5)
    ddata = QPData.make(Q=Q, c=c, l_x=l, u_x=u, dtype=dt)

    def loop_pair(stepf, state, sdata, k1, k2):
        def make(K):
            @jax.jit
            def f(s):
                return lax.fori_loop(
                    0, K, lambda i, st_: stepf(st_, sdata), s)
            return f
        f1, f2 = make(k1), make(k2)
        measure_call(f1, state)     # warm/compile both trip counts
        measure_call(f2, state)
        return lambda: (measure_call(f2, state) -
                        measure_call(f1, state)) / (k2 - k1)

    arrow_t = loop_pair(solver._step_impl, solver.init_state(data),
                        data, 4, 16)
    dense_t = loop_pair(dense._step_impl, dense.init_state(ddata),
                        ddata, 2, 6)
    ts_a, ts_d = [], []
    for _ in range(3):              # interleaved rounds
        ts_a.append(arrow_t())
        ts_d.append(dense_t())
    t_arrow = float(np.median(ts_a))
    t_dense = float(np.median(ts_d))
    print(f"arrow rounds (us/iter): arrow "
          f"{[round(t * 1e6, 1) for t in ts_a]}, dense "
          f"{[round(t * 1e6, 1) for t in ts_d]}", file=sys.stderr)

    speedup = t_dense / t_arrow
    print(f"arrow: {t_arrow * 1e3:.3f} ms/iter structured vs "
          f"{t_dense * 1e3:.1f} ms/iter dense = {speedup:.1f}x",
          file=sys.stderr)
    label = (f"structured banded+arrow IPM step speedup vs dense path "
             f"(n={n}, bandwidth={b}, tip={t}, {backend}; "
             f"{t_arrow * 1e3:.2f} ms vs {t_dense * 1e3:.1f} ms per "
             f"iteration)")
    return label, speedup, "x speedup", 1.0


def bench_nd(backend):
    """General-sparsity structured path: nested-dissection IPM
    (kernel='nd', ops/ndiss.py) vs the dense path on a 2D-grid QP —
    per-iteration step time, slope-timed, like BENCH_MODE=arrow."""
    import jax
    import jax.numpy as jnp
    from ipmzoo.models import CompiledIPM
    from ipmzoo.models.families import grid_qp
    from ipmzoo.utils.timing import measure_chain

    g = int(os.environ.get("BENCH_ND_G", 64))        # grid side; n = g^2
    leaf = int(os.environ.get("BENCH_ND_LEAF", 64))
    n = g * g
    fam = grid_qp(side=g, seed=0, dtype=jnp.float32)
    data = fam.data

    # nd_fallback=False pins the nd path: the bench MEASURES it; the
    # auto-fallback (on by default for users) would silently bench the
    # dense kernel whenever the plan is predicted to lose
    solver = CompiledIPM(fam.settings, n=n, dtype=jnp.float32, tol=1e-5,
                         kernel="nd", nd_leaf=leaf, nd_fallback=False)
    res = solver.solve(data)
    if not bool(res.converged):
        raise RuntimeError("nd solver did not converge")
    plan = solver._nd_plan
    from ipmzoo.ops.ndiss import nd_predicted_speedup
    print(f"nd: {len(plan.levels)} levels, flop ratio dense/nd = "
          f"{plan.flops_dense / max(plan.flops_nd, 1):.1f}x, predicted "
          f"speedup {nd_predicted_speedup(plan):.1f}x",
          file=sys.stderr)

    # per-iteration cost INSIDE a compiled loop (what solve() runs):
    # slope over two trip counts so the once-per-solve prework (the
    # loop-invariant slab gathers) and the program-launch floor cancel
    # exactly; nd/dense rounds interleaved (the dense denominator
    # swings ~30% between separated runs), median of 3
    from jax import lax
    from ipmzoo.utils.timing import measure_call

    def loop_pair(s, k1, k2):
        stepf = s._step_impl
        pre_fn = getattr(s, "_nd_prework", None)

        def make(K):
            @jax.jit
            def k_steps(state):
                pre = pre_fn(data) if (pre_fn is not None and
                                       s._mode == "nd") else None
                return lax.fori_loop(
                    0, K, lambda i, st: stepf(st, data, nd_pre=pre),
                    state)
            return k_steps

        f1, f2 = make(k1), make(k2)
        state = s.init_state(data)
        measure_call(f1, state)     # warm/compile both trip counts
        measure_call(f2, state)
        return lambda: (measure_call(f2, state) -
                        measure_call(f1, state)) / (k2 - k1)

    dense = CompiledIPM(fam.settings, n=n, dtype=jnp.float32, tol=1e-5)
    nd_t = loop_pair(solver, 2, 8)
    dn_t = loop_pair(dense, 2, 8)
    ts_n, ts_d = [], []
    for _ in range(3):
        ts_n.append(nd_t())
        ts_d.append(dn_t())
    t_nd = float(np.median(ts_n))
    t_dense = float(np.median(ts_d))
    print(f"nd rounds (ms/iter): nd "
          f"{[round(t * 1e3, 3) for t in ts_n]}, dense "
          f"{[round(t * 1e3, 3) for t in ts_d]}", file=sys.stderr)

    speedup = t_dense / t_nd
    print(f"nd: {t_nd * 1e3:.3f} ms/iter vs {t_dense * 1e3:.2f} ms/iter "
          f"dense = {speedup:.1f}x", file=sys.stderr)
    label = (f"nested-dissection IPM step speedup vs dense path "
             f"(2D-grid QP, n={n}, leaf={leaf}, {backend}; "
             f"{t_nd * 1e3:.2f} ms vs {t_dense * 1e3:.1f} ms per "
             f"iteration)")
    return label, speedup, "x speedup", 1.0


def bench_tf(data, backend):
    """f32 two-float (double-single) pipeline: FULL batched solves at
    the reference-parity tolerance 1e-8 — the BASELINE.md headline
    target ("duality-gap parity <=1e-8") from pure f32 arithmetic.  Iterates are (hi, lo) pairs and the augmented KKT is
    assembled+factored in double-single (ops/ldlt_df.py); see the
    pinned floor table in tests/test_precision_floor.py."""
    import jax
    import jax.numpy as jnp
    from ipmzoo.utils.timing import measure_call

    B = int(os.environ.get("BENCH_TF_B", 2048))
    tol = float(os.environ.get("BENCH_TF_TOL", 1e-8))
    sub = jax.tree_util.tree_map(lambda a: a[:B], data)
    solver = _solver(tol=tol, two_float=True, max_iter=30)
    res = solver.solve_batch_compact(sub)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    if conv < 0.99:
        raise RuntimeError(f"two-float convergence too low: {conv}")
    iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
    t = measure_call(solver.solve_batch_compact, sub)
    label = (f"IPM iterations/s, {B} batched QPs FULLY SOLVED to the "
             f"reference-parity tol={tol:g} in pure-f32 two-float "
             f"arithmetic ({conv * 100:.2f}% converged, n={N}, "
             f"m={M_INEQ}, {backend})")
    return label, iters / t, "iterations/s", REFERENCE_ITERS_PER_SEC


def bench_normal(backend):
    """BASELINE config 3: normal-equations reduction with Mehrotra on
    1k-variable dense QPs (kernel='normal' consumes the reduction the
    reference derives but never solves,
    /root/reference/src/SymbolicOptimization.cpp:465-478).

    Per iteration the condensed path factors H (n^3/3), forms H^{-1}
    (n^3 solve against I) and the m x m condensed system; the augmented
    path factors the (n+m) KKT once.  Value = useful iterations/s over
    fully solved instances; a same-instance kernel='block' comparison
    goes to stderr."""
    import jax.numpy as jnp
    from ipmzoo.utils.timing import measure_call

    n = int(os.environ.get("BENCH_NORMAL_N", 1024))
    m = int(os.environ.get("BENCH_NORMAL_M", 128))
    # B=16 amortises the fixed per-op latencies of the vmapped loop
    B = int(os.environ.get("BENCH_NORMAL_B", 16))
    data = make_batch(B, n, m, jnp.float32)
    tol = float(os.environ.get("BENCH_NORMAL_TOL", 1e-5))

    # per-iteration flops of each staging of the reduction, for the
    # GFLOP/s side-channel: 'normal' binds an explicit H^{-1} (factor +
    # n-rhs solve) then condenses; 'block' runs the same elimination as
    # blocked Cholesky factorisations without the explicit inverse
    it_flops = {
        "normal": 2 * (n ** 3 / 3 + n ** 3 + n * n * m + m * m * n
                       + m ** 3 / 3),
        "block": 2 * (n ** 3 / 3 + n * n * m + m * m * n + m ** 3 / 3
                      + 2 * (n * n + n * m + m * m)),
        # blockg runs the same block elimination (G Cholesky stages +
        # trailing matmuls), so the flop model matches 'block'
        "blockg": 2 * (n ** 3 / 3 + n * n * m + m * m * n + m ** 3 / 3
                       + 2 * (n * n + n * m + m * m)),
    }

    def run(kernel):
        from ipmzoo.formulations import Settings
        from ipmzoo.models import CompiledIPM
        s = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float32,
                        tol=tol, kernel=kernel, scale_tol=True,
                        gondzio=2)
        res = s.solve_batch(data)
        conv = float(jnp.mean(res.converged.astype(jnp.float32)))
        iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
        t = measure_call(s.solve_batch, data)
        return conv, iters, t, s.aug_dim

    # The numerically-equivalent stagings of the normal-equations
    # reduction race and the WINNER is benched: kernel='normal'
    # (symbolic condensed system consuming the reduction the reference
    # derives but never solves,
    # /root/reference/src/SymbolicOptimization.cpp:465-478),
    # kernel='block' (the same elimination executed as block-level
    # Cholesky + Schur, ops/block_solve.py) and kernel='blockg' (signed
    # block-Cholesky, ops/blockg.py).
    results = {}
    for kernel in ("blockg", "block", "normal"):
        try:
            results[kernel] = run(kernel)
        except Exception as e:
            print(f"kernel={kernel} failed: {e}", file=sys.stderr)
    ok = {k: (c, i, t, d) for k, (c, i, t, d) in results.items()
          if c >= 0.99}
    if not ok:
        raise RuntimeError(f"no normal-equations kernel converged: "
                           f"{ {k: v[0] for k, v in results.items()} }")
    print("normal-equations stagings on the same "
          f"{B} QPs (n={n}, m={m}): " +
          ", ".join(f"{k}: {i / t:.0f} it/s ({c * 100:.1f}% conv)"
                    for k, (c, i, t, d) in results.items()),
          file=sys.stderr)
    kernel = max(ok, key=lambda k: ok[k][1] / ok[k][2])
    conv, iters, t, aug_dim = ok[kernel]
    gflops = iters * it_flops[kernel] / t / 1e9
    label = (f"IPM iterations/s, {B} dense QPs (n={n}, m={m}) FULLY "
             f"SOLVED to rel tol={tol:g} via the normal-equations "
             f"reduction, kernel='{kernel}' ({conv * 100:.1f}% "
             f"converged, ~{gflops:.0f} GFLOP/s, {backend})")
    return label, iters / t, "iterations/s", _ref_its_per_s(aug_dim)


def bench_aug(backend):
    """BASELINE config 2: equality+inequality QP through the augmented-
    system reduction with iterative refinement (refine=2), fully solved
    and convergence-gated."""
    import jax.numpy as jnp
    from ipmzoo.models import QPData
    from ipmzoo.utils.timing import measure_call

    n = int(os.environ.get("BENCH_AUG_N", 256))
    m = int(os.environ.get("BENCH_AUG_M", 64))
    me = int(os.environ.get("BENCH_AUG_ME", 32))
    B = int(os.environ.get("BENCH_AUG_B", 64))
    tol = float(os.environ.get("BENCH_AUG_TOL", 1e-5))
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, n, n)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n, dtype=np.float32)
    x0 = rng.normal(size=(B, n)).astype(np.float32)
    A_eq = rng.normal(size=(B, me, n)).astype(np.float32)
    data = QPData(
        Q=jnp.asarray(Q, jnp.float32),
        c=jnp.asarray(rng.normal(size=(B, n)), jnp.float32),
        A_ineq=jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32),
        l_A_ineq=jnp.asarray(-np.abs(rng.normal(size=(B, m))) - 1,
                             jnp.float32),
        u_A_ineq=jnp.asarray(np.abs(rng.normal(size=(B, m))) + 1,
                             jnp.float32),
        A_eq=jnp.asarray(A_eq),
        # consistent equalities: b = A_eq x0 keeps the feasible set
        # nonempty for every instance
        b_eq=jnp.asarray(np.einsum("bmn,bn->bm", A_eq, x0)),
        l_x=jnp.full((B, n), -5.0, jnp.float32),
        u_x=jnp.full((B, n), 5.0, jnp.float32))

    from ipmzoo.formulations import (EqualityHandling, Settings)
    settings = Settings(equalities=True,
                        equality_handling=EqualityHandling.REGULARIZATION)
    from ipmzoo.models import CompiledIPM

    # two stagings of the same augmented factorisation race and the
    # winner is benched: 'blockg' (signed block-Cholesky — G stages)
    # vs the default dense LDL^T kernel (sequential panel loop)
    results = {}
    for kernel in ("blockg", "auto"):
        try:
            s = CompiledIPM(settings, n=n, m_ineq=m, m_eq=me,
                            dtype=jnp.float32, tol=tol, scale_tol=True,
                            refine=2, gondzio=2, kernel=kernel)
            res = s.solve_batch(data)
            conv = float(jnp.mean(res.converged.astype(jnp.float32)))
            iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
            t = measure_call(s.solve_batch, data)
            results[kernel] = (conv, iters, t, s.aug_dim)
        except Exception as e:
            print(f"aug kernel={kernel} failed: {e}", file=sys.stderr)
    ok = {k: v for k, v in results.items() if v[0] >= 0.99}
    if not ok:
        raise RuntimeError(f"augmented-path convergence too low: "
                           f"{ {k: v[0] for k, v in results.items()} }")
    print("aug stagings: " +
          ", ".join(f"{k}: {i / t:.0f} it/s ({c * 100:.1f}% conv)"
                    for k, (c, i, t, d) in results.items()),
          file=sys.stderr)
    kernel = max(ok, key=lambda k: ok[k][1] / ok[k][2])
    conv, iters, t, aug_dim = ok[kernel]
    label = (f"IPM iterations/s, {B} equality+inequality QPs (n={n}, "
             f"m_ineq={m}, m_eq={me}) FULLY SOLVED to rel tol={tol:g} "
             f"via the augmented system + iterative refinement "
             f"(refine=2, kernel='{kernel}', {conv * 100:.1f}% "
             f"converged, {backend})")
    return label, iters / t, "iterations/s", _ref_its_per_s(aug_dim)


def bench_schur(backend):
    """BASELINE config 5 (single-chip line): block-separable coupled QPs
    through the distributed Schur-complement IPM, at the
    REFERENCE-PARITY tolerance 1e-8 from pure f32 arithmetic
    (two_float=True: double-single iterates + compensated residuals,
    f32 factorisations — parallel/schur.py).  A batch of independent
    coupled-QP INSTANCES runs as vmapped lanes of one program,
    amortising the short per-instance iteration count; on one device
    the psum is free; on a pod slice the same program shards blocks
    over the mesh with one (m_c^2 + m_c)-float psum per solve phase
    (the 2-process path is exercised by tests/test_distributed.py and
    dryrun_multichip)."""
    import jax
    import jax.numpy as jnp
    from ipmzoo.parallel.schur import BlockQPData, SchurIPM
    from ipmzoo.utils.timing import measure_call

    blocks = int(os.environ.get("BENCH_SCHUR_BLOCKS", 64))
    n = int(os.environ.get("BENCH_SCHUR_N", 64))
    m_c = int(os.environ.get("BENCH_SCHUR_MC", 16))
    inst = int(os.environ.get("BENCH_SCHUR_I", 8))
    tol = float(os.environ.get("BENCH_SCHUR_TOL", 1e-8))
    rng = np.random.default_rng(0)

    def make(seed):
        r = np.random.default_rng(seed)
        M = r.normal(size=(blocks, n, n))
        Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
        return BlockQPData(
            Q=jnp.asarray(Q, jnp.float32),
            c=jnp.asarray(r.normal(size=(blocks, n)), jnp.float32),
            F=jnp.asarray(r.normal(size=(blocks, m_c, n)) / blocks,
                          jnp.float32),
            l_x=jnp.full((blocks, n), -3.0, jnp.float32),
            u_x=jnp.full((blocks, n), 3.0, jnp.float32),
            g=jnp.asarray(r.normal(size=(m_c,)) * 0.1, jnp.float32))

    datas = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[make(s) for s in range(inst)])
    s = SchurIPM(n=n, m_c=m_c, dtype=jnp.float32, tol=tol,
                 two_float=(tol < 1e-6), refine=2, max_iter=60)
    res = s.solve_batch(datas)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    if conv < 0.99:
        raise RuntimeError(f"schur convergence too low: {conv}")
    iters = float(jnp.sum(res.iterations.astype(jnp.float32)))
    steps = float(jnp.max(res.iterations.astype(jnp.float32)))
    t = measure_call(s.solve_batch, datas)
    print(f"schur: {inst} instances x {blocks} blocks x n={n}, "
          f"m_c={m_c}, tol={tol:g}: {t * 1e3:.2f} ms/solve-batch, "
          f"{t / steps * 1e3:.3f} ms/iteration, "
          f"{iters / t:.0f} useful it/s, {conv * 100:.0f}% converged",
          file=sys.stderr)
    label = (f"IPM iterations/s, {inst} block-separable coupled QPs "
             f"({blocks} blocks x n={n}, m_c={m_c}) FULLY SOLVED to the "
             f"reference-parity tol={tol:g} in pure-f32 two-float "
             f"arithmetic via the Schur-complement IPM "
             f"({conv * 100:.0f}% converged, "
             f"{t / steps * 1e3:.2f} ms/iteration, {backend})")
    # reference baseline: the monolithic dense KKT of ONE coupled QP
    # (blocks*n primal + m_c coupling duals) at its measured GFLOP/s
    return (label, iters / t, "iterations/s",
            _ref_its_per_s(blocks * n + m_c))


def bench_kkt(data, backend):
    """Batched KKT factor+solve throughput (GFLOP/s per device), both
    regimes the framework actually runs (the BASELINE metric is "KKT
    factor+solve GFLOP/s/chip"; reference comparator: its 2.88 GFLOP/s
    single-core dense LDL^T,
    /root/reference/src/NumericalOptimization/LinearSolvers.cpp:14-74):

    - small-system point: BATCH small-dim augmented systems through the
      batched factor and two 1-rhs solves that the batched IPM runs
      (``ldlt_auto`` / ``solve_ldlt_auto``, routed by ops/routes.py).
      This is the per-iteration linear algebra of the headline batched
      engine.
    - large-system points: a small batch of LARGE quasi-definite KKT
      systems (dims BENCH_KKT_DIMS, default 1024,4096) through the
      signed block-Cholesky staging (ops/blockg.py — the
      kernel='blockg' path), where the O(dim^3) work runs as matrix
      products.

    Headline value = the best large-system point; the small-system
    point is embedded in the label and printed to stderr.  All points
    are flop-graded with the same dense-LDL^T-equivalent model (factor
    2/3 d^3 + 2 rhs solves 4 d^2 each) as _ref_its_per_s.
    """
    import jax
    import jax.numpy as jnp
    from ipmzoo.ops.pallas_ldlt import ldlt_auto, solve_ldlt_auto
    from ipmzoo.utils.timing import measure_call

    def flops_model(B, d, k):
        return B * 2.0 * (d ** 3 / 3 + 2 * k * d * d)

    # chain K factor+solves inside one jit so the per-call dispatch cost
    # does not swamp a short kernel.  The solution feeds back into the
    # next rhs AND perturbs A at 1e-30 relative so XLA cannot hoist the
    # loop-invariant factorisation out of the loop.
    K = 20

    # --- small-system point: factor+solve, BATCH x dim (N + 2 M_INEQ) ---
    rng = np.random.default_rng(0)
    B, n = BATCH, N + 2 * M_INEQ   # augmented-ish sizing
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    A = jnp.asarray(np.einsum("bij,bkj->bik", M, M) / n +
                    np.eye(n, dtype=np.float32))
    R = jnp.asarray(rng.normal(size=(B, n, 2)), jnp.float32)

    @jax.jit
    def small_chain(A, R):
        def body(i, R):
            Ai = A * (1.0 + 1e-30 * R[0, 0, 0])
            L, D = jax.vmap(ldlt_auto)(Ai)
            return jnp.stack([jax.vmap(solve_ldlt_auto)(L, D, R[..., j])
                              for j in range(R.shape[-1])], axis=-1)
        return jax.lax.fori_loop(0, K, body, R)

    t_small = measure_call(small_chain, A, R) / K
    gflops_small = flops_model(B, n, 2) / t_small / 1e9
    print(f"kkt small-system point: {B} x dim {n}, factor+2-rhs "
          f"solve: {gflops_small:.1f} GFLOP/s "
          f"({t_small * 1e3:.3f} ms/batch)", file=sys.stderr)

    # --- large-system points: blockg signed block-Cholesky ---
    from ipmzoo.ops.blockg import blockg_factor, blockg_solve
    dims = [int(d) for d in
            os.environ.get("BENCH_KKT_DIMS", "1024,4096").split(",")]
    large = {}
    for d in dims:
        Bm = int(os.environ.get("BENCH_KKT_B", 0)) or max(2, 16384 // d)
        m = d // 8
        nq = d - m
        Mq = rng.normal(size=(Bm, nq, nq)).astype(np.float32)
        Hq = jnp.asarray(np.einsum("bij,bkj->bik", Mq, Mq) / nq +
                         np.eye(nq, dtype=np.float32))
        Aq = jnp.asarray(rng.normal(size=(Bm, m, nq)), jnp.float32)
        Sq = jnp.asarray(np.eye(m, dtype=np.float32))  # -delta I dual cell
        bq = jnp.asarray(rng.normal(size=(Bm, d, 2)), jnp.float32)

        def one(H, A2, R2):
            fact = blockg_factor([[H], [A2, -Sq]], (1.0, -1.0))
            x0 = blockg_solve(fact, R2[:, 0])
            x1 = blockg_solve(fact, R2[:, 1])
            return jnp.stack([x0, x1], axis=-1)

        @jax.jit
        def large_chain(H, A2, R2):
            def body(i, R2):
                Hp = H * (1.0 + 1e-30 * R2[0, 0, 0])
                return jax.vmap(one)(Hp, A2, R2)
            return jax.lax.fori_loop(0, K, body, R2)

        t_large = measure_call(large_chain, Hq, Aq, bq) / K
        large[d] = (Bm, flops_model(Bm, d, 2) / t_large / 1e9)
        print(f"kkt large-system point: {Bm} x dim {d} (blockg, n={nq}+m={m}): "
              f"{large[d][1]:.1f} GFLOP/s ({t_large * 1e3:.3f} ms/batch)",
              file=sys.stderr)

    d_top = max(large, key=lambda d: large[d][1])
    Bm, gflops_large = large[d_top]
    others = "; ".join(f"dim {d} x{bm}: {g:.0f} GFLOP/s"
                       for d, (bm, g) in sorted(large.items()) if d != d_top)
    label = (f"batched KKT factor+solve, {Bm} quasi-definite systems of "
             f"dim {d_top} via signed block-Cholesky "
             f"({backend}; {others}; small-system point: {B} x dim {n} "
             f"factor+solve at {gflops_small:.0f} GFLOP/s)")
    return label, gflops_large, "GFLOP/s", REFERENCE_LDLT_GFLOPS


def main():
    """Run the one engine named by BENCH_MODE (default 'solve') on the
    GPU JAX sees, in this process, and print the JSON line."""
    import jax
    import jax.numpy as jnp
    from ipmzoo.utils.cache import enable_compile_cache

    enable_compile_cache()
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX sees {backend!r}")
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    label_dev = f"{dev.device_kind} x{device['count']}"
    data = make_batch(BATCH, N, M_INEQ, jnp.float32)
    mode = os.environ.get("BENCH_MODE", "solve")
    engines = {
        "solve": lambda: bench_solve(data, label_dev),
        "steps": lambda: bench_steps(data, label_dev),
        "sharded": lambda: bench_sharded(data, label_dev),
        "tf": lambda: bench_tf(data, label_dev),
        "kkt": lambda: bench_kkt(data, label_dev),
        "mpc": lambda: bench_mpc(label_dev),
        "arrow": lambda: bench_arrow(label_dev),
        "nd": lambda: bench_nd(label_dev),
        "schur": lambda: bench_schur(label_dev),
        "normal": lambda: bench_normal(label_dev),
        "aug": lambda: bench_aug(label_dev),
    }
    if mode not in engines:
        raise SystemExit(f"bench: unknown BENCH_MODE={mode!r}; expected "
                         f"one of {sorted(engines)}")
    # every engine returns (label, value, unit, baseline); baselines are
    # per-config (measured 662 it/s for the reference's own n=16 QP
    # class, flop-derived via _ref_its_per_s elsewhere)
    label, value, unit, baseline = engines[mode]()
    print(json.dumps({
        "metric": label,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / baseline, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
