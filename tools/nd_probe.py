#!/usr/bin/env python
"""Per-stage timing of the nested-dissection IPM step (BENCH_MODE=nd).

Run from the repository root on the GPU:

    python tools/nd_probe.py [side] [leaf]

Times, separately and slope-timed: KKT assembly, nd_factor, one
nd_solve, the multi-rhs nd_solve_matrix the step uses, and the whole
_step_impl, so a step's time can be attributed.
"""

import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from ipmzoo.models import CompiledIPM
from ipmzoo.models.families import grid_qp
from ipmzoo.ops.ndiss import nd_factor, nd_solve, nd_solve_matrix
from ipmzoo.utils.timing import measure_call, measure_chain


def main(side=64, leaf=64):
    n = side * side
    fam = grid_qp(side=side, seed=0, dtype=jnp.float32)
    data = fam.data
    solver = CompiledIPM(fam.settings, n=n, dtype=jnp.float32, tol=1e-5,
                         kernel="nd", nd_leaf=leaf)
    solver._ensure_nd_plan(data)
    state = solver.init_state(data)
    plan = solver._nd_plan
    print(f"backend={jax.default_backend()} n={n} leaf={leaf} "
          f"levels={len(plan.levels)}")
    for i, lev in enumerate(plan.levels):
        print(f"  level {i}: {lev.idx.shape[0]} nodes of k={lev.idx.shape[1]}"
              f" (boundary m={lev.bnd.shape[1]})")

    # a representative KKT matrix: the one the first step assembles
    env = solver._env(data, [jnp.asarray(v) for v in state.vars],
                      float(state.mu))
    K = solver._assemble_kkt(env)
    print(f"KKT dim = {K.shape}")

    fac = jax.jit(lambda K: nd_factor(K, plan))
    f = fac(K)
    t_fac = measure_call(fac, K)
    print(f"nd_factor: {t_fac * 1e3:.3f} ms")

    b = jnp.ones((K.shape[0],), K.dtype)
    sol = jax.jit(lambda f, b: nd_solve(plan, f, b))
    sol(f, b)
    t_sol = measure_call(sol, f, b)
    print(f"nd_solve (1 rhs): {t_sol * 1e3:.3f} ms")

    for r in (2, 4):
        B = jnp.ones((K.shape[0], r), K.dtype)
        solm = jax.jit(lambda f, B: nd_solve_matrix(plan, f, B))
        solm(f, B)
        t = measure_call(solm, f, B)
        print(f"nd_solve_matrix ({r} rhs): {t * 1e3:.3f} ms")

    step = jax.jit(solver._step_impl)
    t_step = measure_chain(lambda s: step(s, data), state)
    print(f"full step: {t_step * 1e3:.3f} ms")


if __name__ == "__main__":
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    leaf = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    main(side, leaf)
