#!/usr/bin/env python
"""General-sparsity IPM via nested dissection on a 2D-grid QP.

A box-constrained QP whose Hessian couples variables on a g x g grid
(5-point stencil — think discretised control/estimation fields).  The
KKT sparsity has small separators, so ``CompiledIPM(kernel="nd")``
factors it by nested-dissection block elimination (ops/ndiss.py): the
separator tree and symbolic fill are computed on the host once, and the
device program is O(log n) levels of batched dense block ops instead of
the dense path's O(n^3) factorisation.

    python examples/grid_qp.py [grid_side] [leaf]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from ipmzoo.models import CompiledIPM
from ipmzoo.models.families import grid_qp
from ipmzoo.utils.cache import enable_compile_cache


def main(g=24, leaf=32):
    n = g * g
    enable_compile_cache()
    # f64 needs x64 mode; without it run f32 at a tolerance above its
    # floor (1e-6, tests/test_precision_floor.py)
    if jax.config.jax_enable_x64:
        dtype, tol = jnp.float64, 1e-8
    else:
        dtype, tol = jnp.float32, 1e-5
    fam = grid_qp(side=g, seed=0, dtype=dtype)
    data = fam.data

    nd = CompiledIPM(fam.settings, n=n, dtype=dtype, tol=tol,
                     kernel="nd", nd_leaf=leaf)
    t0 = time.time()
    res = nd.solve(data)          # derives the dissection plan, compiles
    t_nd = time.time() - t0
    plan = nd._nd_plan
    print(f"grid {g}x{g} (n={n}, {dtype.__name__}, tol={tol:g}): "
          f"nested dissection, {len(plan.levels)} levels, "
          f"flop ratio dense/nd = "
          f"{plan.flops_dense / max(plan.flops_nd, 1):.1f}x")
    print(f"  nd:    converged={bool(res.converged)} "
          f"iters={int(res.iterations)} gap={float(res.gap):.2e} "
          f"({t_nd:.1f}s incl. compile)")

    dense = CompiledIPM(fam.settings, n=n, dtype=dtype, tol=tol)
    t0 = time.time()
    res_d = dense.solve(data)
    t_d = time.time() - t0
    dx = float(np.max(np.abs(np.asarray(res.x) - np.asarray(res_d.x))))
    print(f"  dense: converged={bool(res_d.converged)} "
          f"iters={int(res_d.iterations)} ({t_d:.1f}s incl. compile)")
    print(f"  max|x_nd - x_dense| = {dx:.2e}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
