"""Batched Markowitz portfolio optimisation.

Solves a batch of independent portfolio QPs (different return/covariance
scenarios) in one compiled program, then prints summary statistics.

    python examples/batch_portfolio.py [batch] [n_assets]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp

from ipmzoo.models import CompiledIPM
from ipmzoo.models.families import portfolio
from ipmzoo.utils import Timer
from ipmzoo.utils.cache import enable_compile_cache


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    n_assets = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    enable_compile_cache()
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    tol = 1e-5 if dtype == jnp.float32 else 1e-8

    t = Timer()
    with t.section("generate"):
        fam = portfolio(n_assets=n_assets, batch=batch, seed=0, dtype=dtype)
    with t.section("compile+first solve"):
        solver = CompiledIPM(fam.settings, n=fam.n, m_eq=fam.m_eq,
                             dtype=dtype, tol=tol)
        res = solver.solve_batch(fam.data)
        jax.block_until_ready(res.x)
    with t.section("steady-state solve"):
        res = solver.solve_batch(fam.data)
        jax.block_until_ready(res.x)

    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    print(f"backend: {jax.default_backend()}, batch={batch}, "
          f"n_assets={n_assets}")
    print(f"converged: {conv * 100:.1f}%  "
          f"mean iterations: {float(jnp.mean(res.iterations)):.1f}  "
          f"median gap: {float(jnp.median(res.gap)):.2e}")
    w = res.x
    print(f"weights: min {float(w.min()):.4f}, max {float(w.max()):.4f}, "
          f"budget residual {float(jnp.abs(w.sum(axis=-1) - 1).max()):.2e}")
    t.report()


if __name__ == "__main__":
    main()
