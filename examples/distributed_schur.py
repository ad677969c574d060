"""Distributed block-separable QP via Schur complements over a mesh.

Runs the structure-parallel IPM: blocks shard across devices, the
coupling system is psum-assembled per iteration. Works on any device
count (use XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu to try a virtual mesh).

    python examples/distributed_schur.py [blocks] [block_size]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from ipmzoo.parallel.mesh import make_mesh
from ipmzoo.parallel.schur import BlockQPData, SchurIPM
from ipmzoo.utils.cache import enable_compile_cache


def main():
    enable_compile_cache()
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    m_c = 4
    # f32 everywhere: at tol 1e-8 SchurIPM auto-enables its two-float
    # (double-single) mode, so the reference-parity tolerance is reached
    # from pure f32 arithmetic on any backend — no x64 needed
    dtype = jnp.float32
    tol = 1e-8

    rng = np.random.default_rng(0)
    M = rng.normal(size=(blocks, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
    data = BlockQPData(
        Q=jnp.asarray(Q, dtype),
        c=jnp.asarray(rng.normal(size=(blocks, n)), dtype),
        F=jnp.asarray(rng.normal(size=(blocks, m_c, n)) / blocks, dtype),
        l_x=jnp.full((blocks, n), -3.0, dtype),
        u_x=jnp.full((blocks, n), 3.0, dtype),
        g=jnp.asarray(rng.normal(size=(m_c,)) * 0.1, dtype))

    n_dev = len(jax.devices())
    mesh = make_mesh()
    ipm = SchurIPM(n, m_c, mesh=mesh, axis="dp", dtype=dtype, tol=tol)
    res = ipm.solve_sharded(data)
    jax.block_until_ready(res.x)

    print(f"backend: {jax.default_backend()}, devices: {n_dev}, "
          f"blocks: {blocks} x {n} vars, coupling rows: {m_c}")
    print(f"converged: {bool(res.converged)} in {int(res.iterations)} "
          f"iterations; residual {float(res.residual):.2e}, "
          f"gap {float(res.gap):.2e}")
    coupling = jnp.einsum("bij,bj->i", data.F, res.x) - data.g
    print(f"coupling feasibility: {float(jnp.abs(coupling).max()):.2e}")


if __name__ == "__main__":
    main()
