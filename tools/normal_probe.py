#!/usr/bin/env python
"""Piecewise timings of the n=1024 dense-QP iteration (BASELINE config 3).

Where does the kernel='block' / 'blockg' / 'normal' iteration spend its
time?  Times, separately and slope-timed (utils/timing.py): the batched
Cholesky factor, single- and multi-rhs triangular solves, the explicit
H^{-1}, and one full vmapped IPM step per kernel with and without
Gondzio rounds.  Run on the GPU from the repository root:

    python tools/normal_probe.py [n] [m] [B]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    from ipmzoo.utils.timing import measure_call, measure_chain
    print(f"backend={jax.default_backend()} n={n} m={m} B={B}", flush=True)

    rng = np.random.default_rng(0)
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    H = jnp.asarray(np.einsum("bij,bkj->bik", M, M) / n +
                    2 * np.eye(n, dtype=np.float32))
    A = jnp.asarray(rng.normal(size=(B, m, n)).astype(np.float32))
    b1 = jnp.asarray(rng.normal(size=(B, n)).astype(np.float32))
    Bm = jnp.asarray(rng.normal(size=(B, n, m)).astype(np.float32))

    from jax.scipy.linalg import solve_triangular

    chol = jax.jit(jax.vmap(jnp.linalg.cholesky))
    L = chol(H)

    def piece(label, fn, *args):
        f = jax.jit(fn)
        try:
            dt = measure_call(f, *args)
            print(f"{label}: {dt * 1e3:.3f} ms", flush=True)
        except Exception as e:
            print(f"{label} FAILED: {e}", flush=True)

    piece("batched cholesky (B,n,n)",
          jax.vmap(jnp.linalg.cholesky), H)
    piece("batched tri solve, 1 rhs",
          jax.vmap(lambda Li, bi: solve_triangular(Li, bi, lower=True)),
          L, b1)
    piece(f"batched tri solve, {m} rhs",
          jax.vmap(lambda Li, Bi: solve_triangular(Li, Bi, lower=True)),
          L, Bm)
    eye = jnp.eye(n, dtype=jnp.float32)
    piece("explicit H^-1 (n rhs fwd+bwd)",
          jax.vmap(lambda Li: solve_triangular(
              Li.T, solve_triangular(Li, eye, lower=True), lower=False)),
          L)
    piece("A @ H einsum (B,m,n,n)",
          lambda Ai, Hi: jnp.einsum("bmi,bin->bmn", Ai, Hi), A, H)

    # full steps
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    sys.path.insert(0, ".")
    from bench import make_batch
    data = make_batch(B, n, m, jnp.float32)
    for kernel, kw in (("block", {"block_inv": True}),
                       ("block", {"block_inv": False}),
                       ("blockg", {}), ("normal", {})):
        for gz in (2, 0):
            try:
                s = CompiledIPM(Settings(), n=n, m_ineq=m,
                                dtype=jnp.float32, tol=1e-5,
                                kernel=kernel, scale_tol=True, gondzio=gz,
                                **kw)
                stepv = jax.jit(jax.vmap(s._step_impl))
                state = jax.jit(jax.vmap(s.init_state))(data)
                dt = measure_chain(lambda st: stepv(st, data), state)
                print(f"step kernel={kernel}{kw} gondzio={gz}: "
                      f"{dt * 1e3:.3f} ms => {B / dt:.0f} inst-it/s",
                      flush=True)
            except Exception as e:
                print(f"step kernel={kernel}{kw} gondzio={gz} failed: "
                      f"{e}", flush=True)


if __name__ == "__main__":
    main()
