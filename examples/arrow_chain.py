#!/usr/bin/env python
"""Structured banded+arrow IPM vs the dense path on a chain QP.

A chain of locally coupled decision variables plus a few global coupling
variables (banded+arrow Hessian) under box bounds: the structure
detector recovers (bandwidth, tip, permutation) from the dense matrix,
and ArrowIPM factors the condensed KKT in O(n (b+t)^2) per iteration —
block-tridiagonal cyclic reduction + a dense tip Schur complement —
instead of the dense path's O(n^3).

    python examples/arrow_chain.py [n] [bandwidth] [tip]
"""

import sys
import time

import jax.numpy as jnp
import numpy as np

from ipmzoo.models import ArrowIPM, ArrowQPData, CompiledIPM
from ipmzoo.models.families import arrow_chain
from ipmzoo.utils.cache import enable_compile_cache


def main(n=512, bandwidth=8, tip=4):
    enable_compile_cache()
    fam = arrow_chain(n=n, bandwidth=bandwidth, tip=tip, seed=0,
                      dtype=jnp.float32)

    data, st, block = ArrowQPData.from_dense(
        np.asarray(fam.data.Q), np.asarray(fam.data.c),
        np.asarray(fam.data.l_x), np.asarray(fam.data.u_x),
        dtype=jnp.float32)
    print(f"detected structure: bandwidth={st.bandwidth} tip={st.tip} "
          f"(block size {block})")

    solver = ArrowIPM.for_data(data, structure=st, dtype=jnp.float32,
                               tol=1e-5)
    t0 = time.time()
    res = solver.solve(data)
    print(f"structured: converged={bool(res.converged)} in "
          f"{int(res.iterations)} iterations, "
          f"objective {float(res.objective):.6f} "
          f"({time.time() - t0:.2f}s incl. compile)")

    dense = CompiledIPM(fam.settings, n=fam.n, dtype=jnp.float32,
                        tol=1e-5)
    t0 = time.time()
    dres = dense.solve(fam.data)
    print(f"dense:      converged={bool(dres.converged)} in "
          f"{int(dres.iterations)} iterations, "
          f"objective {float(dres.objective):.6f} "
          f"({time.time() - t0:.2f}s incl. compile)")
    err = float(np.max(np.abs(np.asarray(res.x) - np.asarray(dres.x))))
    print(f"max |x_structured - x_dense| = {err:.2e}")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
