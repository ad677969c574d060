"""Batched LDL^T factor and solve as Pallas kernels for the GPU.

The batched IPM factors one small quasi-definite KKT matrix per instance
every iteration.  XLA's lowering of the vmapped column loop
(:func:`.ldlt.ldlt`) issues about n sequential full-batch device ops per
factor and about 2n per solve, each of which re-reads the whole batch of
matrices from device memory.  These kernels run the whole column loop
inside one launch instead.

Layout: structure-of-arrays ``(n, n, B)`` with the batch contiguous, so
each program owns a power-of-two block of ``bt`` instances, one instance
per lane, and every load of a matrix column is coalesced along the
batch.  n is padded to a power of two (Triton block shapes must be
powers of two); the loops run over the true n only, so the padding is
never factored.  The wrappers take the standard ``(B, n, n)`` layout and
transpose at the boundary.

* Factor: left-looking, column by column.  Column j needs every earlier
  column of L, which a block of ``bt`` instances cannot hold in
  registers (32^2 * 64 * 4 B = 256 KB at n = 32), so finished columns
  are written to the output and streamed back through L1/L2.  A block
  barrier after each column makes the store visible to the threads that
  read it next.
* Solve: the right-hand side of a block, ``(n, bt)``, stays in
  registers; the sweeps stream L one column per step.

Only the factor and the one-rhs solve are kernels: a multi-rhs solve
and a fused factor + multi-rhs solve built the same way lost to XLA on
the card (PERF.md, "Kernel decisions on H100") and were removed.

The kernels name the Triton route explicitly (``backend="triton"``).
On the CPU they run only when a caller passes ``interpret=True``, which
the tests do; :mod:`.routes` decides where each batched factor runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .ldlt import PIVOT_FLOOR, solve_ldlt

#: (instances per program, warps per program) of the factor and of the
#: solve kernel, the fastest of those timed on the card at n = 24
#: (tools/ldlt_kernel_probe.py)
FACTOR_TILE = (32, 4)
SOLVE_TILE = (32, 1)


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _dims(B: int, n: int, tile):
    """(npad, bt, Bpad): padded matrix order, batch block, padded batch."""
    npad = max(_pow2(n), 2)
    bt = min(tile[0], max(_pow2(B), 2))
    return npad, bt, -(-max(B, 1) // bt) * bt


def _call(kernel, grid, in_specs, out_specs, out_shape, interpret, name,
          tile):
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, interpret=interpret, backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=tile[1]),
        name=name)


def _mat_spec(npad, bt):
    return pl.BlockSpec((npad, npad, bt), lambda i: (0, 0, i))


def _vec_spec(npad, bt):
    return pl.BlockSpec((npad, bt), lambda i: (0, i))


# ---------------------------------------------------------------------------
# kernel bodies
# ---------------------------------------------------------------------------

def _factor_body(n, pivot_floor, sync, a_ref, l_ref, d_ref):
    npad, _, bt = a_ref.shape
    dt = a_ref.dtype
    rows = lax.broadcasted_iota(jnp.int32, (npad, bt), 0)

    def column(j, carry):
        # s_i = sum_{k<j} L[i, k] D[k] L[j, k]; s_j is the pivot update
        def update(k, s):
            w = l_ref[j, k, :] * d_ref[k, :]
            return s + l_ref[:, k, :] * w[None, :]

        s = lax.fori_loop(0, j, update, jnp.zeros((npad, bt), dt))
        c = a_ref[:, j, :] - s
        d = jnp.sum(jnp.where(rows == j, c, 0.0), axis=0)
        d = jnp.where(d == 0, jnp.asarray(pivot_floor, dt), d)
        l_ref[:, j, :] = jnp.where(rows > j, c / d[None, :],
                                   jnp.where(rows == j, 1.0, 0.0))
        d_ref[j, :] = d
        if sync:
            plgpu.debug_barrier()
        return carry

    # padded pivots are 1, so a solve against these factors keeps the
    # padding rows at zero
    d_ref[...] = jnp.ones((npad, bt), dt)
    if sync:
        plgpu.debug_barrier()
    lax.fori_loop(0, n, column, 0)


def _solve_cols(n, l_ref, d, x):
    """L D L^T x = b for one (npad, bt) right-hand side held in registers."""
    rows = lax.broadcasted_iota(jnp.int32, x.shape, 0)

    def fwd(j, x):
        xj = jnp.sum(jnp.where(rows == j, x, 0.0), axis=0)
        return x - jnp.where(rows > j, l_ref[:, j, :], 0.0) * xj[None, :]

    def bwd(t, x):
        i = n - 1 - t
        s = jnp.sum(jnp.where(rows > i, l_ref[:, i, :] * x, 0.0), axis=0)
        return jnp.where(rows == i, x - s[None, :], x)

    x = lax.fori_loop(0, n, fwd, x)
    return lax.fori_loop(0, n, bwd, x / d)


def _solve_body(n, l_ref, d_ref, b_ref, x_ref):
    x_ref[...] = _solve_cols(n, l_ref, d_ref[...], b_ref[...])


# ---------------------------------------------------------------------------
# layout wrappers: (B, n, n) <-> (npad, npad, Bpad)
# ---------------------------------------------------------------------------

def _to_soa(M, npad, Bpad, fill=0.0):
    """(B, n[, n]) -> (npad[, npad], Bpad), padded with ``fill``."""
    T = jnp.moveaxis(M, 0, -1)
    pads = [(0, npad - s) for s in T.shape[:-1]] + [(0, Bpad - M.shape[0])]
    return jnp.pad(T, pads, constant_values=fill)


def batched_ldlt_pallas(A: jnp.ndarray, pivot_floor: float = PIVOT_FLOOR, *,
                        interpret: bool = False):
    """A (B, n, n) -> (L, D): L (B, n, n) unit lower, D (B, n)."""
    B, n, _ = A.shape
    if n == 0:
        return jnp.zeros_like(A), jnp.zeros((B, 0), A.dtype)
    npad, bt, Bpad = _dims(B, n, FACTOR_TILE)
    A_t = _to_soa(A, npad, Bpad)
    L_t, D_t = _call(
        functools.partial(_factor_body, n, pivot_floor, not interpret),
        (Bpad // bt,), [_mat_spec(npad, bt)],
        (_mat_spec(npad, bt), _vec_spec(npad, bt)),
        (jax.ShapeDtypeStruct(A_t.shape, A.dtype),
         jax.ShapeDtypeStruct((npad, Bpad), A.dtype)),
        interpret, "batched_ldlt", FACTOR_TILE)(A_t)
    return (jnp.moveaxis(L_t, -1, 0)[:B, :n, :n],
            jnp.moveaxis(D_t, -1, 0)[:B, :n])


def batched_solve_ldlt_pallas(L: jnp.ndarray, D: jnp.ndarray,
                              b: jnp.ndarray, *, interpret: bool = False):
    """L (B, n, n), D (B, n), b (B, n) -> x (B, n)."""
    B, n, _ = L.shape
    if n == 0:
        return b
    npad, bt, Bpad = _dims(B, n, SOLVE_TILE)
    x_t = _call(
        functools.partial(_solve_body, n), (Bpad // bt,),
        [_mat_spec(npad, bt), _vec_spec(npad, bt), _vec_spec(npad, bt)],
        _vec_spec(npad, bt),
        jax.ShapeDtypeStruct((npad, Bpad), L.dtype),
        interpret, "batched_ldlt_solve", SOLVE_TILE)(
            _to_soa(L, npad, Bpad), _to_soa(D, npad, Bpad, 1.0),
            _to_soa(b, npad, Bpad))
    return jnp.moveaxis(x_t, -1, 0)[:B, :n]


# ---------------------------------------------------------------------------
# custom_vmap entry points: plain single-instance path, batched rule
# ---------------------------------------------------------------------------

@jax.custom_batching.custom_vmap
def ldlt_auto(A: jnp.ndarray):
    """LDL^T whose batched form (under ``jax.vmap``) runs where
    :func:`.routes.batched_ldlt_route` says.  Single-instance calls use
    the panel-blocked jnp kernel."""
    from .blocked_ldlt import ldlt_blocked
    return ldlt_blocked(A, PIVOT_FLOOR)


@ldlt_auto.def_vmap
def _ldlt_auto_vmap(axis_size, in_batched, A):
    from .blocked_ldlt import ldlt_blocked
    from .routes import batched_ldlt_route
    if batched_ldlt_route("auto", A.shape[-1], "factor").kernel == "pallas":
        return batched_ldlt_pallas(A, PIVOT_FLOOR), (True, True)
    L, D = jax.vmap(lambda a: ldlt_blocked(a, PIVOT_FLOOR))(A)
    return (L, D), (True, True)


@jax.custom_batching.custom_vmap
def solve_ldlt_auto(L: jnp.ndarray, D: jnp.ndarray, b: jnp.ndarray):
    return solve_ldlt(L, D, b)


@solve_ldlt_auto.def_vmap
def _solve_ldlt_auto_vmap(axis_size, in_batched, L, D, b):
    from .routes import batched_ldlt_route
    L, D, b = (x if bat else jnp.broadcast_to(x, (axis_size,) + x.shape)
               for x, bat in zip((L, D, b), in_batched))
    if batched_ldlt_route("auto", L.shape[-1], "solve").kernel == "pallas":
        return batched_solve_ldlt_pallas(L, D, b), True
    return jax.vmap(solve_ldlt)(L, D, b), True
