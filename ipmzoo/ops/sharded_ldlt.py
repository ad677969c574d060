"""Panel-sharded LDL^T of ONE large KKT system across the device mesh.

The TP axis of SURVEY §2.5: a single quasi-definite KKT matrix too large
for one chip's HBM is stored *row-sharded* over a 1-D mesh axis and
factored cooperatively — the tensor-parallel analogue of sharding one
layer's weights:

  per panel stage j (width p, static Python loop — shapes are static):
    1. the device owning rows [j, j+p) contributes them to a ``psum``
       (everyone else contributes zeros), broadcasting the panel's rows
       over ICI;
    2. every device redundantly factors the tiny (p x p) diagonal block
       and forms the panel row block T = L_jj^{-1} A[j:j+p, j+p:]
       (O(p^2 n) replicated flops — negligible next to the O(n^2 p)
       trailing update, and replication beats a second broadcast);
    3. every device updates ITS OWN rows of the trailing matrix with one
       local matmul  A_loc -= L21_loc @ T  — the O(n^3) bulk, embarrass-
       ingly parallel over the mesh, tiled by XLA.

Communication: one (p x n) psum per stage — n/p collectives riding ICI,
overlapping naturally with the local matmuls of neighbouring stages.

The factor L is returned row-sharded (same layout as A); D and the panel
diagonal factors are replicated (every device computed them).  The solve
walks panels with one tiny psum per stage (O(n^2) total work).

Matches the unsharded :func:`ipmzoo.ops.blocked_ldlt.ldlt_blocked`
factor exactly in exact arithmetic (same elimination order, same pivot
floor — reference semantics /root/reference/src/NumericalOptimization/
LinearSolvers.cpp:26-28).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import NamedSharding, PartitionSpec as P

from .ldlt import PIVOT_FLOOR, ldlt


def _factor_body(A_loc, *, n, rpd, panel, axis, pivot_floor):
    """shard_map body: A_loc is this device's (rpd, n) row block."""
    d = lax.axis_index(axis)
    dtype = A_loc.dtype
    L_loc = jnp.zeros_like(A_loc)
    Lds, Ds = [], []
    for j in range(0, n, panel):
        p = min(panel, n - j)
        o, jr = j // rpd, j % rpd          # owner device / local row offset
        is_owner = d == o
        rows = lax.psum(
            jnp.where(is_owner, A_loc[jr:jr + p, :], 0), axis)
        Ljj, Dj = ldlt(rows[:, j:j + p], pivot_floor)
        Lds.append(Ljj)
        Ds.append(Dj)
        # owner stores the diagonal block into its rows of L
        L_loc = L_loc.at[jr:jr + p, j:j + p].add(
            jnp.where(is_owner, Ljj, jnp.zeros((p, p), dtype)))
        if j + p < n:
            T = solve_triangular(Ljj, rows[:, j + p:], lower=True,
                                 unit_diagonal=True)       # (p, n-j-p)
            Tf = jnp.zeros((p, n), dtype).at[:, j + p:].set(T)
            # this device's columns of T = transposed rows of L21; zero
            # for rows at/before the panel, so the updates below are
            # no-ops exactly where they must be
            Td = lax.dynamic_slice(Tf, (jnp.zeros((), d.dtype), d * rpd),
                                   (p, rpd))
            L21_loc = (Td / Dj[:, None]).T                  # (rpd, p)
            L_loc = L_loc.at[:, j:j + p].add(L21_loc)
            A_loc = A_loc.at[:, j + p:].add(-(L21_loc @ T))
    return L_loc, tuple(Lds), jnp.concatenate(Ds)


def _solve_body(L_loc, Lds, D, b, *, n, rpd, panel, axis):
    """shard_map body: solve L D L^T x = b, b replicated."""
    d = lax.axis_index(axis)
    stages = list(range(0, n, panel))
    # forward: L y = b (owner solves its panel rows, psum broadcasts)
    y = jnp.zeros_like(b)
    for i, j in enumerate(stages):
        p = min(panel, n - j)
        o, jr = j // rpd, j % rpd
        rhs = b[j:j + p] - L_loc[jr:jr + p, :j] @ y[:j]
        yj = solve_triangular(Lds[i], rhs, lower=True, unit_diagonal=True)
        yj = lax.psum(jnp.where(d == o, yj, 0), axis)
        y = y.at[j:j + p].set(yj)
    z = y / D
    # backward: L^T x = z (column blocks of L are spread over devices:
    # every device contributes its local rows' partial products)
    x = jnp.zeros_like(b)
    for i, j in reversed(list(enumerate(stages))):
        p = min(panel, n - j)
        x_loc = lax.dynamic_slice(x, (d * rpd,), (rpd,))
        contrib = lax.psum(L_loc[:, j:j + p].T @ x_loc, axis)
        xj = solve_triangular(Lds[i].T, z[j:j + p] - contrib,
                              lower=False, unit_diagonal=True)
        x = x.at[j:j + p].set(xj)
    return x


def _plan(n, mesh, axis, panel):
    ndev = mesh.shape[axis]
    if n % ndev:
        raise ValueError(f"n={n} must divide over {ndev} devices")
    rpd = n // ndev
    if panel is None:
        panel = min(128, rpd)
    if rpd % panel:
        raise ValueError(f"panel={panel} must divide rows/device={rpd}")
    return rpd, panel


def sharded_ldlt(A, mesh, axis: str = "tp", panel: int | None = None,
                 pivot_floor: float = PIVOT_FLOOR):
    """Factor a row-sharded symmetric quasi-definite A = L D L^T.

    Returns (L, Lds, D): L row-sharded like A, the per-panel diagonal
    factors and D replicated.
    """
    n = A.shape[-1]
    rpd, panel = _plan(n, mesh, axis, panel)
    body = functools.partial(_factor_body, n=n, rpd=rpd, panel=panel,
                             axis=axis, pivot_floor=pivot_floor)
    nstages = (n + panel - 1) // panel
    fn = jax.shard_map(
        body, mesh=mesh, in_specs=P(axis, None),
        out_specs=(P(axis, None), (P(),) * nstages, P()),
        check_vma=False)
    return jax.jit(fn)(A)


def sharded_ldlt_solve(factors, b, mesh, axis: str = "tp",
                       panel: int | None = None):
    """Solve K x = b from :func:`sharded_ldlt` factors; b replicated."""
    L, Lds, D = factors
    n = L.shape[-1]
    rpd, panel = _plan(n, mesh, axis, panel)
    if panel != Lds[0].shape[0]:
        panel = Lds[0].shape[0]
        rpd, panel = _plan(n, mesh, axis, panel)
    body = functools.partial(_solve_body, n=n, rpd=rpd, panel=panel,
                             axis=axis)
    nstages = len(Lds)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), (P(),) * nstages, P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(fn)(L, tuple(Lds), D, b)


def shard_kkt(A, mesh, axis: str = "tp"):
    """Place a KKT matrix row-sharded over the mesh axis."""
    return jax.device_put(A, NamedSharding(mesh, P(axis, None)))
