"""Banded + arrow structured KKT factorization.

Generalises the MPC/Riccati structured path (ops/riccati.py) to KKT
matrices that are *banded with an arrow*: a leading block that is
symmetric banded (half-bandwidth b) plus a small set of t dense trailing
rows/columns (coupling variables, dense constraint duals).  The dense
path factors such a system in O(n^3); here it is

    * block-tridiagonal Cholesky of the banded part — a ``lax.scan`` of
      N = nb/b stages of (b x b) block ops, O(nb * b^2) (static shapes,
      a small-matrix chain; ``vmap`` adds an instance batch axis);
    * one banded multi-rhs solve for the t arrow columns + a dense
      (t x t) Schur-complement factor, O(nb * b * t + t^3).

A banded matrix with half-bandwidth b is exactly block-tridiagonal with
block size b (|i-j| <= b implies entries live in the diagonal and first
sub-diagonal block of the b-blocking), so the representation is

    D: (N, b, b) diagonal blocks      E: (N-1, b, b) sub-diagonal blocks
    U: (t, nb)   arrow strip          C: (t, t)      arrow tip

:func:`detect_arrow` recovers (bandwidth, tip, permutation) from a dense
symmetric matrix: columns whose off-diagonal extent exceeds the target
bandwidth are moved to the tail (compressing indices never grows the
remaining band), mirroring what a sparse-direct ordering would do.

The symbolic layer plays the same role as for the dense path: the
*reference*'s elimination is row-at-a-time symbolic Gaussian elimination
(/root/reference/src/SymbolicOptimization.cpp:529-567) which is blind to
numeric sparsity; this module is the numeric counterpart this build
adds on top (SURVEY §5 "scaling axes": problem size n).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import cho_solve, solve_triangular

from .routes import arrow_method


class ArrowStructure(NamedTuple):
    """Host-side structure descriptor from :func:`detect_arrow`."""
    perm: np.ndarray        # permutation: banded columns first, wide last
    bandwidth: int          # half-bandwidth of the permuted leading block
    tip: int                # number of trailing (dense) arrow columns


def _rcm_order(n, ii, jj):
    """Reverse Cuthill-McKee ordering of the graph with edges (ii, jj)
    over nodes 0..n-1 — recovers a low-bandwidth ordering of a banded
    matrix whose rows were arbitrarily permuted."""
    adj = [[] for _ in range(n)]
    for a, b in zip(ii, jj):
        adj[a].append(b)
        adj[b].append(a)
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n, dtype=bool)
    order = []
    for start in np.argsort(deg, kind="stable"):   # min-degree seeds
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            order.append(u)
            nbrs = [v for v in adj[u] if not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                visited[v] = True
            queue.extend(nbrs)
    return np.array(order[::-1], dtype=np.int64)


def detect_arrow(Q, max_tip_frac: float = 0.25,
                 tol: float = 0.0) -> ArrowStructure:
    """Detect banded+arrow structure in a dense symmetric matrix.

    Three stages, all host-side numpy, run once per problem structure:

    1. *hub peel*: columns whose degree dwarfs the median are coupling
       (arrow) columns — move them to the tail;
    2. *RCM*: Reverse Cuthill-McKee reorders the remainder to minimise
       bandwidth, so the detection is permutation-invariant (a shuffled
       banded matrix is recovered);
    3. *greedy refinement*: while the widest remaining off-band pair
       dominates, peel the column incident to the most over-band pairs;
       every configuration is scored with the structured factor cost
       nb*(b + t)^2 + t^3 and the best wins.

    Compressing surviving columns' indices never grows their pairwise
    distances, so the reported bandwidth is valid for the returned
    permutation.
    """
    Q = np.asarray(Q)
    n = Q.shape[0]
    nz = np.abs(Q) > tol
    np.fill_diagonal(nz, False)
    ii0, jj0 = np.nonzero(np.triu(nz, 1))
    if ii0.size == 0:
        return ArrowStructure(np.arange(n), 1, 0)

    # stage 1: hub peel by degree
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, ii0, 1)
    np.add.at(deg, jj0, 1)
    med = np.median(deg[deg > 0])
    hubs = deg > max(8.0, 4.0 * med)
    if hubs.sum() > max_tip_frac * n:      # no separation: keep all
        hubs[:] = False

    # stage 2: RCM on the non-hub subgraph
    keep = ~hubs
    sub_edge = keep[ii0] & keep[jj0]
    old2sub = np.cumsum(keep) - 1
    sub_order = _rcm_order(int(keep.sum()), old2sub[ii0[sub_edge]],
                           old2sub[jj0[sub_edge]])
    sub_cols = np.nonzero(keep)[0]
    perm0 = np.concatenate([sub_cols[sub_order], np.nonzero(hubs)[0]])

    # re-express the pair list in perm0 coordinates for stage 3
    pos = np.empty(n, dtype=np.int64)
    pos[perm0] = np.arange(n)
    ii, jj = pos[ii0], pos[jj0]
    removed = np.zeros(n, dtype=bool)
    removed[int(keep.sum()):] = True       # hubs start in the tip
    # rank of each column among the survivors (compressed index)
    def current_cost():
        rank = np.cumsum(~removed) - 1
        alive = ~(removed[ii] | removed[jj])
        if not alive.any():
            b = 1
        else:
            b = max(1, int(np.max(np.abs(rank[ii[alive]] -
                                         rank[jj[alive]]))))
        t = int(removed.sum())
        return (n - t) * (b + t) ** 2 + t ** 3, b, t

    best_cost, best_b, best_t = current_cost()
    best_removed = removed.copy()
    max_tip = int(max_tip_frac * n)
    stale = 0
    for _ in range(max_tip):
        if stale >= 8:      # bandwidth stopped improving: peeling more
            break           # only grows the tip term of the cost
        rank = np.cumsum(~removed) - 1
        alive = ~(removed[ii] | removed[jj])
        if not alive.any():
            break
        d = np.abs(rank[ii] - rank[jj])
        d = np.where(alive, d, 0)
        b_now = int(d.max())
        # peel the column incident to the most pairs at distance > b/2 —
        # arrow columns touch O(n) such pairs, banded ones O(bandwidth)
        far = d > max(1, b_now // 2)
        score = np.zeros(n, dtype=np.int64)
        np.add.at(score, ii[far], 1)
        np.add.at(score, jj[far], 1)
        removed[int(np.argmax(score))] = True
        cost, b, t = current_cost()
        if cost < best_cost:
            best_cost, best_b, best_t = cost, b, t
            best_removed = removed.copy()
            stale = 0
        else:
            stale += 1

    perm_local = np.concatenate([np.nonzero(~best_removed)[0],
                                 np.nonzero(best_removed)[0]])
    return ArrowStructure(perm0[perm_local], best_b, best_t)


# ----------------------------------------------------------------------
# block-tridiagonal SPD Cholesky (scan over blocks)
# ----------------------------------------------------------------------

class BTFactors(NamedTuple):
    L: jnp.ndarray    # (N, b, b) lower Cholesky factors of the pivots
    C: jnp.ndarray    # (N, b, b) C[i] = E[i] L[i]^{-T}; C[N-1] unused


def bt_factor(D: jnp.ndarray, E: jnp.ndarray) -> BTFactors:
    """Block-tridiagonal Cholesky: K = Lb Lb^T with block-bidiagonal Lb.

    D: (N, b, b) diagonal blocks (SPD after barrier condensation),
    E: (N-1, b, b) sub-diagonal blocks (block row i+1, column i).
    """
    N, b = D.shape[0], D.shape[-1]
    Epad = jnp.concatenate([E, jnp.zeros((1, b, b), D.dtype)], axis=0)

    def body(S, inputs):
        Enext, Dnext = inputs
        L = jnp.linalg.cholesky(S)
        # C = E L^{-T}  (solve L C^T = E^T)
        Ct = solve_triangular(L, jnp.swapaxes(Enext, -1, -2), lower=True)
        C = jnp.swapaxes(Ct, -1, -2)
        S_next = Dnext - C @ jnp.swapaxes(C, -1, -2)
        return S_next, (L, C)

    # last scan step consumes a zero E and a dummy D_next
    Dnext = jnp.concatenate([D[1:], jnp.eye(b, dtype=D.dtype)[None]],
                            axis=0)
    _, (L, C) = jax.lax.scan(body, D[0], (Epad, Dnext))
    return BTFactors(L=L, C=C)


def bt_solve(f: BTFactors, r: jnp.ndarray) -> jnp.ndarray:
    """Solve the block-tridiagonal system for rhs r of shape (N, b, k)
    (k right-hand sides, blocked like D)."""
    L, C = f.L, f.C
    b = L.shape[-1]
    zeros = jnp.zeros_like(r[0])

    def fwd(y_prev, inputs):
        Li, Ci_prev, ri = inputs
        y = solve_triangular(Li, ri - Ci_prev @ y_prev, lower=True)
        return y, y

    Cprev = jnp.concatenate([jnp.zeros((1, b, b), L.dtype), C[:-1]],
                            axis=0)
    _, y = jax.lax.scan(fwd, zeros, (L, Cprev, r))

    def bwd(z_next, inputs):
        Li, Ci, yi = inputs
        z = solve_triangular(
            jnp.swapaxes(Li, -1, -2),
            yi - jnp.swapaxes(Ci, -1, -2) @ z_next, lower=False)
        return z, z

    _, z = jax.lax.scan(bwd, zeros, (L, C, y), reverse=True)
    return z


# ----------------------------------------------------------------------
# block cyclic reduction: batched levels instead of a sequential scan
# ----------------------------------------------------------------------
#
# The scan factorisation above is a chain of N sequential
# cholesky/triangular-solve stages, each a separate device op whose
# launch latency does not shrink with its size.  Cyclic reduction eliminates all ODD blocks of a level simultaneously —
# log2(N) levels of BATCHED (m, b, b) operations — trading ~2x flops
# (all batched matmuls) for a 6x shorter dependency chain.  Eliminating the
# odd blocks of an SPD block-tridiagonal matrix is a symmetrically
# permuted block Cholesky (nested-dissection order), so SPD is preserved
# level to level.  Explicit pivot inverses are stored so the SOLVES are
# pure batched matmuls (no triangular solves on the critical path).


class CRLevel(NamedTuple):
    Pinv: jnp.ndarray   # (m/2, b, b) inverses of the odd pivots
    Eb: jnp.ndarray     # (m/2, b, b) left couplings  E[2k]
    Ea: jnp.ndarray     # (m/2, b, b) right couplings E[2k+1] (last = 0)


class CRFactors(NamedTuple):
    levels: tuple       # CRLevel per reduction level
    root_inv: jnp.ndarray   # (b, b) inverse of the final 1x1-block pivot
    n_blocks: int       # original (unpadded) block count


def _spd_inv(M):
    """Batched SPD inverse via Cholesky (stable for the IPM's barrier-
    condensed diagonal blocks)."""
    L = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    Li = solve_triangular(L, eye, lower=True)
    return jnp.swapaxes(Li, -1, -2) @ Li


def cr_factor(D: jnp.ndarray, E: jnp.ndarray) -> CRFactors:
    """Cyclic-reduction factorisation of an SPD block-tridiagonal
    matrix.  D: (N, b, b), E: (N-1, b, b) sub-diagonal blocks."""
    N, b = D.shape[0], D.shape[-1]
    m = 1
    while m < N:
        m *= 2
    if m != N:      # pad with identity blocks, zero couplings
        pad = m - N
        D = jnp.concatenate(
            [D, jnp.broadcast_to(jnp.eye(b, dtype=D.dtype),
                                 (pad, b, b))], axis=0)
    Ez = jnp.zeros((1, b, b), D.dtype)
    E = jnp.concatenate([E] + [Ez] * (m - E.shape[0]), axis=0)  # (m,b,b)

    levels = []
    while m > 1:
        Po = D[1::2]
        Eb = E[0::2]
        Ea = E[1::2]
        Pinv = _spd_inv(Po)
        levels.append(CRLevel(Pinv=Pinv, Eb=Eb, Ea=Ea))
        PiEb = Pinv @ Eb                       # (m/2, b, b)
        De = D[0::2]
        De = De - jnp.swapaxes(Eb, -1, -2) @ PiEb
        left = Ea @ Pinv @ jnp.swapaxes(Ea, -1, -2)
        De = De.at[1:].add(-left[:-1])
        Enew = -(Ea @ PiEb)                    # E'[k], last entry 0
        D, E, m = De, Enew, m // 2
    return CRFactors(levels=tuple(levels), root_inv=_spd_inv(D[0:1])[0],
                     n_blocks=N)


def cr_solve(f: CRFactors, r: jnp.ndarray) -> jnp.ndarray:
    """Solve with :func:`cr_factor` factors; r: (N, b, k)."""
    N, b, k = r.shape
    m = 1
    while m < N:
        m *= 2
    if m != N:
        r = jnp.concatenate([r, jnp.zeros((m - N, b, k), r.dtype)],
                            axis=0)
    # down-sweep: fold odd rhs into even neighbours
    stack = []
    for lev in f.levels:
        ro = r[1::2]
        g = lev.Pinv @ ro                      # (m/2, b, k)
        re = r[0::2]
        re = re - jnp.swapaxes(lev.Eb, -1, -2) @ g
        re = re.at[1:].add(-(lev.Ea @ g)[:-1])
        stack.append(ro)
        r = re
        m //= 2
    # root
    x = (f.root_inv @ r[0])[None]              # (1, b, k)
    # up-sweep: recover odd unknowns
    for lev, ro in zip(reversed(f.levels), reversed(stack)):
        m2 = x.shape[0]
        xe_next = jnp.concatenate(
            [x[1:], jnp.zeros((1, b, k), x.dtype)], axis=0)
        rhs = ro - lev.Eb @ x - jnp.swapaxes(lev.Ea, -1, -2) @ xe_next
        xo = lev.Pinv @ rhs
        xi = jnp.stack([x, xo], axis=1).reshape(2 * m2, b, k)
        x = xi
    return x[:N]


# ----------------------------------------------------------------------
# arrow = block-tridiagonal + dense tip, via Schur complement
# ----------------------------------------------------------------------

class ArrowFactors(NamedTuple):
    bt: object              # BTFactors (scan) or CRFactors (cyclic red.)
    W: jnp.ndarray          # (N, b, t) = B^{-1} U^T, blocked
    tip_chol: jnp.ndarray   # (t, t) lower Cholesky of the tip Schur


def _bsolve(fac, r):
    return cr_solve(fac, r) if isinstance(fac, CRFactors) else \
        bt_solve(fac, r)


def _banded_factor(D, E, method: str):
    method = arrow_method(method, D.shape[0])
    return cr_factor(D, E) if method == "cr" else bt_factor(D, E)


def arrow_factor(D, E, U, Ctip, method: str = "auto") -> ArrowFactors:
    """Factor [[B, U^T], [U, Ctip]] with B block-tridiagonal SPD (given
    as D, E) and t = Ctip.shape[0] dense arrow rows (SPD overall).

    ``method``: "scan" (sequential stages — lowest flops), "cr" (cyclic
    reduction — log2(N) BATCHED levels, ~2x flops but a 6x shorter
    dependency chain), or "auto" (:func:`.routes.arrow_method`: cr for
    N >= 8, else scan)."""
    N, b = D.shape[0], D.shape[-1]
    t = Ctip.shape[0]
    fac = _banded_factor(D, E, method)
    if t == 0:
        return ArrowFactors(bt=fac, W=jnp.zeros((N, b, 0), D.dtype),
                            tip_chol=jnp.zeros((0, 0), D.dtype))
    Ub = jnp.swapaxes(U.reshape(t, N, b), 0, 1)          # (N, b->?)
    Ub = jnp.swapaxes(Ub, 1, 2)                          # (N, b, t)
    W = _bsolve(fac, Ub)                                 # (N, b, t)
    S = Ctip - jnp.einsum("nbt,nbs->ts", W, Ub)
    return ArrowFactors(bt=fac, W=W, tip_chol=jnp.linalg.cholesky(S))


def arrow_factor_solve(D, E, U, Ctip, r_band, r_tip,
                       method: str = "auto"):
    """:func:`arrow_factor` fused with one :func:`arrow_solve`.

    The banded multi-rhs solve for the t arrow columns and the solve for
    ``r_band`` share one ``_bsolve`` call with k = t+1 stacked rhs —
    one kernel launch (and one factor-slab read) fewer per IPM iteration
    than factor-then-solve, and the marginal rhs rides the same sweeps.
    Returns ``(factors, (x_band, x_tip))``; bitwise-identical factors
    and solution to the unfused pair (the stacked rhs are solved
    column-independently).
    """
    N, b = D.shape[0], D.shape[-1]
    t = Ctip.shape[0]
    fac = _banded_factor(D, E, method)
    rb = r_band.reshape(N, b, 1)
    if t == 0:
        w = _bsolve(fac, rb)
        factors = ArrowFactors(bt=fac, W=jnp.zeros((N, b, 0), D.dtype),
                               tip_chol=jnp.zeros((0, 0), D.dtype))
        return factors, (w[..., 0].reshape(-1), r_tip)
    Ub = jnp.swapaxes(U.reshape(t, N, b), 0, 1)
    Ub = jnp.swapaxes(Ub, 1, 2)                          # (N, b, t)
    sol = _bsolve(fac, jnp.concatenate([Ub, rb], axis=-1))
    W, w = sol[..., :t], sol[..., t]                     # (N,b,t),(N,b)
    S = Ctip - jnp.einsum("nbt,nbs->ts", W, Ub)
    tip_chol = jnp.linalg.cholesky(S)
    factors = ArrowFactors(bt=fac, W=W, tip_chol=tip_chol)
    Urw = jnp.einsum("nbt,nb->t", W, rb[..., 0])
    x_tip = cho_solve((tip_chol, True), r_tip - Urw)
    x_band = (w - jnp.einsum("nbt,t->nb", W, x_tip)).reshape(-1)
    return factors, (x_band, x_tip)


def arrow_solve(f: ArrowFactors, r_band: jnp.ndarray,
                r_tip: jnp.ndarray) -> tuple:
    """Solve for rhs (r_band: (nb,), r_tip: (t,)); returns (x_band, x_tip).
    """
    N, b, t = f.W.shape
    rb = r_band.reshape(N, b, 1)
    w = _bsolve(f.bt, rb)                                # (N, b, 1)
    if t == 0:
        return w[..., 0].reshape(-1), r_tip
    # U B^{-1} r = (B^{-1} U^T)^T r = W^T r  (B symmetric)
    Urw = jnp.einsum("nbt,nb->t", f.W, rb[..., 0])
    x_tip = cho_solve((f.tip_chol, True), r_tip - Urw)
    # x_band = B^{-1}(r - U^T x_tip) = w - W x_tip
    x_band = (w[..., 0] - jnp.einsum("nbt,t->nb", f.W, x_tip)).reshape(-1)
    return x_band, x_tip


def band_to_blocks(H: jnp.ndarray, b: int, t: int):
    """Split a dense banded+arrow matrix (already permuted) into the
    structured representation (D, E, U, Ctip).  nb = n - t must be a
    multiple of b (pad upstream if needed)."""
    n = H.shape[0]
    nb = n - t
    if nb % b:
        raise ValueError(f"banded part {nb} not a multiple of block {b}")
    N = nb // b
    Hb = H[:nb, :nb].reshape(N, b, N, b)
    D = Hb[jnp.arange(N), :, jnp.arange(N), :]
    E = Hb[jnp.arange(1, N), :, jnp.arange(N - 1), :] if N > 1 else \
        jnp.zeros((0, b, b), H.dtype)
    U = H[nb:, :nb]
    Ctip = H[nb:, nb:]
    return D, E, U, Ctip
