"""Nested-dissection factorisation for general sparse KKT systems.

The framework's structured paths so far exploit two FIXED patterns:
block-tridiagonal (models/mpc.py, Riccati) and banded+arrow
(models/arrow.py, cyclic reduction).  This module closes SURVEY §5
scaling axis (c) for GENERAL sparsity: any symmetric quasi-definite KKT
matrix whose graph has small separators (grids, meshes, chains, trees,
circuit-like couplings) factors in far fewer flops than the dense
O(n^3) LDL^T, on a schedule of a few batched device ops per level.

The reference has no sparse path at all — its elimination is symbolic
and dense (/root/reference/src/SymbolicOptimization.cpp:465-478 derives
reductions; LinearSolvers.cpp factors dense).  This is a redesign, not a
port:

* The sparsity STRUCTURE is static (it comes from the problem's Q/A
  patterns), so all graph work — separator tree, elimination order,
  fill-in (symbolic factorisation), per-level padding — happens on the
  HOST at plan-build time (numpy).  The device program sees only static
  shapes and constant index arrays.
* Supernodes at the same elimination-tree height are independent, so
  each tree level runs as ONE batch of equal-padded dense blocks:
  a batched pivot-floored LDL^T of the (B, k, k) diagonal blocks, a
  batched triangular solve for the (B, k, m) boundary coupling, one
  einsum for the (B, m, m) Schur updates, and ONE scatter-add into the
  work matrix.  Sequential depth is O(log n) levels x ~5 XLA ops — not
  O(n) columns.
* Quasi-definite safety: the unpivoted LDL^T with a zero-pivot floor is
  stable for symmetric quasi-definite matrices under ANY symmetric
  permutation (Vanderbei 1995 — they are "strongly factorizable"), so
  the dissection ordering needs no numerical pivoting.

Padding convention: supernodes within a level are padded to the level's
max block/boundary size with a DUMMY variable index n (one extra
row/col).  Gathered blocks are masked back to identity on dummy slots,
and every scattered update is masked to zero there, so the dummy
row/col never contaminates live data.

The separator finder is a BFS level-set bisection from a
pseudo-peripheral vertex — cheap, exact on grids/bands/trees, and
merely suboptimal (never wrong) on expander-like graphs, which fall
back toward dense behaviour gracefully.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from .ldlt import PIVOT_FLOOR, batched_ldlt


# ---------------------------------------------------------------------------
# host-side plan construction (numpy only — runs once at trace time)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NDLevel:
    """One elimination-tree level: B supernodes padded to (k, m).

    All indices are in the PLAN'S PERMUTED coordinate system (variables
    laid out node-run by node-run in elimination order) — that is what
    makes the device program scatter-free: diagonal blocks become
    contiguous (k, k) slabs, boundary blocks a row-gather plus one
    contiguous column slab, and Schur updates flow parent-ward through
    per-node update matrices (multifrontal) instead of scatter-adds
    into a global work matrix (element-wise gathers and scatter-adds
    of that size cost an order of magnitude more than the slab
    forms)."""
    idx: np.ndarray      # (B, k) int32 permuted var indices, dummy = n
    valid: np.ndarray    # (B, k) float mask, 1 on live slots
    bnd: np.ndarray      # (B, m) int32 permuted boundary idx, dummy = n
    bvalid: np.ndarray   # (B, m) float mask
    off: np.ndarray      # (B,) int32 var-run start (permuted order)
    child_ids: np.ndarray   # (B, C) int32 node ids, pad = num_nodes
    child_map: np.ndarray   # (B, C, m_max) int32 frontal position of the
    #                         child's t-th boundary column, pad = k + m


@dataclasses.dataclass(frozen=True)
class NDPlan:
    n: int
    levels: Tuple[NDLevel, ...]
    flops_nd: int        # sum over supernodes of k^3/3 + k^2 m + k m^2
    flops_dense: int     # n^3 / 3
    perm: np.ndarray = None       # (n,) permuted position -> original var
    m_max: int = 0                # max padded boundary width over levels
    num_nodes: int = 0
    level_id0: Tuple[int, ...] = ()   # first node id of each level
    #: amalgamated-top signed-Cholesky split: the last level is a single
    #: merged supernode whose first ``top_neg`` variables carry negative
    #: structural sign (dual rows) and the rest positive — factored by
    #: two dense Cholesky stages instead of the sequential-column LDL^T.
    #: -1 = no signed top (generic per-level kernels everywhere).
    top_neg: int = -1


#: Time-based cost model, CALIBRATED against the measured nd/dense
#: crossover table on the H100 (tools/nd_crossover.py: f32 grid QPs
#: g = 16..64, one IPM step inside a compiled loop, interleaved
#: two-trip-count slope timing; NNLS fit on relative error; table in
#: PERF.md).  A flop-only model cannot see the dense path's latency
#: floor nor nd's fixed per-level cost.
#:
#:   t_nd    = ND_T_LEVEL * levels + 2 * flops_nd / ND_FLOP_RATE
#:   t_dense = DENSE_T_FLOOR + DENSE_A * n^2 + DENSE_B * n^3
#:
#: On the card the fit puts no weight on the cubic term up to n = 4096
#: (the dense step is launch- and memory-bound there).  It predicts the
#: measured win/loss at g = 24..64; at g = 16 (n = 256) the dense path
#: runs the sequential column LDL^T and is far slower than the model.
ND_T_LEVEL = 3.63e-4       # s per device level (launch + glue)
ND_FLOP_RATE = 2.25e11     # effective FLOP/s of the batched level ops
DENSE_T_FLOOR = 4.05e-4    # s; latency floor of one dense step
DENSE_A = 1.57e-10         # s per n^2 (assembly/memory-bound share)
DENSE_B = 0.0              # s per n^3 (factor share)


def nd_predicted_speedup(plan: NDPlan) -> float:
    """Predicted step speedup of the plan vs the dense factorisation
    from the calibrated time model above.  > 1 means the plan is
    predicted to win; CompiledIPM's auto-fallback refuses plans below
    its threshold so a losing nd plan is never silently selected."""
    t_nd = ND_T_LEVEL * len(plan.levels) + \
        2.0 * plan.flops_nd / ND_FLOP_RATE
    n = float(plan.n)
    t_dense = DENSE_T_FLOOR + DENSE_A * n * n + DENSE_B * n ** 3
    return t_dense / max(t_nd, 1e-12)


def _bfs_levels(adj: List[np.ndarray], start: int,
                members: np.ndarray) -> List[np.ndarray]:
    """BFS level sets of the subgraph induced by ``members`` (bool mask)."""
    seen = np.zeros(len(adj), bool)
    seen[~members] = True
    seen[start] = True
    frontier = [start]
    out = []
    while frontier:
        out.append(np.asarray(frontier, np.int64))
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if not seen[w]:
                    seen[w] = True
                    nxt.append(w)
        frontier = nxt
    return out


def _components(adj: List[np.ndarray], verts: np.ndarray) -> List[np.ndarray]:
    members = np.zeros(len(adj), bool)
    members[verts] = True
    comps = []
    for v in verts:
        if members[v]:
            levels = _bfs_levels(adj, int(v), members)
            comp = np.concatenate(levels)
            members[comp] = False
            comps.append(np.sort(comp))
    return comps


def _separate(adj: List[np.ndarray], verts: np.ndarray):
    """Split connected ``verts`` into (A, B, sep) by a BFS level-set cut
    from a pseudo-peripheral vertex.  Returns None if no useful cut
    exists (near-clique)."""
    members = np.zeros(len(adj), bool)
    members[verts] = True
    # pseudo-peripheral start: farthest vertex from an arbitrary one
    levels = _bfs_levels(adj, int(verts[0]), members)
    levels = _bfs_levels(adj, int(levels[-1][0]), members)
    if len(levels) < 3:
        return None
    sizes = np.array([len(l) for l in levels])
    total = sizes.sum()
    below = np.cumsum(sizes) - sizes  # vars strictly before level i
    # pick the separator level minimising the larger side
    worst = np.maximum(below, total - below - sizes)
    cand = np.arange(1, len(levels) - 1)
    ell = int(cand[np.argmin(worst[cand])])
    A = np.concatenate(levels[:ell])
    B = np.concatenate(levels[ell + 1:])
    sep = levels[ell]
    if len(A) == 0 or len(B) == 0 or len(sep) >= 0.5 * total:
        return None
    return np.sort(A), np.sort(B), np.sort(sep)


@dataclasses.dataclass
class _Node:
    vars: np.ndarray                 # this supernode's variables
    children: list                   # child _Nodes
    boundary: np.ndarray = None      # filled by _symbolic_factor
    height: int = 0


def _dissect(adj, verts: np.ndarray, leaf: int) -> List[_Node]:
    """Dissect ``verts`` into a forest of supernode trees (a forest when
    the induced subgraph is disconnected)."""
    comps = _components(adj, verts)
    nodes = []
    for comp in comps:
        if len(comp) <= leaf:
            nodes.append(_Node(vars=comp, children=[]))
            continue
        cut = _separate(adj, comp)
        if cut is None:
            nodes.append(_Node(vars=comp, children=[]))
            continue
        A, B, sep = cut
        children = _dissect(adj, A, leaf) + _dissect(adj, B, leaf)
        nodes.append(_Node(vars=sep, children=children))
    return nodes


def _symbolic_factor(adj, roots: List[_Node]) -> List[_Node]:
    """Compute each supernode's boundary (its row structure in the block
    factor, fill included) and height; return all supernodes."""
    out = []

    def visit(node, ancestors: np.ndarray):
        anc = np.zeros(len(adj), bool)
        anc[ancestors] = True
        own = np.zeros(len(adj), bool)
        own[node.vars] = True
        bset = np.zeros(len(adj), bool)
        h = 0
        child_anc = np.concatenate([ancestors, node.vars])
        for c in node.children:
            visit(c, child_anc)
            bset[c.boundary] = True
            h = max(h, c.height + 1)
        for v in node.vars:
            bset[adj[v]] = True
        # boundary = (direct neighbours ∪ child boundaries) that are
        # ancestors — everything else is inside the subtree (eliminated)
        node.boundary = np.flatnonzero(bset & anc)
        node.height = h
        out.append(node)

    for r in roots:
        visit(r, np.zeros((0,), np.int64))
    return out


def _amalgamate_top(nodes_all: list, root_merge: int,
                    signs: np.ndarray = None):
    """Merge the TOP of the separator tree into one dense supernode.

    Every device level costs ~8-10 device ops of fixed latency
    regardless of its flop count, and the upper separator levels hold
    only a few tiny nodes (at g=64/leaf=64, levels 3-6 carry 13 nodes /
    ~336 variables in total).  Amalgamating all nodes
    of height >= H (an upper-closed set: height strictly increases
    toward the root, so their united boundary is internal) into ONE
    supernode factors those ~336 variables as a single dense block
    — a classical supernode amalgamation, applied at the tree top where
    the latency/flop trade is most lopsided.  ``root_merge`` caps the
    merged variable count; H is the smallest height whose upper set
    fits, with H >= 1 so leaves never merge.

    ``signs``: optional (n,) +-1 structural signs (positive primal /
    negative dual groups, the same signs ops/blockg.py uses).  When
    given, the merged block's variables are ordered negatives-first so
    the device factorisation can run as TWO dense Cholesky stages
    (chol(-N), then chol of the positive Schur complement — Vanderbei's
    quasi-definite factorizability) instead of a k-step sequential
    LDL^T; identity-padded dummy slots land in the trailing positive
    block.  Returns (nodes, top_neg) with top_neg = -1 when no signed
    top exists."""
    if root_merge <= 0:
        return nodes_all, -1
    maxh = max((nd.height for nd in nodes_all), default=0)
    best_h = None
    for H in range(1, maxh + 1):
        size = sum(len(nd.vars) for nd in nodes_all if nd.height >= H)
        if size and size <= root_merge:
            best_h = H
            break
    if best_h is None:
        return nodes_all, -1
    merged = [nd for nd in nodes_all if nd.height >= best_h]
    if len(merged) <= 1:
        return nodes_all, -1
    keep = [nd for nd in nodes_all if nd.height < best_h]
    merged_ids = {id(nd) for nd in merged}
    # level-by-level order inside the dense block (any symmetric order
    # is factorizable for quasi-definite K)
    tvars = np.concatenate(
        [nd.vars for h in range(best_h, maxh + 1)
         for nd in nodes_all if nd.height == h])
    top_neg = -1
    if signs is not None:
        sv = np.asarray(signs)[tvars]
        tvars = np.concatenate([tvars[sv < 0], tvars[sv >= 0]])
        top_neg = int((sv < 0).sum())
    top = _Node(
        vars=tvars,
        children=[c for nd in merged for c in nd.children
                  if id(c) not in merged_ids],
        height=best_h)
    own = set(top.vars.tolist())
    bset = sorted({int(v) for nd in merged for v in nd.boundary} - own)
    top.boundary = np.asarray(bset, np.int64)
    return keep + [top], top_neg


def nd_plan(pattern: np.ndarray, leaf: int = 32, pad_to: int = 8,
            root_merge: int = None, signs: np.ndarray = None) -> NDPlan:
    """Build the dissection plan for a symmetric sparsity ``pattern``
    ((n, n) bool; the diagonal is implicitly nonzero).

    ``leaf``: stop dissecting below this many variables.  ``pad_to``:
    round padded block sizes up to this multiple (sublane friendliness).
    ``root_merge``: amalgamate the top of the separator tree into one
    dense supernode of at most this many variables (0 disables;
    default min(512, n // 8) — the trade only pays while the merged
    block stays a small fraction of the problem) — see
    :func:`_amalgamate_top`.  ``signs``: optional (n,) +-1 structural
    signs enabling the merged top's two-stage Cholesky factorisation.
    """
    pattern = np.asarray(pattern)
    n = pattern.shape[0]
    if root_merge is None:
        root_merge = min(512, n // 8)
    if signs is not None and len(np.asarray(signs)) != n:
        signs = None
    sym = pattern | pattern.T
    np.fill_diagonal(sym, False)
    adj = [np.flatnonzero(sym[i]) for i in range(n)]

    roots = _dissect(adj, np.arange(n), leaf)
    nodes_all = _symbolic_factor(adj, roots)   # postorder
    nodes_all, top_neg = _amalgamate_top(nodes_all, root_merge, signs)

    # splice empty supernodes out of every children list so update
    # matrices always flow through a parent that exists (postorder:
    # an empty child's own list is already spliced when read here)
    for nd in nodes_all:
        nd.children = \
            [c for c in nd.children if len(c.vars)] + \
            [g for c in nd.children if not len(c.vars)
             for g in c.children]
    nodes = [nd for nd in nodes_all if len(nd.vars)]

    # group by height; pad each level to its max (k, m)
    def rup(x, m):
        return max(-(-x // m) * m, m) if x else 0

    maxh = max((nd.height for nd in nodes), default=0)
    groups = [g for g in ([nd for nd in nodes if nd.height == h]
                          for h in range(maxh + 1)) if g]

    # elimination-order permutation: node var-runs laid out level by
    # level; ids assigned in the same order (children always have
    # smaller ids than their parents)
    perm = np.concatenate([nd.vars for g in groups for nd in g]) \
        if nodes else np.zeros((0,), np.int64)
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(len(perm))
    nid = {}
    off_of = {}
    p = 0
    i = 0
    for g in groups:
        for nd in g:
            nid[id(nd)] = i
            off_of[id(nd)] = p
            i += 1
            p += len(nd.vars)
    num_nodes = i
    # per-node boundary in permuted coordinates, sorted — this order
    # defines the child's U column order AND the parent map below
    bnd_of = {id(nd): np.sort(pos[nd.boundary]) for g in groups
              for nd in g}

    level_m = [rup(max(len(nd.boundary) for nd in g), pad_to)
               for g in groups]
    m_max = max([max(m, 1) for m in level_m], default=1)

    levels = []
    level_id0 = []
    flops = 0
    for g, m in zip(groups, level_m):
        k = rup(max(len(nd.vars) for nd in g), pad_to)
        m = max(m, 1)
        B = len(g)
        C = max((len(nd.children) for nd in g), default=0)
        f = k + m
        idx = np.full((B, k), n, np.int32)
        val = np.zeros((B, k), np.float64)
        bnd = np.full((B, m), n, np.int32)
        bval = np.zeros((B, m), np.float64)
        off = np.zeros((B,), np.int32)
        cids = np.full((B, max(C, 1)), num_nodes, np.int32)
        cmap = np.full((B, max(C, 1), m_max), f, np.int32)
        for bi, nd in enumerate(g):
            kv, mv = len(nd.vars), len(nd.boundary)
            o = off_of[id(nd)]
            off[bi] = o
            idx[bi, :kv] = o + np.arange(kv)
            val[bi, :kv] = 1.0
            bp = bnd_of[id(nd)]
            bnd[bi, :mv] = bp
            bval[bi, :mv] = 1.0
            flops += kv ** 3 // 3 + kv * kv * mv + kv * mv * mv
            # frontal position of each global (permuted) index: S run
            # first (position - off), then the padded boundary slots
            fp = {int(q): k + j for j, q in enumerate(bp)}
            for ci, c in enumerate(nd.children):
                cids[bi, ci] = nid[id(c)]
                cb = bnd_of[id(c)]
                for t, q in enumerate(cb):
                    q = int(q)
                    if o <= q < o + kv:
                        cmap[bi, ci, t] = q - o
                    else:
                        cmap[bi, ci, t] = fp[q]
        levels.append(NDLevel(idx=idx, valid=val, bnd=bnd, bvalid=bval,
                              off=off, child_ids=cids, child_map=cmap))
        level_id0.append(nid[id(g[0])])
    if top_neg >= 0 and not (levels and levels[-1].idx.shape[0] == 1):
        top_neg = -1       # merged top vanished in the splice; be safe
    return NDPlan(n=n, levels=tuple(levels), flops_nd=flops,
                  flops_dense=n ** 3 // 3, perm=perm, m_max=m_max,
                  num_nodes=num_nodes, level_id0=tuple(level_id0),
                  top_neg=top_neg)


# ---------------------------------------------------------------------------
# device-side factor / solve (jit-compatible; plan arrays are constants)
# ---------------------------------------------------------------------------


def _level_route(method: str, k: int, op: str, interpret: bool):
    """Where a level's batched operation ``op`` runs: the batched Pallas
    kernels (ops/pallas_ldlt.py) or the plain vmapped XLA path, as
    :func:`.routes.batched_ldlt_route` decides for ``method`` ('auto',
    'pl' or 'jnp')."""
    from .routes import batched_ldlt_route
    return batched_ldlt_route(method, k, op, interpret=interpret)


def _factor_blocks(Kss, pivot_floor, method, interpret=False):
    route = _level_route(method, Kss.shape[-1], "factor", interpret)
    if route.kernel == "pallas":
        from .pallas_ldlt import batched_ldlt_pallas
        return batched_ldlt_pallas(Kss, pivot_floor,
                                   interpret=route.interpret)
    return batched_ldlt(Kss, pivot_floor)


def _solve_blocks(L, D, B):
    """Batched multi-rhs LDL^T solve: (B,k,k) factors x (B,k,m)."""

    def one(Li, Di, Bi):
        y = solve_triangular(Li, Bi, lower=True, unit_diagonal=True)
        z = y / Di[:, None]
        return solve_triangular(Li.T, z, lower=False, unit_diagonal=True)

    return jax.vmap(one)(L, D, B)


def _solve_vec_blocks(L, D, z, method="jnp", interpret=False):
    """Batched single-rhs LDL^T solve: (B,k,k) factors x (B,k)."""
    route = _level_route(method, L.shape[-1], "solve", interpret)
    if route.kernel == "pallas":
        from .pallas_ldlt import batched_solve_ldlt_pallas
        return batched_solve_ldlt_pallas(L, D, z, interpret=route.interpret)
    return jax.vmap(_fwd_back)(L, D, z)


def nd_prework(K: jnp.ndarray, plan: NDPlan):
    """Extract the per-level static slabs of ``K`` along the plan.

    Permutes K into elimination order (two row gathers + transposes,
    not an element-wise K[perm][:, perm] gather)
    and cuts, per level, the contiguous diagonal slabs Kss (B, k, k)
    and boundary blocks Ksb^T (B, m, k), masked/identity-padded.  An
    IPM iteration only changes the KKT's DIAGONAL, so callers inside a
    solver loop compute this ONCE outside the loop and pass it to
    :func:`nd_factor_pre` with just the per-iteration diagonal — XLA's
    loop-invariant code motion does not hoist gathers, so the hoisting
    is structural, not left to the compiler."""
    n, dt = plan.n, K.dtype
    perm = jnp.asarray(plan.perm)
    kmax = max((lev.idx.shape[1] for lev in plan.levels), default=1)
    npad = n + kmax + 1          # slack so (off, k) slabs never clamp
    Krp = jnp.take(K, perm, axis=0)
    Kperm = jnp.take(Krp.T, perm, axis=0).T
    Kpad = jnp.zeros((npad, npad), dt).at[:n, :n].set(Kperm)
    pre = []
    for lev in plan.levels:
        v = jnp.asarray(lev.valid, dt)
        bnd = jnp.asarray(lev.bnd)
        bv = jnp.asarray(lev.bvalid, dt)
        off = jnp.asarray(lev.off)
        B, k = lev.idx.shape
        m = lev.bnd.shape[1]
        Kss = jax.vmap(lambda o: jax.lax.dynamic_slice(
            Kpad, (o, o), (k, k)))(off)
        mask = v[:, :, None] * v[:, None, :]
        Kss = Kss * mask + jnp.eye(k, dtype=dt)[None] * \
            (1.0 - v)[:, :, None]
        Rb = jnp.take(Kpad, bnd.reshape(-1), axis=0).reshape(B, m, npad)
        KsbT = jax.vmap(lambda r, o: jax.lax.dynamic_slice(
            r, (jnp.asarray(0, o.dtype), o), (m, k)))(Rb, off)
        KsbT = KsbT * (bv[:, :, None] * v[:, None, :])
        pre.append((Kss, KsbT))
    return pre


def nd_factor_pre(pre, plan: NDPlan, diag_delta: jnp.ndarray = None,
                  pivot_floor: float = PIVOT_FLOOR, method: str = "auto",
                  interpret: bool = False):
    """Multifrontal factorisation from :func:`nd_prework` slabs.

    ``diag_delta``: optional (n,) vector (ORIGINAL coordinates) added
    to the diagonal — the per-iteration barrier terms.  Returns
    per-level factors [(L, D, W)] (unit-lower/diagonal LDL^T of each
    eliminated block, W = Kss^{-1} Ksb) — identical to the classical
    right-looking result, computed SCATTER-FREE: Schur updates flow
    parent-ward as per-node update matrices embedded with one-hot
    matmuls (extend-add) instead of scatter-adds into a global work
    matrix.  ``method``: 'auto', 'pl' or 'jnp', resolved per level by
    :func:`.routes.batched_ldlt_route`; ``interpret=True`` runs the
    Pallas levels in the interpreter (tests)."""
    dt = pre[0][0].dtype if pre else jnp.float32
    n = plan.n
    if diag_delta is not None:
        perm = jnp.asarray(plan.perm)
        kmax = max((lev.idx.shape[1] for lev in plan.levels), default=1)
        wpad = jnp.zeros((n + kmax + 1,), dt).at[:n].set(
            jnp.take(diag_delta, perm))
    mm = plan.m_max
    U_all = jnp.zeros((plan.num_nodes + 1, mm, mm), dt)
    out = []
    for lev, id0, (Kss, KsbT) in zip(plan.levels, plan.level_id0, pre):
        v = jnp.asarray(lev.valid, dt)
        bv = jnp.asarray(lev.bvalid, dt)
        off = jnp.asarray(lev.off)
        B, k = lev.idx.shape
        m = lev.bnd.shape[1]
        f = k + m
        if diag_delta is not None:
            # the only non-invariant input of the whole factorisation
            ws = jax.vmap(lambda o: jax.lax.dynamic_slice(
                wpad, (o,), (k,)))(off)
            kr = jnp.arange(k)
            Kss = Kss.at[:, kr, kr].add(ws * v)
        # frontal matrix: [[K_SS, K_SB], [K_BS, 0]] + child updates
        F = jnp.zeros((B, f, f), dt)
        F = F.at[:, :k, :k].set(Kss)
        F = F.at[:, :k, k:].set(jnp.swapaxes(KsbT, 1, 2))
        F = F.at[:, k:, :k].set(KsbT)
        if bool((lev.child_ids < plan.num_nodes).any()):
            cids = jnp.asarray(lev.child_ids)
            cu = jnp.take(U_all, cids.reshape(-1), axis=0).reshape(
                lev.child_ids.shape + (mm, mm))       # (B, C, mm, mm)
            cmap = jnp.asarray(lev.child_map)         # (B, C, mm)
            E = (cmap[..., None] ==
                 jnp.arange(f, dtype=jnp.int32)).astype(dt)  # (B,C,mm,f)
            T = jnp.einsum("bcij,bcjf->bcif", cu, E)
            F = F + jnp.einsum("bcie,bcif->bef", E, T)
        Kss_f = F[:, :k, :k]
        Ksb_f = F[:, :k, k:]
        if lev is plan.levels[-1] and plan.top_neg >= 0 and B == 1:
            # amalgamated top: two dense Cholesky stages (negatives
            # first, then the SPD Schur of the positive block —
            # Vanderbei quasi-definite factorizability), re-expressed
            # as unit-L/D so nd_solve is oblivious.  Replaces the
            # k-step sequential-column LDL^T the generic path would
            # run on a single large block.
            # The factor slot carries Linv (NOT L): the per-rhs top
            # solves in nd_solve become two matvecs instead of two
            # sequential triangular solves (the plan's top_neg >= 0
            # marks the convention).
            L, D = _signed_top_factor(Kss_f[0], plan.top_neg)
            eye = jnp.eye(k, dtype=dt)
            Linv = solve_triangular(L, eye, lower=True,
                                    unit_diagonal=True)
            W = (Linv.T @ ((Linv @ Ksb_f[0]) / D[:, None]))[None]
            L, D = Linv[None], D[None]
        else:
            L, D = _factor_blocks(Kss_f, pivot_floor, method, interpret)
            W = _solve_blocks(L, D, Ksb_f)
        U = (F[:, k:, k:] - jnp.einsum("bkm,bkj->bmj", Ksb_f, W)) * \
            (bv[:, :, None] * bv[:, None, :])
        out.append((L, D, W))
        Upad = jnp.zeros((B, mm, mm), dt).at[:, :m, :m].set(U)
        U_all = jax.lax.dynamic_update_slice(U_all, Upad, (id0, 0, 0))
    return out


def _signed_top_factor(Kf: jnp.ndarray, nneg: int):
    """Unit-L/D LDL^T of a quasi-definite block ordered negatives-first
    via two dense Cholesky stages (all matrix-product work):

        K = [[N, B^T], [B, P]],  N neg.def., P pos.def. (after any
        leading eliminations — quasi-definiteness is closed under
        Schur complements)

        Ln = chol(-N);  T = Ln^{-1} B^T;  Lp = chol(P + T^T T)
        K  = Lf Sigma Lf^T,  Lf = [[Ln, 0], [-T^T, Lp]],
        Sigma = diag(-I, +I)

    Returned as (L, D) with L unit-lower and D carrying the signs:
    L = Lf diag(1/diag(Lf)), D = sigma * diag(Lf)^2 — the exact format
    every other level produces, so the solve sweeps are unchanged."""
    k = Kf.shape[0]
    dt = Kf.dtype
    if nneg == 0:
        Lf = jnp.linalg.cholesky(Kf)
        sigma = jnp.ones((k,), dt)
    elif nneg == k:
        Lf = jnp.linalg.cholesky(-Kf)
        sigma = -jnp.ones((k,), dt)
    else:
        N = Kf[:nneg, :nneg]
        Bt = Kf[:nneg, nneg:]
        P = Kf[nneg:, nneg:]
        Ln = jnp.linalg.cholesky(-N)
        T = solve_triangular(Ln, Bt, lower=True)
        Lp = jnp.linalg.cholesky(P + T.T @ T)
        Lf = jnp.zeros((k, k), dt)
        Lf = Lf.at[:nneg, :nneg].set(Ln)
        Lf = Lf.at[nneg:, :nneg].set(-T.T)
        Lf = Lf.at[nneg:, nneg:].set(Lp)
        sigma = jnp.concatenate([-jnp.ones((nneg,), dt),
                                 jnp.ones((k - nneg,), dt)])
    d = jnp.diagonal(Lf)
    L = Lf / d[None, :]
    D = sigma * d * d
    return L, D


def nd_factor(K: jnp.ndarray, plan: NDPlan,
              pivot_floor: float = PIVOT_FLOOR, method: str = "auto",
              diag_delta: jnp.ndarray = None, interpret: bool = False):
    """Multifrontal block factorisation along the dissection plan
    (= :func:`nd_prework` + :func:`nd_factor_pre`; solver loops call
    the two pieces separately so the prework hoists out of the loop)."""
    return nd_factor_pre(nd_prework(K, plan), plan,
                         diag_delta=diag_delta,
                         pivot_floor=pivot_floor, method=method,
                         interpret=interpret)


def nd_solve(plan: NDPlan, factors, b: jnp.ndarray,
             method: str = "auto", interpret: bool = False) -> jnp.ndarray:
    """Solve K x = b with :func:`nd_factor` factors.

    The factors (and the plan's index arrays) live in the plan's
    permuted coordinate system; the rhs is permuted on entry and the
    solution un-permuted on exit (vector gathers — cheap)."""
    dt = b.dtype
    n = plan.n
    perm = jnp.asarray(plan.perm)
    b = jnp.take(b, perm)
    bp = jnp.zeros((n + 1,), dt).at[:n].set(b)

    zs = []
    for lev, (L, D, W) in zip(plan.levels, factors):
        idx = jnp.asarray(lev.idx)
        v = jnp.asarray(lev.valid, dt)
        bnd = jnp.asarray(lev.bnd)
        bv = jnp.asarray(lev.bvalid, dt)
        z = bp[idx] * v
        zs.append(z)
        upd = jnp.einsum("bkm,bk->bm", W, z) * bv
        bp = bp.at[bnd].add(-upd)

    x = jnp.zeros((n + 1,), dt)
    for lev, (L, D, W), z in zip(reversed(plan.levels), reversed(factors),
                                 reversed(zs)):
        idx = jnp.asarray(lev.idx)
        v = jnp.asarray(lev.valid, dt)
        bnd = jnp.asarray(lev.bnd)
        if lev is plan.levels[-1] and plan.top_neg >= 0:
            # amalgamated top stores Linv: solve = two matvecs
            Li = L[0]
            y = (Li.T @ ((Li @ z[0]) / D[0]))[None]
        else:
            y = _solve_vec_blocks(L, D, z, method, interpret)
        y = y - jnp.einsum("bkm,bm->bk", W, x[bnd])
        x = x.at[idx].set(y * v)
    # un-permute: x_orig[perm[p]] = x_perm[p]
    return jnp.zeros((n,), dt).at[perm].set(x[:n])


def _fwd_back(Li, Di, zi):
    y = solve_triangular(Li, zi, lower=True, unit_diagonal=True)
    return solve_triangular(Li.T, y / Di, lower=False, unit_diagonal=True)


def nd_solve_matrix(plan: NDPlan, factors, B: jnp.ndarray) -> jnp.ndarray:
    """Multi-rhs variant: B is (n, r).  The inner solves stay on the
    plain path — vmapping over rhs columns would vmap the Pallas calls."""
    return jax.vmap(lambda col: nd_solve(plan, factors, col,
                                         method="jnp"),
                    in_axes=1, out_axes=1)(B)
