"""Distributed IPM for block-separable coupled QPs via Schur complements.

Problem family (the framework's structure-parallel scaling axis — the
reference has no distributed execution at all, SURVEY §2.5):

    minimize    sum_b  1/2 x_b^T Q_b x_b + c_b^T x_b
    subject to  l_x <= x_b <= u_x          (per-block box bounds)
                sum_b F_b x_b = g          (m_c coupling equalities)

Blocks are sharded across the device mesh.  Each interior-point iteration
solves the arrow-structured condensed KKT system

    [ H_1          F_1^T ] [dx_1 ]   [r_1 ]
    [      ...      ...  ] [ ... ] = [ ...]
    [ H_B          F_B^T ] [dx_B ]   [r_B ]
    [ F_1  ...  F_B  -dI ] [dnu  ]   [r_c ]

by block elimination: every device Cholesky-factors its local
H_b = Q_b + diag(z_l/s_l + z_u/s_u) blocks, forms the local Schur
contributions F_b H_b^{-1} F_b^T and F_b H_b^{-1} r_b, and a single
``psum`` over the mesh assembles the (m_c x m_c) coupling system

    (dI + sum_b F_b H_b^{-1} F_b^T) dnu = sum_b F_b H_b^{-1} r_b - r_c,

which is solved replicated; the back-substitution for dx_b is local.
The only cross-device traffic per iteration is that one psum of
(m_c^2 + m_c) floats — it rides ICI on a pod slice.

The primal-dual iteration is a standard Mehrotra scheme on the
long-step barrier formulation of the box bounds (s_l = x - l, s_u =
u - x with duals z_l, z_u), matching the framework's single-problem
solver semantics (fraction-to-boundary 0.995, sigma = (mu_aff/mu)^3,
tolerance 1e-8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.ldlt import PIVOT_FLOOR, batched_ldlt, ldlt, solve_ldlt


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockQPData:
    """Per-block data; leaves have leading block axis B."""
    Q: jnp.ndarray      # (B, n, n)
    c: jnp.ndarray      # (B, n)
    F: jnp.ndarray      # (B, m_c, n) coupling rows
    l_x: jnp.ndarray    # (B, n)
    u_x: jnp.ndarray    # (B, n)
    g: jnp.ndarray      # (m_c,) coupling rhs (replicated)

    def tree_flatten(self):
        return ((self.Q, self.c, self.F, self.l_x, self.u_x, self.g), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SchurState:
    x: jnp.ndarray      # (B, n)
    s_l: jnp.ndarray    # (B, n)
    s_u: jnp.ndarray    # (B, n)
    z_l: jnp.ndarray    # (B, n)
    z_u: jnp.ndarray    # (B, n)
    nu: jnp.ndarray     # (m_c,) coupling duals (replicated)
    iteration: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray

    def tree_flatten(self):
        return ((self.x, self.s_l, self.s_u, self.z_l, self.z_u, self.nu,
                 self.iteration, self.residual, self.gap), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


@dataclasses.dataclass
class SchurResult:
    x: jnp.ndarray
    nu: jnp.ndarray
    objective: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray
    converged: jnp.ndarray


class SchurIPM:
    """Distributed Mehrotra IPM over a block-sharded mesh axis."""

    def __init__(self, n: int, m_c: int, *, mesh: Optional[Mesh] = None,
                 axis: str = "dp", dtype=jnp.float64, tol: float = 1e-8,
                 max_iter: int = 100, fraction_to_boundary: float = 0.995,
                 delta: float = 1e-8, pivot_floor: float = PIVOT_FLOOR,
                 refine: int = 1, block_kernel: str = "auto",
                 two_float="auto", interpret: bool = False):
        self.n, self.m_c = n, m_c
        self.mesh, self.axis = mesh, axis
        self.dtype = dtype
        self.tol = tol
        if two_float == "auto":
            # an f32 iterate cannot express residuals below ~eps_f32 *
            # ||Qx|| (measured floor ~8e-7 on the test class), so the
            # default tol 1e-8 would never converge in f32.  Auto-enable
            # the double-single path exactly when the tolerance sits
            # below what plain working precision reaches.
            two_float = (jnp.dtype(dtype) == jnp.dtype(jnp.float32)
                         and tol < 1e-6)
        #: two_float=True carries the iterate as (hi, lo) double-single
        #: pairs (stacked leading-2 axis on every state leaf) and
        #: evaluates the cancellation-dominated quantities — the
        #: stationarity residual, the complementarity products and the
        #: coupling residual — in compensated double-single arithmetic
        #: (ops/twofloat.py), while the per-iteration FACTORISATIONS
        #:  stay in working precision.  Unlike the augmented KKT path
        #: (whose indefinite system needs the full double-single factor,
        #: ops/ldlt_df.py — see tests/test_precision_floor.py), the
        #: Schur elimination only factors SPD blocks H_b = Q_b +
        #: barrier diagonal whose ill-conditioning is purely diagonal,
        #: so the f32 factor's componentwise-stable backward error does
        #: not set a floor above 1e-8: the reference-parity tolerance
        #: (Optimizer.cpp:124,133) is reachable from pure f32
        #: arithmetic (pinned by tests/test_schur.py).
        self.two_float = two_float
        self.max_iter = max_iter
        self.ftb = fraction_to_boundary
        self.delta = delta
        #: factor/solve kernel for the local H_b blocks:
        #: 'pallas' = the batched LDL^T factor + 1-rhs solve kernels
        #: (ops/pallas_ldlt.py); 'jnp' = the plain column-loop +
        #: triangular-solve path; 'auto' = as ops/routes.py decides for
        #: the platform.  ``interpret=True`` runs the Pallas kernels in
        #: the interpreter (tests).
        if block_kernel not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown block_kernel={block_kernel!r}")
        self.block_kernel = block_kernel
        self.interpret = interpret
        self._block_route("factor")   # refuses 'pallas' with no kernel
        #: zero-pivot floor for BOTH factorisations each iteration — the
        #: local H_b = Q_b + barrier LDL^T and the coupling Schur system
        #: S (the same quasi-definite regularisation every other solver
        #: in the framework uses; ops/ldlt.py).
        self.pivot_floor = pivot_floor
        #: iterative-refinement sweeps on the coupling solve: S is formed
        #: from H^{-1} products, so it carries the squared conditioning of
        #: the worst block; refinement against the ASSEMBLED S recovers
        #: the lost digits for one extra (m_c x m_c) matvec per sweep.
        self.refine = refine
        #: dtype-tied mu floor (same invariant as CompiledIPM, ipm.py):
        #: a lane whose mu underflows overflows the barrier diagonals.
        self.mu_floor = float(jnp.finfo(dtype).eps) ** 2

    # -- local (per-shard) pieces; `axis_name` is bound under shard_map --

    def _block_route(self, op):
        from ..ops.routes import batched_ldlt_route
        return batched_ldlt_route(self.block_kernel, self.n, op,
                                  interpret=self.interpret)

    def _factor_H(self, H):
        """Factor the batch of local condensed blocks H_b once per
        iteration (predictor AND corrector share it — H depends only on
        the current iterate)."""
        route = self._block_route("factor")
        if route.kernel == "pallas":
            from ..ops.pallas_ldlt import batched_ldlt_pallas
            return batched_ldlt_pallas(H, self.pivot_floor,
                                       interpret=route.interpret)
        return batched_ldlt(H, self.pivot_floor)

    def _solve_H(self, fact, r):
        """(B, n) rhs solve against the factored H blocks."""
        L, D = fact
        route = self._block_route("solve")
        if route.kernel == "pallas":
            from ..ops.pallas_ldlt import batched_solve_ldlt_pallas
            return batched_solve_ldlt_pallas(L, D, r,
                                             interpret=route.interpret)
        return _ldlt_solve_batched(L, D, r)

    def _solve_H_mat(self, fact, R):
        """(B, n, k) multi-rhs solve against the factored H blocks."""
        L, D = fact
        return _ldlt_solve_batched_mat(L, D, R)

    def _local_rhs(self, data, st, grad, fact, mu, corr=None):
        """Residual vectors + the local H^{-1} r_x Schur contribution
        for one solve phase.  corr = (dx_aff, dz_l_aff, dz_u_aff) adds
        the Mehrotra second-order correction.  ``grad`` is the rounded
        stationarity residual (double-single under two_float)."""
        # complementarity (with correction for the corrector phase);
        # under two_float the cancellation s z - mu is pair-exact
        if self.two_float:
            from ..ops.twofloat import two_sum
            (clh, cll), (cuh, cul) = self._comp_ds(st)
            s, e = two_sum(clh, -mu)
            r_l = s + (e + cll)
            s, e = two_sum(cuh, -mu)
            r_u = s + (e + cul)
        else:
            r_l = st.s_l * st.z_l - mu
            r_u = st.s_u * st.z_u - mu
        if corr is not None:
            dx_aff, dzl_aff, dzu_aff = corr
            r_l = r_l + dx_aff * dzl_aff          # ds_l = dx
            r_u = r_u + (-dx_aff) * dzu_aff       # ds_u = -dx
        r_x = -grad - r_l / self._val(st.s_l) + r_u / self._val(st.s_u)
        Hinv_rx = self._solve_H(fact, r_x)
        rS_local = jnp.einsum("bij,bj->i", data.F, Hinv_rx)
        return rS_local, (Hinv_rx, r_l, r_u)

    def _direction(self, data, st, Hinv_FT, pieces, dnu):
        """Back-substitute the block directions given the coupling dir."""
        Hinv_rx, r_l, r_u = pieces
        dx = Hinv_rx - jnp.einsum("bij,j->bi", Hinv_FT, dnu)
        ds_l = dx
        ds_u = -dx
        dz_l = -(r_l + self._val(st.z_l) * ds_l) / self._val(st.s_l)
        dz_u = -(r_u + self._val(st.z_u) * ds_u) / self._val(st.s_u)
        return dx, ds_l, ds_u, dz_l, dz_u

    def _max_step(self, st, d):
        dx, ds_l, ds_u, dz_l, dz_u = d
        def ratio(v, dv):
            r = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
            return jnp.min(r, initial=jnp.inf)
        return jnp.minimum(1.0, jnp.minimum(
            jnp.minimum(ratio(self._val(st.s_l), ds_l),
                        ratio(self._val(st.s_u), ds_u)),
            jnp.minimum(ratio(self._val(st.z_l), dz_l),
                        ratio(self._val(st.z_u), dz_u))))

    def _psum(self, x, axis_name):
        if axis_name is None:
            return x
        return jax.lax.psum(x, axis_name)

    # -- two-float state helpers (no-ops when two_float=False) ---------
    # State leaves are plain arrays normally, stacked (2, ...) (hi, lo)
    # double-single pairs under two_float.

    def _val(self, v):
        """Rounded working-precision value of a state leaf."""
        return (v[0] + v[1]) if self.two_float else v

    def _pair(self, v):
        """Lift an exact working-precision array to a (hi, lo) pair."""
        return jnp.stack([v, jnp.zeros_like(v)]) if self.two_float else v

    def _axpy(self, v, a, d):
        """v + a * d (pair-exact under two_float; a scalar, d plain)."""
        if not self.two_float:
            return v + a * d
        from ..ops.twofloat import df_add, two_prod
        p, e = two_prod(jnp.asarray(a, self.dtype), d)
        return jnp.stack(df_add((v[0], v[1]), (p, e)))

    def _grad_ds(self, data, st):
        """Stationarity residual Q x + c + F^T nu - z_l + z_u as a
        (hi, lo) pair: near the optimum its O(1) terms cancel to ~tol,
        so f32 evaluation would floor the residual at ~sqrt(n) * eps_f32
        * ||Q x|| ~ 1e-5 — compensated products + tree-fold accumulation
        keep the cancellation exact to ~2^-48."""
        from ..ops.twofloat import df_add, df_mul, df_neg, df_sum
        qh, ql = df_mul((data.Q, jnp.zeros_like(data.Q)),
                        (st.x[0][:, None, :], st.x[1][:, None, :]))
        g = df_sum(qh, ql, axis=-1)
        fh, fl = df_mul((data.F, jnp.zeros_like(data.F)),
                        (st.nu[0][None, :, None], st.nu[1][None, :, None]))
        g = df_add(g, df_sum(fh, fl, axis=1))
        g = df_add(g, (data.c, jnp.zeros_like(data.c)))
        g = df_add(g, df_neg((st.z_l[0], st.z_l[1])))
        g = df_add(g, (st.z_u[0], st.z_u[1]))
        return g

    def _coupling_ds(self, data, st, axis_name):
        """sum_b F_b x_b - g in double-single, rounded at the end."""
        from ..ops.twofloat import df_mul, df_sum, two_sum
        ph, pl = df_mul((data.F, jnp.zeros_like(data.F)),
                        (st.x[0][:, None, :], st.x[1][:, None, :]))
        ph = jnp.moveaxis(ph, 1, 0).reshape(self.m_c, -1)
        pl = jnp.moveaxis(pl, 1, 0).reshape(self.m_c, -1)
        hi, lo = df_sum(ph, pl, axis=-1)
        if axis_name is not None:
            # a plain psum of the hi parts rounds the cross-device fold
            # at working precision — measured: it floors the sharded
            # residual at ~3e-8 while the local path converges to 1e-8.
            # The coupling row is tiny (m_c floats), so all_gather the
            # (hi, lo) pairs and tree-fold them in pair arithmetic.
            hs = jax.lax.all_gather(hi, axis_name)      # (ndev, m_c)
            ls = jax.lax.all_gather(lo, axis_name)
            hi, lo = df_sum(hs, ls, axis=0)
        s, e = two_sum(hi, -data.g)
        return s + (e + lo)

    def _comp_ds(self, st):
        """Complementarity products s.z as (hi, lo) pairs."""
        from ..ops.twofloat import df_mul
        return (df_mul((st.s_l[0], st.s_l[1]), (st.z_l[0], st.z_l[1])),
                df_mul((st.s_u[0], st.s_u[1]), (st.z_u[0], st.z_u[1])))

    def _metrics(self, data, st, axis_name):
        if self.two_float:
            gh, gl = self._grad_ds(data, st)
            grad = gh + gl
            coupling = self._coupling_ds(data, st, axis_name)
            (clh, cll), (cuh, cul) = self._comp_ds(st)
            comp = jnp.concatenate([(clh + cll).ravel(),
                                    (cuh + cul).ravel()])
        else:
            grad = (jnp.einsum("bij,bj->bi", data.Q, st.x) + data.c +
                    jnp.einsum("bij,i->bj", data.F, st.nu) -
                    st.z_l + st.z_u)
            coupling = self._psum(jnp.einsum("bij,bj->i", data.F, st.x),
                                  axis_name) - data.g
            comp = jnp.concatenate([(st.s_l * st.z_l).ravel(),
                                    (st.s_u * st.z_u).ravel()])
        sq = jnp.sum(grad ** 2) + jnp.sum(comp ** 2)
        sq = self._psum(sq, axis_name) + jnp.sum(coupling ** 2)
        residual = jnp.sqrt(sq)
        gap_sum = self._psum(jnp.sum(jnp.abs(comp)), axis_name)
        count = self._psum(jnp.asarray(comp.size, self.dtype), axis_name)
        return residual, gap_sum / count

    def _step(self, data: BlockQPData, st: SchurState, axis_name):
        dt = self.dtype
        # st.gap is exactly _metrics(data, st)'s gap: init_state and the
        # end of every step store fresh metrics for the CURRENT iterate,
        # so re-evaluating here would duplicate a full metrics pass
        # (under two_float that is a compensated grad + comp + coupling
        # evaluation — a fifth of the iteration) per step.
        mu = st.gap

        # -- factor the local condensed blocks ONCE per iteration --
        # H_b = Q_b + barrier diagonal is SPD in exact arithmetic but
        # near-active bounds push barrier diagonals to ~1/mu — a
        # pivot-floored LDL^T (the framework's standard quasi-definite
        # regularisation, ops/ldlt.py) keeps degenerate pivots bounded
        # where a bare Cholesky would produce NaN columns.  The gradient
        # and H depend only on the current iterate, so predictor and
        # corrector share the factorisation AND the H^{-1} F^T panel.
        if self.two_float:
            gh, gl = self._grad_ds(data, st)
            grad = gh + gl
        else:
            grad = (jnp.einsum("bij,bj->bi", data.Q, st.x) + data.c +
                    jnp.einsum("bij,i->bj", data.F, st.nu) -
                    st.z_l + st.z_u)
        H = data.Q + _diag_embed(
            self._val(st.z_l) / self._val(st.s_l) +
            self._val(st.z_u) / self._val(st.s_u))
        fact = self._factor_H(H)
        Hinv_FT = self._solve_H_mat(fact, jnp.swapaxes(data.F, 1, 2))
        S_l = jnp.einsum("bij,bjk->ik", data.F, Hinv_FT)
        S = self._psum(S_l, axis_name) + self.delta * jnp.eye(self.m_c, dtype=dt)
        if self.two_float:
            r_c = self._coupling_ds(data, st, axis_name)
        else:
            r_c = self._psum(jnp.einsum("bij,bj->i", data.F, st.x),
                             axis_name) - data.g

        # one pivot-floored factorisation of the coupling system, reused
        # by predictor and corrector, with iterative refinement: S carries
        # the squared conditioning of the worst H_b block, and each sweep
        # costs one (m_c x m_c) matvec + two triangular solves.  Under
        # two_float the refinement residual rhs - S x is compensated, so
        # the sweeps actually recover digits instead of recomputing the
        # f32 rounding noise.
        Ls, Ds = ldlt(S, self.pivot_floor)

        def solve_S(rhs):
            x = solve_ldlt(Ls, Ds, rhs)
            for _ in range(self.refine):
                if self.two_float:
                    from ..ops.twofloat import comp_residual
                    r = comp_residual(rhs, S, x)
                else:
                    r = rhs - S @ x
                x = x + solve_ldlt(Ls, Ds, r)
            return x

        # -- affine predictor --
        rS_l, pieces = self._local_rhs(data, st, grad, fact,
                                       jnp.asarray(0.0, dt))
        rS = self._psum(rS_l, axis_name) if axis_name else rS_l
        dnu = solve_S(rS + r_c)
        d_aff = self._direction(data, st, Hinv_FT, pieces, dnu)
        alpha_aff = self._max_step(st, d_aff)
        if axis_name is not None:
            alpha_aff = jax.lax.pmin(alpha_aff, axis_name)

        # -- centering --
        dx, dsl, dsu, dzl, dzu = d_aff
        mu_aff_sum = (jnp.sum((self._val(st.s_l) + alpha_aff * dsl) *
                              (self._val(st.z_l) + alpha_aff * dzl)) +
                      jnp.sum((self._val(st.s_u) + alpha_aff * dsu) *
                              (self._val(st.z_u) + alpha_aff * dzu)))
        mu_aff_sum = self._psum(mu_aff_sum, axis_name)
        count = self._psum(jnp.asarray(2 * st.s_l.size, dt), axis_name)
        mu_aff = mu_aff_sum / count
        sigma = jnp.where(mu > 0, (mu_aff / jnp.where(mu > 0, mu, 1.0)) ** 3,
                          0.0)
        mu_new = jnp.maximum(sigma * mu, jnp.asarray(self.mu_floor, dt))

        # -- corrector (same factorisations; Mehrotra correction terms) --
        rS_l2, pieces2 = self._local_rhs(data, st, grad, fact, mu_new,
                                         corr=(dx, dzl, dzu))
        rS2 = self._psum(rS_l2, axis_name) if axis_name else rS_l2
        dnu2 = solve_S(rS2 + r_c)
        d = self._direction(data, st, Hinv_FT, pieces2, dnu2)
        alpha = self._max_step(st, d)
        if axis_name is not None:
            alpha = jax.lax.pmin(alpha, axis_name)
        a = self.ftb * alpha

        dx, dsl, dsu, dzl, dzu = d
        new = SchurState(
            x=self._axpy(st.x, a, dx), s_l=self._axpy(st.s_l, a, dsl),
            s_u=self._axpy(st.s_u, a, dsu), z_l=self._axpy(st.z_l, a, dzl),
            z_u=self._axpy(st.z_u, a, dzu),
            nu=self._axpy(st.nu, a, dnu2), iteration=st.iteration + 1,
            residual=st.residual, gap=st.gap)
        residual, gap = self._metrics(data, new, axis_name)
        new.residual, new.gap = residual, gap
        return new

    def init_state(self, data: BlockQPData, axis_name=None) -> SchurState:
        dt = self.dtype
        x = 0.5 * (data.l_x + data.u_x).astype(dt)
        ones = jnp.ones_like(x)
        # the initial point is exact in working precision: lo words = 0
        st = SchurState(x=self._pair(x), s_l=self._pair(x - data.l_x),
                        s_u=self._pair(data.u_x - x),
                        z_l=self._pair(ones), z_u=self._pair(ones),
                        nu=self._pair(jnp.zeros((self.m_c,), dt)),
                        iteration=jnp.asarray(0, jnp.int32),
                        residual=jnp.asarray(jnp.inf, dt),
                        gap=jnp.asarray(jnp.inf, dt))
        residual, gap = self._metrics(data, st, axis_name)
        st.residual, st.gap = residual, gap
        return st

    def _solve_loop(self, data: BlockQPData, axis_name=None) -> SchurState:
        st = self.init_state(data, axis_name)

        def cond(s):
            done = (s.residual < self.tol) & (s.gap < self.tol)
            return (~done) & (s.iteration < self.max_iter)

        return jax.lax.while_loop(
            cond, lambda s: self._step(data, s, axis_name), st)

    def _finalise(self, data, st, axis_name=None):
        x = self._val(st.x)
        obj = jnp.sum(0.5 * jnp.einsum("bi,bij,bj->b", x, data.Q, x) +
                      jnp.einsum("bi,bi->b", data.c, x))
        obj = self._psum(obj, axis_name)
        return SchurResult(
            x=x, nu=self._val(st.nu), objective=obj,
            iterations=st.iteration,
            residual=st.residual, gap=st.gap,
            converged=(st.residual < self.tol) & (st.gap < self.tol))

    def _cache_key(self):
        """Solver attributes the cached compiled programs close over —
        mutating any of them after the first solve must invalidate the
        jit cache, not silently reuse the stale program."""
        return (id(self.mesh), self.axis, self.tol, self.max_iter,
                self.refine, self.delta, self.pivot_floor, self.ftb,
                self.block_kernel, self.interpret, self.two_float)

    def solve(self, data: BlockQPData) -> SchurResult:
        """Single-device (or fully local) solve; no collectives."""
        # the jitted loop is cached on the instance: a fresh jax.jit
        # wrapper per call would retrace AND recompile every time.
        # Keyed on the closed-over attributes so
        # mutating e.g. tol or max_iter picks up a fresh program.
        key = self._cache_key()
        if getattr(self, "_solve_key", None) != key:
            self._solve_jit = jax.jit(self._solve_loop)
            self._solve_key = key
        st = self._solve_jit(data)
        return self._finalise(data, st)

    def solve_batch(self, datas: BlockQPData) -> SchurResult:
        """Solve a BATCH of independent coupled QP instances: every leaf
        of ``datas`` carries a leading instance axis (I, ...) — i.e.
        Q is (I, B, n, n) and g is (I, m_c).  Instances run as vmapped
        lanes of one program (jax.vmap of the while_loop freezes
        finished lanes while stragglers iterate), amortising dispatch
        and filling the chip; the batched Pallas block kernels absorb
        the extra axis as a grid dimension."""
        key = self._cache_key()
        if getattr(self, "_solve_batch_key", None) != key:
            self._solve_batch_jit = jax.jit(jax.vmap(self._solve_loop))
            self._solve_batch_key = key
        st = self._solve_batch_jit(datas)
        # the vmap axis is leading, so the (hi, lo) pair axis sits at 1
        val = (lambda v: v[:, 0] + v[:, 1]) if self.two_float else \
            (lambda v: v)
        x = val(st.x)                             # (I, B, n)
        obj = (0.5 * jnp.einsum("abi,abij,abj->a", x, datas.Q, x) +
               jnp.einsum("abi,abi->a", datas.c, x))
        return SchurResult(
            x=x, nu=val(st.nu), objective=obj,
            iterations=st.iteration,
            residual=st.residual, gap=st.gap,
            converged=(st.residual < self.tol) & (st.gap < self.tol))

    def solve_sharded(self, data: BlockQPData) -> SchurResult:
        """Distributed solve: blocks sharded over the mesh axis, coupling
        system assembled with one psum per solve phase."""
        if self.mesh is None:
            raise ValueError("solve_sharded needs a mesh")
        mesh, axis = self.mesh, self.axis
        blk = P(axis)
        rep = P()
        in_specs = BlockQPData(Q=blk, c=blk, F=blk, l_x=blk, u_x=blk, g=rep)

        def local(data):
            st = self._solve_loop(data, axis_name=axis)
            return st

        # under two_float the state leaves carry a leading (hi, lo) pair
        # axis, so the block axis sits at position 1
        blk_st = P(None, axis) if self.two_float else blk
        rep_st = P(None) if self.two_float else rep
        out_specs = SchurState(x=blk_st, s_l=blk_st, s_u=blk_st,
                               z_l=blk_st, z_u=blk_st,
                               nu=rep_st, iteration=rep, residual=rep,
                               gap=rep)
        key = self._cache_key()
        if getattr(self, "_solve_sharded_key", None) != key:
            self._solve_sharded_jit = jax.jit(
                jax.shard_map(local, mesh=mesh, in_specs=(in_specs,),
                              out_specs=out_specs, check_vma=False))
            self._solve_sharded_key = key
        st = self._solve_sharded_jit(data)
        # objective needs a global reduction; do it outside the shard_map
        x = self._val(st.x)
        obj = jnp.sum(0.5 * jnp.einsum("bi,bij,bj->b", x, data.Q, x) +
                      jnp.einsum("bi,bi->b", data.c, x))
        return SchurResult(
            x=x, nu=self._val(st.nu), objective=obj,
            iterations=st.iteration,
            residual=st.residual, gap=st.gap,
            converged=(st.residual < self.tol) & (st.gap < self.tol))


def _diag_embed(v: jnp.ndarray) -> jnp.ndarray:
    """(B, n) -> (B, n, n) batched diagonal."""
    return jnp.einsum("bi,ij->bij", v, jnp.eye(v.shape[-1], dtype=v.dtype))


def _ldlt_solve_batched(L: jnp.ndarray, D: jnp.ndarray,
                        b: jnp.ndarray) -> jnp.ndarray:
    """(B, n, n) factors x (B, n) rhs."""
    return jax.vmap(solve_ldlt)(L, D, b)


def _ldlt_solve_batched_mat(L: jnp.ndarray, D: jnp.ndarray,
                            B: jnp.ndarray) -> jnp.ndarray:
    """(B, n, n) factors x (B, n, k) multi-rhs (solve_ldlt's diagonal
    scale broadcasts over the trailing axis only for vector rhs, so the
    matrix case divides explicitly)."""
    from jax.scipy.linalg import solve_triangular

    def one(Li, Di, Bi):
        y = solve_triangular(Li, Bi, lower=True, unit_diagonal=True)
        z = y / Di[:, None]
        return solve_triangular(Li.T, z, lower=False, unit_diagonal=True)

    return jax.vmap(one)(L, D, B)
