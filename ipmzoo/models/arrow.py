"""Banded+arrow structured IPM for box-constrained QPs.

The structured counterpart of :class:`CompiledIPM` for QPs whose Hessian
is banded with a small dense arrow (coupling variables) — e.g. chains of
locally-coupled decision variables with a few global resources.  The
dense path factors the condensed system in O(n^3) per iteration; here it
is O(n (b + t)^2) via :mod:`ipmzoo.ops.banded` (block-tridiagonal
Cholesky scan + dense tip Schur complement), with the SAME fully staged
Mehrotra predictor-corrector loop and constants as the dense solver
(tol 1e-8, 100 iters, fraction-to-boundary 0.995, sigma=(mu_aff/mu)^3;
/root/reference/src/NumericalOptimization/Optimizer.cpp:124-216) and the
exact-Taylor corrector (bilinear complementarity rows -> dx*dlambda).

Formulation: Slacks handling of two-sided variable bounds (the
reference demo's handling, /root/reference/src/IpmZoo.cpp:369-370):

    minimize 1/2 x^T Q x + c^T x   s.t.   l <= x <= u

with implicit slacks g = x - l, h = u - x and bound duals
lambda_g, lambda_h >= 0.  The barrier-condensed Newton system is
H dx = -r with H = Q + diag(lambda_g/g + lambda_h/h) — a diagonal
modification, so H inherits Q's banded+arrow sparsity exactly.

Everything is a pure function of (state, data): ``vmap`` batches
instances, ``shard_map`` distributes batches over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.banded import (ArrowFactors, ArrowStructure, arrow_factor,
                          arrow_factor_solve, arrow_solve,
                          band_to_blocks, bt_solve, detect_arrow)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ArrowQPData:
    """Box QP with banded+arrow Hessian, stored structurally (already in
    detector order; batch axes may precede every leaf)."""
    D: jnp.ndarray      # (N, b, b) diagonal blocks of the banded part
    E: jnp.ndarray      # (N-1, b, b) sub-diagonal blocks
    U: jnp.ndarray      # (t, nb) arrow strip
    Ct: jnp.ndarray     # (t, t) arrow tip
    c: jnp.ndarray      # (n,) linear term (n = nb + t)
    l_x: jnp.ndarray    # (n,)
    u_x: jnp.ndarray    # (n,)

    def tree_flatten(self):
        return ((self.D, self.E, self.U, self.Ct, self.c, self.l_x,
                 self.u_x), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @staticmethod
    def from_dense(Q, c, l_x, u_x, structure: Optional[ArrowStructure]
                   = None, block: Optional[int] = None, dtype=None):
        """Detect (or take) the arrow structure, permute, pad the banded
        part to a block multiple, and extract the structured blocks.

        Returns (data, structure, block) — keep ``structure`` to
        un-permute solutions and to build more instances with the same
        sparsity."""
        Q = np.asarray(Q)
        n = Q.shape[0]
        if structure is None:
            structure = detect_arrow(Q)
        p, b_detected, t = structure.perm, structure.bandwidth, \
            structure.tip
        block = block or max(8, b_detected)
        if block < b_detected:
            raise ValueError(f"block {block} < bandwidth {b_detected}")
        Qp = Q[np.ix_(p, p)]
        cp = np.asarray(c)[p]
        lp = np.asarray(l_x)[p]
        up = np.asarray(u_x)[p]
        nb = n - t
        pad = (-nb) % block
        if pad:
            Qpad = np.zeros((n + pad, n + pad))
            Qpad[:nb, :nb] = Qp[:nb, :nb]
            Qpad[nb:nb + pad, nb:nb + pad] = np.eye(pad)
            Qpad[nb + pad:, :nb] = Qp[nb:, :nb]
            Qpad[:nb, nb + pad:] = Qp[:nb, nb:]
            Qpad[nb + pad:, nb + pad:] = Qp[nb:, nb:]
            Qp = Qpad
            cp = np.concatenate([cp[:nb], np.zeros(pad), cp[nb:]])
            lp = np.concatenate([lp[:nb], -np.ones(pad), lp[nb:]])
            up = np.concatenate([up[:nb], np.ones(pad), up[nb:]])
        D, E, U, Ct = band_to_blocks(jnp.asarray(Qp, dtype), block, t)
        data = ArrowQPData(
            D=D, E=E, U=U, Ct=Ct, c=jnp.asarray(cp, dtype),
            l_x=jnp.asarray(lp, dtype), u_x=jnp.asarray(up, dtype))
        return data, structure, block


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ArrowState:
    vars: tuple          # (x, lambda_g, lambda_h)
    mu: jnp.ndarray
    iteration: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray
    #: dual residual Qx + c - lambda_g + lambda_h at ``vars``, carried
    #: through the loop: the metrics evaluation at the END of a step
    #: already computes it, so the next step's direction phase reuses it
    #: instead of re-running the structured matvec (one _qx fewer per
    #: iteration).
    rx: jnp.ndarray = None

    def tree_flatten(self):
        return ((self.vars, self.mu, self.iteration, self.residual,
                 self.gap, self.rx), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ArrowSolveResult:
    x: jnp.ndarray              # solution in the ORIGINAL variable order
    variables: dict
    objective: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray
    converged: jnp.ndarray
    diverged: jnp.ndarray

    def tree_flatten(self):
        return ((self.x, self.variables, self.objective, self.iterations,
                 self.residual, self.gap, self.converged, self.diverged),
                None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def _ratio(alpha, v, dv):
    safe = jnp.where(dv < 0, dv, -1.0)
    r = jnp.where(dv < 0, -v / safe, jnp.inf)
    return jnp.minimum(alpha, jnp.min(r, initial=jnp.inf))


class ArrowIPM:
    """Mehrotra predictor-corrector IPM with an O(n (b+t)^2) per-
    iteration banded+arrow factorisation."""

    def __init__(self, n_banded_blocks: int, block: int, tip: int, *,
                 structure: Optional[ArrowStructure] = None,
                 dtype=jnp.float64, tol: float = 1e-8,
                 max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 method: str = "auto"):
        #: banded factor engine: "scan" | "cr" | "auto"
        #: (see ops/banded.py::arrow_factor)
        self.method = method
        self.N, self.b, self.t = n_banded_blocks, block, tip
        self.n = n_banded_blocks * block + tip
        self.structure = structure
        self.dtype = dtype
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        self.comp_count = 2 * self.n
        self._solve_jit = jax.jit(self._solve_impl)
        self._step_jit = jax.jit(self._step_impl)

    @staticmethod
    def for_data(data: ArrowQPData, structure=None, **kw) -> "ArrowIPM":
        N, b = data.D.shape[-3], data.D.shape[-1]
        t = data.Ct.shape[-1]
        return ArrowIPM(N, b, t, structure=structure, **kw)

    # -- structured matvec ------------------------------------------------

    def _qx(self, data: ArrowQPData, x):
        nb = self.N * self.b
        xb = x[:nb].reshape(self.N, self.b)
        xt = x[nb:]
        yb = jnp.einsum("nij,nj->ni", data.D, xb)
        if self.N > 1:
            yb = yb.at[1:].add(jnp.einsum("nij,nj->ni", data.E, xb[:-1]))
            yb = yb.at[:-1].add(
                jnp.einsum("nji,nj->ni", data.E, xb[1:]))
        if self.t:
            yb = yb + jnp.einsum(
                "tk,t->k", data.U, xt).reshape(self.N, self.b)
            yt = data.U @ x[:nb] + data.Ct @ xt
        else:
            yt = xt
        return jnp.concatenate([yb.reshape(-1), yt])

    # -- residuals / metrics ----------------------------------------------

    def _slacks(self, data, x):
        return x - data.l_x, data.u_x - x

    def _metrics(self, data, vars):
        """(residual, gap, rx) — rx returned so callers can carry it."""
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        rx = self._qx(data, x) + data.c - lg + lh
        comps = jnp.concatenate([g * lg, h * lh])
        r = jnp.concatenate([rx, comps])
        return jnp.sqrt(jnp.dot(r, r)), \
            jnp.sum(jnp.abs(comps)) / self.comp_count, rx

    # -- direction ---------------------------------------------------------

    def _condensed(self, data, vars):
        """Barrier-condensed diagonal blocks (D + diag(w), Ct + diag(w))."""
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        w = lg / g + lh / h
        nb = self.N * self.b
        idx = jnp.arange(self.b)
        D = data.D.at[:, idx, idx].add(w[:nb].reshape(self.N, self.b))
        tidx = jnp.arange(self.t)
        Ct = data.Ct.at[tidx, tidx].add(w[nb:]) if self.t else data.Ct
        return D, Ct

    def _factor(self, data, vars) -> ArrowFactors:
        D, Ct = self._condensed(data, vars)
        return arrow_factor(D, data.E, data.U, Ct, method=self.method)

    def _direction(self, data, vars, factors, rx, cg, ch):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        rhs = -(rx + cg / g - ch / h)
        nb = self.N * self.b
        dxb, dxt = arrow_solve(factors, rhs[:nb], rhs[nb:])
        dx = jnp.concatenate([dxb, dxt])
        dlg = (-cg - lg * dx) / g
        dlh = (-ch + lh * dx) / h
        return dx, dlg, dlh

    def _max_step(self, data, vars, d):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        dx, dlg, dlh = d
        alpha = jnp.asarray(1.0, self.dtype)
        alpha = _ratio(alpha, g, dx)
        alpha = _ratio(alpha, h, -dx)
        alpha = _ratio(alpha, lg, dlg)
        alpha = _ratio(alpha, lh, dlh)
        return alpha

    def _gap_at(self, data, vars):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        return (jnp.sum(jnp.abs(g * lg)) + jnp.sum(jnp.abs(h * lh))) / \
            self.comp_count

    # -- loop ----------------------------------------------------------------

    def init_state(self, data: ArrowQPData,
                   warm_start: Optional[dict] = None) -> ArrowState:
        """Bound midpoints / ones, or a warm start (previous
        ``ArrowSolveResult.variables``, in solver order): x is clipped
        strictly inside the bounds, duals floored away from zero —
        the same safeguards as :class:`CompiledIPM`."""
        dt = self.dtype
        data = self._cast(data)
        x = (0.5 * (data.l_x + data.u_x)).astype(dt)
        ones = jnp.ones(self.n, dt)
        vals = [x, ones, ones]
        if warm_start is not None:
            eps = 1e-2
            names = ["x", "lambda_g", "lambda_h"]
            for i, name in enumerate(names):
                if name not in warm_start:
                    continue
                w = jnp.asarray(warm_start[name], dt)
                if name == "x":
                    span = data.u_x - data.l_x
                    w = jnp.clip(w, data.l_x + eps * span,
                                 data.u_x - eps * span)
                else:
                    w = jnp.maximum(w, eps)
                vals[i] = w
        vars = tuple(vals)
        residual, gap, rx = self._metrics(data, vars)
        return ArrowState(vars=vars, mu=jnp.asarray(self.mu0, dt),
                          iteration=jnp.asarray(0, jnp.int32),
                          residual=residual, gap=gap, rx=rx)

    def _cast(self, data):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, self.dtype), data)

    def _step_impl(self, state: ArrowState,
                   data: ArrowQPData) -> ArrowState:
        data = self._cast(data)
        vars = state.vars
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        gap = state.gap

        rx = state.rx          # carried from the previous metrics pass

        # affine predictor (mu = 0), its banded solve fused into the
        # factor's arrow-strip multi-rhs solve (ONE k=t+1 kernel launch
        # instead of a k=t solve + a separate k=1 predictor solve)
        cg_a, ch_a = g * lg, h * lh
        rhs = -(rx + cg_a / g - ch_a / h)
        nb = self.N * self.b
        Dc, Ctc = self._condensed(data, vars)
        factors, (dxb_a, dxt_a) = arrow_factor_solve(
            Dc, data.E, data.U, Ctc, rhs[:nb], rhs[nb:],
            method=self.method)
        dx_a = jnp.concatenate([dxb_a, dxt_a])
        d_aff = (dx_a, (-cg_a - lg * dx_a) / g, (-ch_a + lh * dx_a) / h)
        alpha_aff = self._max_step(data, vars, d_aff)
        trial = tuple(v + alpha_aff * dv for v, dv in zip(vars, d_aff))
        gap_aff = self._gap_at(data, trial)
        safe_gap = jnp.where(gap > 0, gap, 1.0)
        sigma = jnp.where(gap > 0, (gap_aff / safe_gap) ** 3, 0.0)
        mu_new = (gap * sigma).astype(self.dtype)

        # corrector: recentred + exact second-order (bilinear rows)
        dx_a, dlg_a, dlh_a = d_aff
        cg = g * lg - mu_new + dx_a * dlg_a
        ch = h * lh - mu_new + (-dx_a) * dlh_a
        d_cc = self._direction(data, vars, factors, rx, cg, ch)
        alpha = self._max_step(data, vars, d_cc)

        step = self.fraction_to_boundary * alpha
        new_vars = tuple(v + step * dv for v, dv in zip(vars, d_cc))
        residual, new_gap, new_rx = self._metrics(data, new_vars)
        return ArrowState(vars=new_vars, mu=mu_new,
                          iteration=state.iteration + 1,
                          residual=residual, gap=new_gap, rx=new_rx)

    def _objective(self, data, x):
        return 0.5 * jnp.dot(x, self._qx(data, x)) + jnp.dot(data.c, x)

    def _unpermute(self, x):
        """Map the (padded, permuted) solution back to original order."""
        if self.structure is None:
            return x
        p = np.asarray(self.structure.perm)
        n_orig = p.size
        nb_orig = n_orig - self.structure.tip
        nb = self.N * self.b
        keep = jnp.concatenate([x[..., :nb_orig], x[..., nb:]], axis=-1)
        inv = np.empty(n_orig, dtype=np.int64)
        inv[p] = np.arange(n_orig)
        return keep[..., inv]

    def _solve_impl(self, data: ArrowQPData,
                    warm_start: Optional[dict] = None) -> ArrowSolveResult:
        data = self._cast(data)
        state0 = self.init_state(data, warm_start)
        tol = self.tol

        def _bad(s):
            return jnp.isnan(s.residual) | jnp.isinf(s.residual) | \
                jnp.isnan(s.gap)

        def cond(carry):
            state, diverged = carry
            done = (state.residual < tol) & (state.gap < tol)
            return (~done) & (~diverged) & \
                (state.iteration < self.max_iter)

        def body(carry):
            state, _ = carry
            new = self._step_impl(state, data)
            bad = _bad(new)
            keep = jax.tree_util.tree_map(
                lambda o, n_: jnp.where(bad, o, n_), state, new)
            return (keep, bad)

        state, step_diverged = jax.lax.while_loop(
            cond, body, (state0, jnp.asarray(False)))
        x, lg, lh = state.vars
        return ArrowSolveResult(
            x=self._unpermute(x),
            variables={"x": x, "lambda_g": lg, "lambda_h": lh},
            objective=self._objective(data, x),
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=(state.residual < tol) & (state.gap < tol),
            diverged=step_diverged | _bad(state),
        )

    # -- public ----------------------------------------------------------

    def solve(self, data: ArrowQPData,
              warm_start: Optional[dict] = None) -> ArrowSolveResult:
        """Solve one instance; ``warm_start`` takes a previous result's
        ``variables`` dict (receding-horizon / homotopy pattern)."""
        if warm_start is None:
            return self._solve_jit(data)
        if not hasattr(self, "_solve_warm_jit"):
            self._solve_warm_jit = jax.jit(self._solve_impl)
        return self._solve_warm_jit(data, warm_start)

    def solve_batch(self, data: ArrowQPData) -> ArrowSolveResult:
        if not hasattr(self, "_solve_batch_jit"):
            self._solve_batch_jit = jax.jit(jax.vmap(self._solve_impl))
        return self._solve_batch_jit(data)
