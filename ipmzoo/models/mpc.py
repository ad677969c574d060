"""Structured MPC: block-tridiagonal IPM with a Riccati inner solver.

The condensed MPC family (``families.mpc``) eliminates states and hands
a dense (T*nu)-dimensional box QP to the generic solver — O((T nu)^3)
per IPM iteration.  This module keeps the optimal-control structure:
states stay variables, the Newton system is block-tridiagonal, and each
iteration is an O(T (ns+nu)^3) Riccati factor/solve pair
(:mod:`ipmzoo.ops.riccati`) inside the same fully staged Mehrotra
predictor-corrector loop as :class:`CompiledIPM` — identical constants
(tol 1e-8, 100 iters, fraction-to-boundary 0.995, sigma = (mu_aff/mu)^3;
/root/reference/src/NumericalOptimization/Optimizer.cpp:124-216) and the
same exact-Taylor-remainder corrector (complementarity rows here are
bilinear, so the remainder du_aff * dlambda_aff is exact).

Problem (x_0 fixed; x-index below runs 1..T):

    minimize    sum_{k=1}^{T} 1/2 x_k' Q_k x_k + q_k' x_k
              + sum_{k=0}^{T-1} 1/2 u_k' R_k u_k + r_k' u_k
    subject to  x_{k+1} = A_k x_k + B_k u_k + c_k
                l_u <= u_k <= u_u            (always)
                l_x <= x_k <= u_x, k>=1      (``state_bounds=True``)

Bounds are handled primal-dual with implicit slacks g = v - l,
h = u - v and complementarity G lambda_g = mu e, H lambda_h = mu e; the
barrier contributions condense into diagonal modifications of R_k / Q_k,
exactly the structure the Riccati recursion consumes.

Everything is a pure function of (state, data): ``vmap`` batches
scenario trees, ``shard_map`` distributes batches over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.riccati import riccati_factor, riccati_solve


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MPCData:
    """Stagewise MPC problem data (leading axis = stage; batch axes may
    precede it on every leaf)."""
    A: jnp.ndarray     # (T, ns, ns) dynamics
    B: jnp.ndarray     # (T, ns, nu)
    c: jnp.ndarray     # (T, ns) affine dynamics offsets
    x0: jnp.ndarray    # (ns,) fixed initial state
    Q: jnp.ndarray     # (T, ns, ns) cost Hessian of x_1..x_T (last=terminal)
    q: jnp.ndarray     # (T, ns)
    R: jnp.ndarray     # (T, nu, nu)
    r: jnp.ndarray     # (T, nu)
    l_u: jnp.ndarray   # (T, nu)
    u_u: jnp.ndarray   # (T, nu)
    l_x: jnp.ndarray   # (T, ns) bounds on x_1..x_T (state_bounds solvers)
    u_x: jnp.ndarray   # (T, ns)

    def tree_flatten(self):
        return ((self.A, self.B, self.c, self.x0, self.Q, self.q, self.R,
                 self.r, self.l_u, self.u_u, self.l_x, self.u_x), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MPCState:
    vars: tuple
    mu: jnp.ndarray
    iteration: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray
    #: (ru, rx, rd) residual triple at ``vars``, carried through the
    #: loop: the end-of-step metrics evaluation already computes it, so
    #: the next step's direction phase reuses it instead of re-running
    #: the batched residual einsums (same rx-carry as ArrowState).
    res: tuple = None

    def tree_flatten(self):
        return ((self.vars, self.mu, self.iteration, self.residual,
                 self.gap, self.res), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MPCSolveResult:
    x: jnp.ndarray           # (T, ns) state trajectory x_1..x_T
    u: jnp.ndarray           # (T, nu) control trajectory
    variables: dict          # every KKT variable by name
    objective: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray
    gap: jnp.ndarray
    converged: jnp.ndarray
    diverged: jnp.ndarray

    def tree_flatten(self):
        return ((self.x, self.u, self.variables, self.objective,
                 self.iterations, self.residual, self.gap, self.converged,
                 self.diverged), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def _add_diag(M, dvec):
    """M_k + diag(dvec_k) over the stage axis."""
    idx = jnp.arange(M.shape[-1])
    return M.at[..., idx, idx].add(dvec)


def _ratio(alpha, v, dv):
    """Fraction-to-boundary: largest a <= alpha with v + a dv >= 0."""
    safe = jnp.where(dv < 0, dv, -1.0)
    r = jnp.where(dv < 0, -v / safe, jnp.inf)
    return jnp.minimum(alpha, jnp.min(r, initial=jnp.inf))


class RiccatiIPM:
    """Mehrotra predictor-corrector IPM over the MPC structure.

    Variables (in ``MPCState.vars`` order): u (T,nu), x (T,ns) for
    x_1..x_T, y (T,ns) dynamics duals, lambda_g/lambda_h (T,nu) bound
    duals of u; with ``state_bounds=True`` additionally
    lambda_gx/lambda_hx (T,ns)."""

    def __init__(self, horizon: int, n_states: int, n_controls: int, *,
                 state_bounds: bool = False, dtype=jnp.float64,
                 tol: float = 1e-8, max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 gondzio: int = 0):
        self.T, self.ns, self.nu = horizon, n_states, n_controls
        self.state_bounds = state_bounds
        self.dtype = dtype
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        #: Gondzio multiple-centrality-corrector rounds per iteration
        #: (same scheme as CompiledIPM(gondzio=k): extra solves against
        #: the existing Riccati factor chain, accepted only if the step
        #: lengthens) — valuable for long horizons where each
        #: factorisation is the dominant cost
        self.gondzio = gondzio
        #: complementarity pairs counted in the duality measure
        self.comp_count = 2 * horizon * n_controls + (
            2 * horizon * n_states if state_bounds else 0)
        self._solve_jit = jax.jit(self._solve_impl)
        self._step_jit = jax.jit(self._step_impl)

    # ------------------------------------------------------------------
    # residuals
    # ------------------------------------------------------------------

    def _slacks(self, data: MPCData, u, x):
        g = u - data.l_u
        h = data.u_u - u
        if self.state_bounds:
            gx = x - data.l_x
            hx = data.u_x - x
        else:
            gx = hx = None
        return g, h, gx, hx

    def _residuals(self, data: MPCData, vars):
        """Stationarity and dynamics residuals (mu-independent parts)."""
        u, x, y = vars[0], vars[1], vars[2]
        lg, lh = vars[3], vars[4]
        dt = self.dtype

        ru = (jnp.einsum("kij,kj->ki", data.R, u) + data.r
              - jnp.einsum("kiu,ki->ku", data.B, y) - lg + lh)

        Aty = jnp.einsum("kij,ki->kj", data.A, y)       # A_k^T y_k
        Aty_next = jnp.concatenate(
            [Aty[1:], jnp.zeros_like(Aty[:1])], axis=0)
        rx = (jnp.einsum("kij,kj->ki", data.Q, x) + data.q + y - Aty_next)
        if self.state_bounds:
            rx = rx - vars[5] + vars[6]

        xprev = jnp.concatenate([data.x0[None].astype(dt), x[:-1]], axis=0)
        rd = (x - jnp.einsum("kij,kj->ki", data.A, xprev)
              - jnp.einsum("kiu,ku->ki", data.B, u) - data.c)
        return ru, rx, rd

    def _metrics(self, data: MPCData, vars):
        """(residual norm, duality measure, (ru, rx, rd)) at mu = 0."""
        u, x = vars[0], vars[1]
        lg, lh = vars[3], vars[4]
        g, h, gx, hx = self._slacks(data, u, x)
        ru, rx, rd = self._residuals(data, vars)
        comps = [g * lg, h * lh]
        if self.state_bounds:
            comps += [gx * vars[5], hx * vars[6]]
        parts = [ru.ravel(), rx.ravel(), rd.ravel()] + \
            [c.ravel() for c in comps]
        r = jnp.concatenate(parts)
        residual = jnp.sqrt(jnp.dot(r, r))
        gap = sum(jnp.sum(jnp.abs(c)) for c in comps) / self.comp_count
        return residual, gap, (ru, rx, rd)

    # ------------------------------------------------------------------
    # directions
    # ------------------------------------------------------------------

    def _direction(self, data, vars, factors, ru, rx, rd, comp):
        """Newton direction for given complementarity residual vectors
        ``comp = (cg, ch[, cgx, chx])``, reusing the factor chain."""
        u, x = vars[0], vars[1]
        lg, lh = vars[3], vars[4]
        g, h, gx, hx = self._slacks(data, u, x)
        cg, ch = comp[0], comp[1]

        ru_t = ru + cg / g - ch / h
        rx_t = rx
        if self.state_bounds:
            cgx, chx = comp[2], comp[3]
            rx_t = rx + cgx / gx - chx / hx

        dx, du, dy = riccati_solve(factors, data.A, data.B, rx_t, ru_t,
                                   -rd)
        dlg = (-cg - lg * du) / g
        dlh = (-ch + lh * du) / h
        ds = [du, dx, dy, dlg, dlh]
        if self.state_bounds:
            dlgx = (-cgx - vars[5] * dx) / gx
            dlhx = (-chx + vars[6] * dx) / hx
            ds += [dlgx, dlhx]
        return tuple(ds)

    def _max_step(self, data, vars, d):
        u, x = vars[0], vars[1]
        g, h, gx, hx = self._slacks(data, u, x)
        du, dx = d[0], d[1]
        alpha = jnp.asarray(1.0, self.dtype)
        alpha = _ratio(alpha, g, du)
        alpha = _ratio(alpha, h, -du)
        alpha = _ratio(alpha, vars[3], d[3])
        alpha = _ratio(alpha, vars[4], d[4])
        if self.state_bounds:
            alpha = _ratio(alpha, gx, dx)
            alpha = _ratio(alpha, hx, -dx)
            alpha = _ratio(alpha, vars[5], d[5])
            alpha = _ratio(alpha, vars[6], d[6])
        return alpha

    def _gap_at(self, data, vars):
        u, x = vars[0], vars[1]
        g, h, gx, hx = self._slacks(data, u, x)
        acc = jnp.sum(jnp.abs(g * vars[3])) + jnp.sum(jnp.abs(h * vars[4]))
        if self.state_bounds:
            acc += jnp.sum(jnp.abs(gx * vars[5]))
            acc += jnp.sum(jnp.abs(hx * vars[6]))
        return acc / self.comp_count

    # ------------------------------------------------------------------
    # iteration / loop
    # ------------------------------------------------------------------

    def init_state(self, data: MPCData,
                   warm_start: Optional[dict] = None) -> MPCState:
        """Bound midpoints for u (and x under state bounds; otherwise the
        dynamics rollout, which zeroes the dynamics residual), ones for
        duals — the generic solver's initialisation carried over."""
        dt = self.dtype
        data = self._cast(data)
        T, ns, nu = self.T, self.ns, self.nu
        u = (0.5 * (data.l_u + data.u_u)).astype(dt)
        if self.state_bounds:
            x = (0.5 * (data.l_x + data.u_x)).astype(dt)
        else:
            def roll(xk, inp):
                Ak, Bk, ck, uk = inp
                xn = Ak @ xk + Bk @ uk + ck
                return xn, xn
            _, x = jax.lax.scan(
                roll, data.x0.astype(dt),
                (data.A.astype(dt), data.B.astype(dt), data.c.astype(dt),
                 u))
        ones = lambda *s: jnp.ones(s, dt)  # noqa: E731
        vals = [u, x, ones(T, ns), ones(T, nu), ones(T, nu)]
        if self.state_bounds:
            vals += [ones(T, ns), ones(T, ns)]
        if warm_start is not None:
            names = self._var_names()
            eps = 1e-2
            for i, name in enumerate(names):
                if name not in warm_start:
                    continue
                w = jnp.asarray(warm_start[name], dt)
                if name == "u":
                    w = jnp.clip(w, data.l_u + eps * (data.u_u - data.l_u),
                                 data.u_u - eps * (data.u_u - data.l_u))
                elif name == "x" and self.state_bounds:
                    w = jnp.clip(w, data.l_x + eps * (data.u_x - data.l_x),
                                 data.u_x - eps * (data.u_x - data.l_x))
                elif name.startswith("lambda_"):
                    w = jnp.maximum(w, eps)
                vals[i] = w
        vars = tuple(vals)
        residual, gap, res = self._metrics(data, vars)
        return MPCState(vars=vars, mu=jnp.asarray(self.mu0, dt),
                        iteration=jnp.asarray(0, jnp.int32),
                        residual=residual, gap=gap, res=res)

    def _var_names(self):
        names = ["u", "x", "y", "lambda_g", "lambda_h"]
        if self.state_bounds:
            names += ["lambda_gx", "lambda_hx"]
        return names

    def _cast(self, data: MPCData) -> MPCData:
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, self.dtype), data)

    def _gondzio_round(self, data, vars, factors, d, alpha, mu_target,
                       beta_min=0.1, beta_max=10.0, delta_alpha=0.1,
                       gamma=0.1):
        """One Gondzio centrality-corrector round (Gondzio 1996): at the
        enlarged trial step, complementarity products outside
        [beta_min, beta_max]*mu are pulled to the nearest bound with an
        extra solve against the SAME factor chain; kept only if the
        step lengthens."""
        dt = self.dtype
        T, ns, nu = self.T, self.ns, self.nu
        alpha_t = jnp.minimum(alpha + delta_alpha, 1.0)
        trial = tuple(v + alpha_t * dv for v, dv in zip(vars, d))
        g_t, h_t, gx_t, hx_t = self._slacks(data, trial[0], trial[1])
        mu_t = jnp.asarray(mu_target, dt)

        def pulled(p):
            return p - jnp.clip(p, beta_min * mu_t, beta_max * mu_t)

        comp = [pulled(g_t * trial[3]), pulled(h_t * trial[4])]
        if self.state_bounds:
            comp += [pulled(gx_t * trial[5]), pulled(hx_t * trial[6])]
        zeros_u = jnp.zeros((T, nu), dt)
        zeros_x = jnp.zeros((T, ns), dt)
        dm = self._direction(data, vars, factors, zeros_u, zeros_x,
                             zeros_x, tuple(comp))
        d_new = tuple(dv + dmv for dv, dmv in zip(d, dm))
        alpha_new = self._max_step(data, vars, d_new)
        accept = alpha_new >= jnp.minimum(alpha + gamma * delta_alpha, 1.0)
        d_out = tuple(jnp.where(accept, dn, dv)
                      for dn, dv in zip(d_new, d))
        return d_out, jnp.where(accept, alpha_new, alpha)

    def _step_impl(self, state: MPCState, data: MPCData) -> MPCState:
        dt = self.dtype
        data = self._cast(data)
        vars = state.vars
        u, x = vars[0], vars[1]
        lg, lh = vars[3], vars[4]
        g, h, gx, hx = self._slacks(data, u, x)
        gap = state.gap

        # barrier-condensed Hessians -> factor once per iteration
        Rt = _add_diag(data.R.astype(dt), lg / g + lh / h)
        if self.state_bounds:
            Qt = _add_diag(data.Q.astype(dt), vars[5] / gx + vars[6] / hx)
        else:
            Qt = data.Q.astype(dt)
        factors = riccati_factor(Qt, Rt, data.A.astype(dt),
                                 data.B.astype(dt))

        ru, rx, rd = state.res    # carried from the previous metrics pass

        # affine predictor (mu = 0)
        comp0 = [g * lg, h * lh]
        if self.state_bounds:
            comp0 += [gx * vars[5], hx * vars[6]]
        d_aff = self._direction(data, vars, factors, ru, rx, rd,
                                tuple(comp0))
        alpha_aff = self._max_step(data, vars, d_aff)

        trial = tuple(v + alpha_aff * dv for v, dv in zip(vars, d_aff))
        gap_aff = self._gap_at(data, trial)
        safe_gap = jnp.where(gap > 0, gap, 1.0)
        sigma = jnp.where(gap > 0, (gap_aff / safe_gap) ** 3, 0.0)
        mu_new = (gap * sigma).astype(dt)

        # corrector: recentred + exact second-order term (bilinear rows)
        du_a = d_aff[0]
        comp = [g * lg - mu_new + du_a * d_aff[3],
                h * lh - mu_new + (-du_a) * d_aff[4]]
        if self.state_bounds:
            dx_a = d_aff[1]
            comp += [gx * vars[5] - mu_new + dx_a * d_aff[5],
                     hx * vars[6] - mu_new + (-dx_a) * d_aff[6]]
        d_cc = self._direction(data, vars, factors, ru, rx, rd, tuple(comp))
        alpha = self._max_step(data, vars, d_cc)

        for _ in range(self.gondzio):
            d_cc, alpha = self._gondzio_round(data, vars, factors, d_cc,
                                              alpha, mu_new)

        step = self.fraction_to_boundary * alpha
        new_vars = tuple(v + step * dv for v, dv in zip(vars, d_cc))
        residual, new_gap, new_res = self._metrics(data, new_vars)
        return MPCState(vars=new_vars, mu=mu_new,
                        iteration=state.iteration + 1,
                        residual=residual, gap=new_gap, res=new_res)

    def _objective(self, data: MPCData, u, x):
        fx = 0.5 * jnp.einsum("ki,kij,kj->", x, data.Q, x) + \
            jnp.einsum("ki,ki->", data.q, x)
        fu = 0.5 * jnp.einsum("ki,kij,kj->", u, data.R, u) + \
            jnp.einsum("ki,ki->", data.r, u)
        return fx + fu

    def _solve_impl(self, data: MPCData,
                    warm_start: Optional[dict] = None) -> MPCSolveResult:
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
            # divergence rollback: keep the last good iterate
            keep = jax.tree_util.tree_map(
                lambda o, n_: jnp.where(bad, o, n_), state, new)
            return (keep, bad)

        state, step_diverged = jax.lax.while_loop(
            cond, body, (state0, jnp.asarray(False)))
        u, x = state.vars[0], state.vars[1]
        return MPCSolveResult(
            x=x, u=u,
            variables=dict(zip(self._var_names(), state.vars)),
            objective=self._objective(data, u, x),
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=(state.residual < tol) & (state.gap < tol),
            diverged=step_diverged | _bad(state),
        )

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def solve(self, data: MPCData,
              warm_start: Optional[dict] = None) -> MPCSolveResult:
        """Solve one MPC instance (jitted; first call compiles).

        ``warm_start``: previous ``MPCSolveResult.variables`` — the
        receding-horizon pattern (shift externally if desired)."""
        if warm_start is None:
            return self._solve_jit(data)
        if not hasattr(self, "_solve_warm_jit"):
            self._solve_warm_jit = jax.jit(self._solve_impl)
        return self._solve_warm_jit(data, warm_start)

    def step(self, state: MPCState, data: MPCData) -> MPCState:
        return self._step_jit(state, data)

    def solve_batch(self, data: MPCData) -> MPCSolveResult:
        """Batch of instances: every MPCData leaf carries a leading
        batch axis."""
        if not hasattr(self, "_solve_batch_jit"):
            self._solve_batch_jit = jax.jit(jax.vmap(self._solve_impl))
        return self._solve_batch_jit(data)


# ----------------------------------------------------------------------
# generators / converters
# ----------------------------------------------------------------------

def random_mpc(horizon: int = 16, n_states: int = 4, n_controls: int = 2,
               batch: int = 0, seed: int = 0, state_bounds: bool = False,
               dtype=None) -> MPCData:
    """Random stable tracking MPC instance(s) (deterministic per seed)."""
    rng = np.random.default_rng(seed)
    T, ns, nu = horizon, n_states, n_controls
    shape = (batch,) if batch else ()

    A = rng.normal(size=shape + (T, ns, ns))
    norm = np.max(np.abs(np.linalg.eigvals(A)), axis=-1)
    A = A * (0.95 / np.maximum(norm, 1e-6))[..., None, None]
    B = rng.normal(size=shape + (T, ns, nu))
    c = 0.1 * rng.normal(size=shape + (T, ns))
    x0 = rng.normal(size=shape + (ns,))

    M = rng.normal(size=shape + (T, ns, ns)) / np.sqrt(ns)
    Q = np.einsum("...ij,...kj->...ik", M, M)
    idx = np.arange(ns)
    Q[..., idx, idx] += 1.0
    q = 0.1 * rng.normal(size=shape + (T, ns))
    Mr = rng.normal(size=shape + (T, nu, nu)) / np.sqrt(nu)
    R = np.einsum("...ij,...kj->...ik", Mr, Mr)
    jdx = np.arange(nu)
    R[..., jdx, jdx] += 0.5
    r = 0.1 * rng.normal(size=shape + (T, nu))

    lim = 1.0 if state_bounds else 1e3
    return MPCData(
        A=jnp.asarray(A, dtype), B=jnp.asarray(B, dtype),
        c=jnp.asarray(c, dtype), x0=jnp.asarray(x0, dtype),
        Q=jnp.asarray(Q, dtype), q=jnp.asarray(q, dtype),
        R=jnp.asarray(R, dtype), r=jnp.asarray(r, dtype),
        l_u=jnp.full(shape + (T, nu), -1.0, dtype),
        u_u=jnp.full(shape + (T, nu), 1.0, dtype),
        l_x=jnp.full(shape + (T, ns), -lim, dtype),
        u_x=jnp.full(shape + (T, ns), lim, dtype))


def condense(data: MPCData):
    """Eliminate states -> the equivalent dense box QP on u (numpy, for
    parity tests and dense-path comparison benches).

    Returns (QPData, S, free): z = vec(u_0..u_{T-1}),
    vec(x_1..x_T) = S z + free, objective 1/2 z'Hz + g'z (+ const);
    state bounds become general inequality rows l_x - free <= S z <=
    u_x - free.
    """
    from .data import QPData

    A = np.asarray(data.A, np.float64)
    B = np.asarray(data.B, np.float64)
    c = np.asarray(data.c, np.float64)
    x0 = np.asarray(data.x0, np.float64)
    Q = np.asarray(data.Q, np.float64)
    q = np.asarray(data.q, np.float64)
    R = np.asarray(data.R, np.float64)
    r = np.asarray(data.r, np.float64)
    T, ns, nu = A.shape[0], A.shape[1], B.shape[2]
    n = T * nu

    # x_k = Phi_k x0-part + sum_j S[k,j] u_j
    S = np.zeros((T * ns, n))
    free = np.zeros(T * ns)
    xf = x0.copy()
    for k in range(T):
        # free response: x_{k+1} = A_k x_free_k + c_k
        if k == 0:
            S[:ns, :nu] = B[0]
        else:
            S[k * ns:(k + 1) * ns] = A[k] @ S[(k - 1) * ns:k * ns]
            S[k * ns:(k + 1) * ns, k * nu:(k + 1) * nu] += B[k]
        xf = A[k] @ xf + c[k]
        free[k * ns:(k + 1) * ns] = xf

    Qbar = np.zeros((T * ns, T * ns))
    for k in range(T):
        Qbar[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = Q[k]
    Rbar = np.zeros((n, n))
    for k in range(T):
        Rbar[k * nu:(k + 1) * nu, k * nu:(k + 1) * nu] = R[k]
    H = S.T @ Qbar @ S + Rbar
    H = 0.5 * (H + H.T)
    g = S.T @ (Qbar @ free + q.ravel()) + r.ravel()

    qp = QPData.make(
        Q=H, c=g,
        A_ineq=S,
        l_A_ineq=np.asarray(data.l_x, np.float64).ravel() - free,
        u_A_ineq=np.asarray(data.u_x, np.float64).ravel() - free,
        l_x=np.asarray(data.l_u, np.float64).ravel(),
        u_x=np.asarray(data.u_u, np.float64).ravel())
    return qp, S, free
