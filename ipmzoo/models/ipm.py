"""The compiled Mehrotra predictor-corrector IPM.

``CompiledIPM`` binds a symbolic formulation (Settings -> Newton system ->
augmented reduction, from :mod:`ipmzoo.formulations`) to concrete
problem sizes and stages the ENTIRE solve — KKT assembly, LDL^T
factorisation, predictor, fraction-to-boundary line search, Mehrotra
centering, corrector, step — into one ``lax.while_loop`` compiled by XLA.

Per-iteration structure (numerically equivalent to the reference driver,
/root/reference/src/NumericalOptimization/Optimizer.cpp:77-220, with the
interpreter walks replaced by trace-time staging):

  1. residual norm and duality measure of the full KKT residual at mu=0
  2. assemble the augmented KKT matrix; factor once (LDL^T, pivot floor)
  3. affine predictor: residual vectors at mu=0, solve, back-substitute
     eliminated variables via the symbolic delta definitions
  4. ratio test over nonnegative variables (+ explicit box tests for the
     Slacks formulations), trial step, mu_aff, sigma = (mu_aff/mu)^3
  5. corrector: complementarity residuals re-centred with sigma*mu and
     augmented by the affine correction Delta X_aff Delta S_aff e
     (derived symbolically at compile time), second solve with the SAME
     factorisation
  6. step all variables by 0.995 * alpha

Everything is a pure function of (state, data): vmap gives batched
multi-QP solving, shard_map distributes batches over a device mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formulations import (Settings, VariableNames, augmented_system,
                            build_symbols, delta_variable, newton_system,
                            normal_equations, shorthand_rhs)
from ..ops.ldlt import solve_ldlt
from ..symbolic import expr as E
from . import codegen as cg
from .data import QPData

from .compact import CompactScheduleMixin
from .directions import DirectionsMixin
from .kernels import KernelDispatchMixin
from .ndplan import NdPlanMixin
from .state import IPMState, SolveResult

__all__ = ["CompiledIPM", "IPMState", "SolveResult"]


class CompiledIPM(KernelDispatchMixin, DirectionsMixin,
                  CompactScheduleMixin, NdPlanMixin):
    """A formulation + problem-size specialised, fully staged IPM solver.

    The per-iteration factor/solve staging lives in
    :class:`.kernels.KernelDispatchMixin`, the residual/corrector/line-
    search staging in :class:`.directions.DirectionsMixin`, the
    compaction-scheduled batch engines in
    :class:`.compact.CompactScheduleMixin`, and the nested-dissection
    plan lifecycle in :class:`.ndplan.NdPlanMixin`."""

    def __init__(self, settings: Settings, n: int, m_ineq: int = 0,
                 m_eq: int = 0, *, names: VariableNames = VariableNames(),
                 dtype=jnp.float64, tol: float = 1e-8, max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 delta0: float = 1e-4, pivot_floor: float = 1e-8,
                 refine: int = 0, kernel: str = "auto",
                 scale_tol: bool = False, gondzio: int = 0,
                 mu_floor: float | str = "auto",
                 hybrid_refine: bool = False, df_residuals: bool = False,
                 two_float: bool = False, mesh=None,
                 mesh_axis: str = "tp", panel: Optional[int] = None,
                 nd_pattern=None, nd_leaf: int = 32,
                 nd_fallback: bool = True, block_inv="auto",
                 taylor: str = "staged"):
        self.settings = settings
        self.n, self.m_ineq, self.m_eq = n, m_ineq, m_eq
        self.dtype = dtype
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        self.delta0 = delta0
        self.pivot_floor = pivot_floor
        #: extra iterative-refinement sweeps per linear solve (use 1-2 in
        #: float32 to recover near-f64 direction accuracy)
        self.refine = refine
        #: evaluate refinement residuals in two-float (double-single)
        #: compensated arithmetic (ops/twofloat.py) — mixed-precision
        #: refinement: f32 factorisation, ~2x-precision residual, so the
        #: refined direction reaches the f32 representation floor even on
        #: ill-conditioned systems.  No effect unless refine > 0.
        self.hybrid_refine = hybrid_refine
        #: stage the residual/metric pipeline in two-float pairs
        #: (models/codegen_df.py): residual rows near convergence are
        #: pure cancellation, so working-precision evaluation noise-
        #: floors them; pair evaluation keeps their RELATIVE error small,
        #: giving f64-grade Newton right-hand sides and convergence
        #: metrics from f32 arithmetic.  Factorisations stay f32.
        #: run the ENTIRE solver pipeline in two-float (double-single)
        #: pairs: iterates are stored as (hi, lo) pairs (stacked (2, n)
        #: arrays), residuals/metrics/corrector run through codegen_df,
        #: and the augmented system is assembled AND FACTORED in pairs
        #: (ops/ldlt_df.py).  This removes both obstacles to 1e-8
        #: convergence in f32: the factorisation's eps*cond(K) limit
        #: (pair unit roundoff ~2^-48) and the iterate-representation
        #: floor (an f32-rounded iterate cannot have residual below
        #: ~eps_f32 * ||Q x||, so high-accuracy iterates must be pairs).
        #: Gives reference-parity tol 1e-8
        #: (/root/reference/src/NumericalOptimization/Optimizer.cpp:124,133)
        #: from pure f32 arithmetic; see tests/test_precision_floor.py.
        self.two_float = two_float
        if two_float:
            if kernel not in ("auto", "ldlt"):
                raise ValueError(
                    "two_float=True factors in double-single pairs and "
                    "supports kernel='auto'/'ldlt' only")
            df_residuals = True
        self.df_residuals = df_residuals
        from . import codegen_df as cgdf_mod
        self._cgm = cgdf_mod if df_residuals else cg

        self._kernel_choice = kernel
        if kernel not in ("auto", "ldlt", "jnp", "block", "blockg", "lu",
                          "regldlt", "normal", "sharded", "nd"):
            raise ValueError(
                f"unknown kernel={kernel!r}; expected one of "
                "('auto', 'ldlt', 'jnp', 'block', 'blockg', 'lu', "
                "'regldlt', 'normal', 'sharded', 'nd')")
        if kernel == "normal" and df_residuals:
            raise NotImplementedError(
                "kernel='normal' pre-binds dense-matrix inverses in working "
                "precision; the two-float residual pipeline does not "
                "consume them — use the augmented-system kernels with "
                "df_residuals")
        #: number of Gondzio multiple-centrality-corrector rounds per
        #: iteration (0 = plain Mehrotra, matching the reference).  Each
        #: round reuses the factorisation to push complementarity
        #: products toward the central path and is accepted only if it
        #: lengthens the step.
        self.gondzio = gondzio
        #: lower bound on the centering parameter mu, tied to the working
        #: dtype.  Mehrotra's sigma=(mu_aff/mu)^3 can drive mu to (or
        #: below) the dtype's resolution in one step; in f32 the barrier
        #: diagonals ~lambda/s ~ lambda^2/mu then overflow inside the
        #: factorisation (products reach ~1/mu^2) and the step NaNs out,
        #: tripping the divergence rollback.  "auto" = eps(dtype)^2 * mu0
        #: (f32: ~1.4e-14, f64: ~4.9e-32): far below any realistic gap
        #: tolerance, but high enough that 1/mu^2 stays finite.
        if mu_floor == "auto":
            mu_floor = float(jnp.finfo(dtype).eps) ** 2 * mu0
        self.mu_floor = float(mu_floor)
        #: scale the residual test by (1 + initial residual norm) — the
        #: standard relative criterion for large problems, where an
        #: absolute norm test is dominated by dtype precision floors.
        #: (The reference uses absolute tolerances, suited to its tiny
        #: demo; gap stays absolute either way.)
        self.scale_tol = scale_tol

        o = build_symbols(names)
        self.symbols = o
        self.names = names

        # --- symbolic derivation (compile time) --------------------------
        full = newton_system(settings, names)
        sh = shorthand_rhs(full)
        reduced = full.copy()
        reduced.rhs = list(sh.shorthand_rhs)
        aug = augmented_system(reduced)
        self.full, self.sh, self.aug = full, sh, aug
        # The normal-equations reduction (one more elimination: the leading
        # Q/x block; reference derivation SymbolicOptimization.cpp:465-478,
        # stored by the reference Optimizer ctor at Optimizer.cpp:39-40 but
        # never consumed numerically there — here kernel='normal' solves it)
        self.norm = normal_equations(reduced) if kernel == "normal" else None

        # A symbolically zero diagonal block means the augmented system is
        # genuinely indefinite: unpivoted LDL^T is unsound there, so those
        # formulations route to a partial-pivoting LU factorisation (the
        # reference implementation simply hard-fails on them,
        # Optimizer.cpp:75).
        self._indefinite = any(aug.lhs[i][i] is E.ZERO
                               for i in range(len(aug.lhs)))
        if self._indefinite and kernel not in ("auto", "lu", "regldlt"):
            raise NotImplementedError(
                "augmented system has a symbolically zero diagonal block "
                "(indefinite); use kernel='regldlt' / 'lu' (or 'auto'), or "
                "a formulation with a quasi-definite augmented system")

        # --- sizes, offsets, index maps ----------------------------------
        size_of = {
            o.x: n, o.s_x_l: n, o.s_x_u: n, o.lambda_sxl: n, o.lambda_sxu: n,
            o.s_A_ineq: m_ineq, o.s_A_ineq_l: m_ineq, o.s_A_ineq_u: m_ineq,
            o.lambda_A_ineq: m_ineq, o.lambda_sAineql: m_ineq,
            o.lambda_sAinequ: m_ineq,
            o.s_A_eq: m_eq, o.s_A_eq_l: m_eq, o.s_A_eq_u: m_eq, o.p_eq: m_eq,
            o.lambda_A_eq: m_eq, o.lambda_sAeql: m_eq, o.lambda_sAequ: m_eq,
        }
        self.size_of = size_of
        self.var_sizes = [size_of[v] for v in full.variables]
        self.aug_sizes = [size_of[v] for v in aug.variables]
        self.aug_dim = sum(self.aug_sizes)
        self.var_index = {v: i for i, v in enumerate(full.variables)}

        # the reduction the linear solver actually consumes: the condensed
        # normal-equations system for kernel='normal', else the augmented
        self.red = self.norm if self.norm is not None else aug
        self.red_sizes = [size_of[v] for v in self.red.variables]
        self.red_dim = sum(self.red_sizes)
        # Dense-matrix inverses introduced by eliminating the leading Q/x
        # block (H^{-1} with H = aug.lhs[0][0]).  They appear in the
        # condensed cells, rhs and back-substitutions; the solver evaluates
        # each ONCE per iteration (LDL^T factor + solve against I) and
        # binds the value into the environment so every later evaluation
        # short-circuits — the same memoisation role the reference's
        # Environment plays (Evaluation.cpp:106-108).
        self._matrix_inverts = tuple(
            self._collect_matrix_inverts()) if self.norm is not None else ()

        # delta symbol -> original variable
        self.delta_to_var = {delta_variable(v): v for v in full.variables}
        # affine delta symbols (bind predictor direction for the corrector)
        self.affine_sym = {
            v: E.variable(delta_variable(v).name + "_affine")
            for v in full.variables}

        # complementarity rows: contain an e-vector and mu
        e_vecs = (o.e_var, o.e_ineq, o.e_eq)
        def is_comp(expr):
            return (any(expr.contains(ev) for ev in e_vecs) and
                    expr.contains(o.mu))
        self.comp_rows = [i for i, r in enumerate(full.rhs) if is_comp(r)]

        # Corrector: the reference substitutes affine-delta symbols for the
        # variables of each complementarity residual (Optimizer.cpp:183-209),
        # which is only the true second-order Mehrotra term when the row is
        # a pure product of variables (e.g. SlackedSlacks' G lambda - mu e).
        # For Slacks-handling rows like (X - L) lambda - mu e it injects a
        # spurious -L Delta-lambda term, and the reference stalls on its own
        # demo QP.  We instead stage the exact quadratic Taylor remainder
        #     corr_i = c_i(v + d_aff) - c_i(v) - J_i d_aff
        # which coincides with the reference's corrector on the rows where
        # that one is correct and fixes the rest (all rows are at most
        # quadratic, so the remainder is exact).
        self.corrector = [(vec, definition, is_comp(definition))
                          for vec, definition in sh.vector_definitions]
        # taylor="symbolic": the remainder above as a SIMPLIFIED
        # expression in the affine-delta symbols, staged once, instead
        # of the generic three-point numeric computation.  Exact at ANY
        # simplification level (the formula is the same polynomial
        # identity the numeric path computes), so this is a pure
        # evaluation-cost trade; opt-in until measured on the card.
        if taylor not in ("staged", "symbolic"):
            raise ValueError(f"unknown taylor={taylor!r}; expected "
                             "'staged' or 'symbolic'")
        self.taylor = taylor
        self.corrector_rem = (self._build_symbolic_corrector()
                              if taylor == "symbolic" else None)

        # nonnegative variables (fraction-to-boundary set)
        nonneg = {o.s_A_ineq_l, o.s_A_ineq_u, o.s_x_l, o.s_x_u, o.s_A_eq_l,
                  o.s_A_eq_u, o.lambda_sAeql, o.lambda_sAequ,
                  o.lambda_sAineql, o.lambda_sAinequ, o.lambda_sxl,
                  o.lambda_sxu}
        self.nonneg_idx = [i for i, v in enumerate(full.variables)
                           if v in nonneg]

        # explicit box ratio tests apply when the bound slacks were not
        # introduced as variables (Slacks handling keeps l <= s <= u and
        # l_x <= x <= u_x explicit)
        var_set = set(full.variables)
        self.box_test = (o.s_A_ineq_l not in var_set and
                         o.s_A_ineq_u not in var_set)
        self.x_has_lb = settings.variable_bounds.has_lower
        self.x_has_ub = settings.variable_bounds.has_upper
        self.s_has_lb = settings.inequalities.has_lower
        self.s_has_ub = settings.inequalities.has_upper

        # objective expression (plain QP objective, no barrier terms)
        self.objective_expr = E.sum_expr([
            E.product([E.number(0.5), E.transpose(o.x), o.Q, o.x]),
            E.product([E.transpose(o.c), o.x])])

        # --- linear-solver mode -----------------------------------------
        # "ldlt": dense LDL^T; unbatched calls use the jnp kernel and
        #   vmapped (batched) calls go where ops/routes.py says (the
        #   batched Pallas kernels on the GPU) via custom_vmap.
        # "jnp": dense LDL^T forced onto the pure-jnp blocked kernel (no
        #   Pallas dispatch) — the portable path.
        # "block": block elimination (blocked Cholesky + dense Schur)
        #   for 2x2 augmented structures — the fast path for large n.
        # "blockg": signed block-Cholesky over the symbolic group
        #   structure (ops/blockg.py) — G Cholesky stages + matmul trailing
        #   updates for ANY quasi-definite augmented system; diagonal
        #   signs are structural (+ primal groups, - dual groups,
        #   Vanderbei 1995).
        # "regldlt": signed-regularised LDL^T + iterative refinement for
        #   genuinely indefinite augmented systems (zero dual diagonal,
        #   e.g. EqualityHandling.NONE): add +delta I to primal rows and
        #   -delta I to dual rows (primal-dual proximal regularisation),
        #   making the system quasi-definite so the unpivoted (batched
        #   Pallas) LDL^T kernels apply, then refine against the TRUE
        #   unregularised matrix until the perturbation is gone.
        #   Auto-selected for indefinite systems: dynamic-pivoting LU is
        #   hostile to batched fixed-shape device execution.
        # "lu": partial-pivoting LU (XLA's generic kernel; the dynamic-
        #   pivoting reference choice, kept for parity/fallback).
        # "auto": block when the augmented system is 2x2 and the leading
        #   block is large enough for blocked Cholesky to win; blockg for
        #   other large quasi-definite structures.
        can_block = self._can_block = (len(self.aug.variables) == 2 and
                     self.aug.variables[0] is o.x)
        dual_groups = {o.lambda_A_ineq, o.lambda_sAineql, o.lambda_sAinequ,
                       o.lambda_A_eq, o.lambda_sAeql, o.lambda_sAequ,
                       o.lambda_sxl, o.lambda_sxu}
        self.group_signs = tuple(
            -1.0 if v in dual_groups else 1.0 for v in self.aug.variables)
        # signed row regularisation for the regldlt mode, the blockg
        # stage signs, and the nd amalgamated-top split: +1 on primal
        # groups, -1 on dual groups
        self._sign_vec = np.concatenate(
            [np.full(s, sign, dtype=np.float64)
             for s, sign in zip(self.aug_sizes, self.group_signs)]
        ) if self.aug_sizes else np.zeros((0,))
        if two_float:
            # pair-assembled, pair-factored LDL^T; indefinite systems get
            # the same signed proximal regularisation as 'regldlt', with
            # pair-precision refinement against the true K
            self._mode = "tf"
        elif self._indefinite:
            self._mode = "lu" if kernel == "lu" else "regldlt"
        elif kernel == "lu":
            self._mode = "lu"
        elif kernel == "regldlt":
            self._mode = "regldlt"
        elif kernel == "sharded":
            # TP axis consumer: the ONE augmented KKT system is row-
            # sharded over the mesh and factored cooperatively by the
            # panel-sharded LDL^T (ops/sharded_ldlt.py) inside every
            # Mehrotra iteration — the end-to-end solve for QPs whose
            # KKT factorisation exceeds a single chip.  The system is
            # identity-padded to a multiple of (devices * panel): an
            # unpivoted LDL^T of blockdiag(K, I) factors the padding
            # trivially, so the solution is unchanged and any aug_dim
            # shards cleanly.
            if mesh is None:
                raise ValueError("kernel='sharded' requires mesh=")
            self._mesh, self._mesh_axis = mesh, mesh_axis
            ndev = mesh.shape[mesh_axis]
            rpd0 = max(self.aug_dim // ndev, 1)
            p = panel if panel is not None else min(128, rpd0)
            chunk = ndev * p
            self._sharded_panel = p
            self._sharded_dim = ((self.aug_dim + chunk - 1)
                                 // chunk) * chunk
            self._mode = "sharded"
        elif kernel == "nd":
            # General-sparsity path: nested-dissection block elimination
            # of the augmented KKT (ops/ndiss.py).  The dissection plan
            # (separator tree, elimination order, fill, padding) is built
            # on the HOST from the KKT sparsity pattern; the device
            # program is O(log n) levels of batched dense block ops.
            # The pattern is static problem structure: pass it as
            # nd_pattern, or leave None and the first solve derives it
            # from the data (assembling one KKT eagerly).
            self._mode = "nd"
            self._nd_leaf = nd_leaf
            #: auto-fallback: refuse a dissection plan predicted to LOSE
            #: to the dense path (ops/ndiss.py::nd_predicted_speedup —
            #: per-level fixed overhead swamps the flop savings at small
            #: n) and route to the dense auto kernel instead.  Disable
            #: with nd_fallback=False to force the plan (benchmarks).
            self._nd_fallback = nd_fallback
            self.nd_fell_back = False
            if nd_pattern is not None:
                from ..ops.ndiss import nd_plan
                self._nd_plan = nd_plan(np.asarray(nd_pattern),
                                        leaf=nd_leaf,
                                        signs=self._sign_vec)
                self._maybe_nd_fallback()
            else:
                self._nd_plan = None
        elif kernel == "block":
            if not can_block:
                raise ValueError("kernel='block' needs a 2x2 augmented "
                                 "system with x in the leading block")
            self._mode = "block"
        elif kernel == "blockg":
            self._mode = "blockg"
        elif kernel == "normal":
            self._mode = "normal"
        elif kernel == "auto" and can_block and n >= 384:
            self._mode = "block"
        elif kernel == "auto" and self.aug_dim >= 384:
            self._mode = "blockg"
        else:
            self._mode = "ldlt"
        if self._mode in ("ldlt", "regldlt") and \
                kernel in ("auto", "ldlt", "regldlt") and pivot_floor == 1e-8:
            from ..ops.pallas_ldlt import ldlt_auto, solve_ldlt_auto
            self._factor = ldlt_auto
            self._solve_kernel = solve_ldlt_auto
        else:
            from ..ops.blocked_ldlt import ldlt_blocked
            self._factor = lambda K: ldlt_blocked(K, self.pivot_floor)
            self._solve_kernel = solve_ldlt

        #: 'block' mode: bind explicit H^{-1}/S^{-1} per iteration so
        #: direction solves are matvecs (ops/block_solve.py::
        #: block2_factor_inv).  "auto" = OFF: the n-rhs triangular
        #: solve pair behind the explicit inverse only pays for itself
        #: with many more solves per factorisation than an IPM step
        #: issues (not measured on the GPU yet; tools/normal_probe.py
        #: times both).  Kept as an explicit opt-in.
        if block_inv == "auto":
            block_inv = False
        self._block_inv = bool(block_inv)

        # jitted entry points
        self._solve_jit = jax.jit(self._solve_impl)
        self._step_jit = jax.jit(self._step_impl)

    # ------------------------------------------------------------------
    # environment plumbing
    # ------------------------------------------------------------------

    def _base_env(self, data: QPData, mu_val) -> cg.Env:
        o = self.symbols
        dt = self.dtype
        ones = functools.partial(jnp.ones, dtype=dt)
        return {
            o.Q: cg.matrix(data.Q.astype(dt)),
            o.c: cg.vector(data.c.astype(dt)),
            o.A_ineq: cg.matrix(data.A_ineq.astype(dt)),
            o.l_A_ineq: cg.vector(data.l_A_ineq.astype(dt)),
            o.u_A_ineq: cg.vector(data.u_A_ineq.astype(dt)),
            o.A_eq: cg.matrix(data.A_eq.astype(dt)),
            o.b_eq: cg.vector(data.b_eq.astype(dt)),
            o.l_x: cg.vector(data.l_x.astype(dt)),
            o.u_x: cg.vector(data.u_x.astype(dt)),
            o.delta_eq: cg.scalar(jnp.asarray(self.delta0, dt)),
            o.mu: cg.scalar(jnp.asarray(mu_val, dt)),
            o.e_var: cg.vector(ones(self.n)),
            o.e_ineq: cg.vector(ones(self.m_ineq)),
            o.e_eq: cg.vector(ones(self.m_eq)),
        }

    def _env(self, data: QPData, var_vals, mu_val) -> cg.Env:
        if self.two_float:
            # the problem data is exact in working precision (lo = 0);
            # the ITERATE carries genuine low words
            from . import codegen_df as cgdf
            env = cgdf.lift_env(self._base_env(data, mu_val))
            for var, val in zip(self.full.variables, var_vals):
                env[var] = cgdf.DFTV("vector", val[0], val[1])
            return env
        env = self._base_env(data, mu_val)
        for var, val in zip(self.full.variables, var_vals):
            env[var] = cg.vector(val)
        return env

    def _lift(self, env: cg.Env):
        """Promote a working-precision env for the residual pipeline."""
        if not self.df_residuals or self.two_float:
            return env  # two-float envs are built lifted
        from . import codegen_df as cgdf
        return cgdf.lift_env(env)

    def _envm(self, data: QPData, var_vals, mu_val):
        return self._lift(self._env(data, var_vals, mu_val))

    # --- two-float state helpers --------------------------------------
    # State variables are plain (n,) arrays normally, stacked (2, n)
    # (hi, lo) pairs under two_float.  These helpers keep the step/loop
    # logic mode-agnostic.

    def _var_val(self, v):
        """Rounded working-precision value of a state variable/delta."""
        return (v[0] + v[1]) if self.two_float else v

    def _vec_tv(self, d):
        """Bind a state-variable array as a codegen value."""
        if self.two_float:
            from . import codegen_df as cgdf
            return cgdf.DFTV("vector", d[0], d[1])
        return self._cgm.vector(d)

    def _axpy(self, v, a, d):
        """v + a * d (pair-exact under two_float; a is a plain scalar)."""
        if not self.two_float:
            return v + a * d
        from ..ops.twofloat import df_add, df_mul
        ah = jnp.asarray(a, self.dtype)
        zero = jnp.zeros_like(ah)
        s = df_add((v[0], v[1]), df_mul((ah, zero), (d[0], d[1])))
        return jnp.stack(s)

    def _dadd(self, a, b):
        """a + b on state-variable arrays (pair-renormalising)."""
        if not self.two_float:
            return a + b
        from ..ops.twofloat import df_add
        return jnp.stack(df_add((a[0], a[1]), (b[0], b[1])))

    # ------------------------------------------------------------------
    # staged computations
    # ------------------------------------------------------------------

    def _metrics(self, env0):
        """(residual norm, duality gap) of the full system at mu=0.

        ``env0`` is a working-precision env, or a lifted two-float env
        when ``df_residuals`` (then norms are compensated too)."""
        m = self._cgm
        memo = {}
        dt = self.dtype
        if sum(self.var_sizes) == 0:
            return jnp.asarray(0.0, dt), jnp.asarray(0.0, dt)
        vals = [m.as_vector(m.evaluate(r, env0, memo), sz)
                for r, sz in zip(self.full.rhs, self.var_sizes)]
        comp_size = sum(self.var_sizes[i] for i in self.comp_rows)
        if self.df_residuals:
            from . import codegen_df as cgdf
            residual = cgdf.norm2([v.pair for v in vals]).astype(dt)
            if comp_size == 0:
                gap = jnp.asarray(0.0, dt)
            else:
                gap = (cgdf.abs_sum([vals[i].pair
                                     for i in self.comp_rows]) /
                       comp_size).astype(dt)
            return residual, gap
        r = jnp.concatenate([v for v in vals]) if vals else jnp.zeros(0, dt)
        residual = jnp.sqrt(jnp.dot(r, r))
        comp = [vals[i] for i in self.comp_rows]
        if comp_size == 0:
            gap = jnp.asarray(0.0, dt)
        else:
            gap = jnp.sum(jnp.abs(jnp.concatenate(comp))) / comp_size
        return residual, gap

    def _gap_only(self, env0):
        """Duality measure alone (evaluates only the complementarity
        rows — used for mu_aff at the affine trial point, where the full
        residual is not needed)."""
        m = self._cgm
        dt = self.dtype
        comp_size = sum(self.var_sizes[i] for i in self.comp_rows)
        if comp_size == 0:
            return jnp.asarray(0.0, dt)
        memo = {}
        if self.df_residuals:
            from . import codegen_df as cgdf
            pairs = [m.as_vector(m.evaluate(self.full.rhs[i], env0, memo),
                                 self.var_sizes[i]).pair
                     for i in self.comp_rows]
            return (cgdf.abs_sum(pairs) / comp_size).astype(dt)
        acc = jnp.asarray(0.0, dt)
        for i in self.comp_rows:
            v = cg.as_vector(cg.evaluate(self.full.rhs[i], env0, memo),
                             self.var_sizes[i])
            if v.shape[0]:
                acc = acc + jnp.sum(jnp.abs(v))
        return acc / comp_size

    # ------------------------------------------------------------------
    # iteration / loop
    # ------------------------------------------------------------------

    def init_state(self, data: QPData,
                   warm_start: Optional[dict] = None) -> IPMState:
        """Build the initial iterate: bound midpoints for x and s, ones
        elsewhere (the reference's initialisation).  ``warm_start`` maps
        variable names (e.g. ``"x"``) to starting values — for MPC-style
        receding-horizon resolves, pass the previous solution's
        ``SolveResult.variables``; interior variables are nudged off
        their bounds for strict feasibility."""
        dt = self.dtype
        o = self.symbols
        init = {
            o.x: 0.5 * (data.l_x + data.u_x).astype(dt),
            o.s_A_ineq: 0.5 * (data.l_A_ineq + data.u_A_ineq).astype(dt),
        }
        nonneg = {self.full.variables[i] for i in self.nonneg_idx}
        vals = []
        for v, sz in zip(self.full.variables, self.var_sizes):
            if warm_start is not None and v.name in warm_start:
                w = jnp.asarray(warm_start[v.name], dt)
                if v in nonneg:
                    # keep strictly interior
                    w = jnp.maximum(w, 1e-2)
                vals.append(w)
            else:
                vals.append(init.get(v, jnp.ones(sz, dt)))
        if self.two_float:
            vals = [jnp.stack([v, jnp.zeros_like(v)]) for v in vals]
        env0 = self._envm(data, vals, 0.0)
        residual, gap = self._metrics(env0)
        return IPMState(vars=tuple(vals), mu=jnp.asarray(self.mu0, dt),
                        iteration=jnp.asarray(0, jnp.int32),
                        residual=residual, gap=gap)

    def _step_impl(self, state: IPMState, data: QPData,
                   gondzio: Optional[int] = None,
                   nd_pre=None) -> IPMState:
        env = self._env(data, state.vars, state.mu)
        envm = self._lift(env)
        gap = state.gap

        # factor the augmented KKT once (always working precision)
        solve_fn = self._make_solve(env, nd_pre=nd_pre)

        # affine predictor (mu = 0)
        renv = self._residual_env(envm, 0.0)
        d_aff = self._search_direction(solve_fn, renv)
        alpha_aff = self._max_step(env, state.vars, d_aff)

        # trial step -> mu_aff -> sigma
        trial = tuple(self._axpy(v, alpha_aff, d)
                      for v, d in zip(state.vars, d_aff))
        tenv = self._envm(data, trial, 0.0)
        gap_aff = self._gap_only(tenv)
        dt = self.dtype
        safe_gap = jnp.where(gap > 0, gap, 1.0)
        sigma = jnp.where(gap > 0, (gap_aff / safe_gap) ** 3, 0.0)
        mu_new = jnp.maximum(gap * sigma,
                             jnp.asarray(self.mu_floor, dt)).astype(dt)

        # corrector with recentred complementarity + affine correction
        cenv = self._residual_env(envm, mu_new, data=data,
                                  var_vals=state.vars, affine_deltas=d_aff)
        d_cc = self._search_direction(solve_fn, cenv)
        alpha = self._max_step(env, state.vars, d_cc)

        # Gondzio multiple centrality correctors: push trial-point
        # complementarity products into [beta_min, beta_max] * mu with
        # extra solves against the SAME factorisation; accept a round
        # only if it lengthens the step.
        n_gondzio = self.gondzio if gondzio is None else gondzio
        for _ in range(n_gondzio):
            d_cc, alpha = self._gondzio_round(envm, data, state.vars,
                                              solve_fn, d_cc, alpha,
                                              mu_new)

        step = self.fraction_to_boundary * alpha
        new_vars = tuple(self._axpy(v, step, d)
                         for v, d in zip(state.vars, d_cc))

        nenv = self._envm(data, new_vars, 0.0)
        residual, new_gap = self._metrics(nenv)
        return IPMState(vars=new_vars, mu=mu_new,
                        iteration=state.iteration + 1,
                        residual=residual, gap=new_gap)

    def _nd_prework(self, data: QPData):
        """Loop-invariant prework of the nd diagonal-split path: the
        reference KKT (data-derived strictly-interior point) cut into
        the plan's static slabs, plus its diagonal.  Computed once
        OUTSIDE the solver loop (XLA's loop-invariant code motion does
        not hoist gathers, so the hoisting is structural)."""
        if self._mode != "nd" or not getattr(self, "_nd_diag_split",
                                             False):
            return None
        from ..ops.ndiss import nd_prework
        env_ref = self._nd_ref_env(self._base_env(data, 1.0))
        K_ref = self._assemble_kkt(env_ref)
        return (nd_prework(K_ref, self._nd_plan),
                self._assemble_diag(env_ref))

    def _solve_impl(self, data: QPData,
                    warm_start: Optional[dict] = None) -> SolveResult:
        state0 = self.init_state(data, warm_start)
        if self.scale_tol:
            res_tol = self.tol * (1.0 + state0.residual)
        else:
            res_tol = jnp.asarray(self.tol, self.dtype)
        tol = self.tol
        nd_pre = self._nd_prework(data)

        def _bad(s):
            return jnp.isnan(s.residual) | jnp.isinf(s.residual) | \
                jnp.isnan(s.gap)

        def cond(carry):
            state, diverged = carry
            done = (state.residual < res_tol) & (state.gap < tol)
            return (~done) & (~diverged) & \
                (state.iteration < self.max_iter)

        def body(carry):
            state, _ = carry
            new = self._step_impl(state, data, nd_pre=nd_pre)
            bad = _bad(new)
            # divergence rollback: a numerically failed step (e.g. an
            # f32 factorisation overflowing once mu underflows) returns
            # the LAST GOOD iterate instead of NaN garbage
            keep = jax.tree_util.tree_map(
                lambda o, n_: jnp.where(bad, o, n_), state, new)
            return (keep, bad)

        state, step_diverged = jax.lax.while_loop(
            cond, body, (state0, jnp.asarray(False)))
        env = self._env(data, state.vars, state.mu)
        f = self._cgm.evaluate(self.objective_expr, env).val \
            if self.two_float else cg.evaluate(self.objective_expr,
                                               env).val
        x = self._var_val(state.vars[self.var_index[self.symbols.x]])
        return SolveResult(
            x=x,
            variables={v.name: self._var_val(val) for v, val in
                       zip(self.full.variables, state.vars)},
            objective=f,
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=(state.residual < res_tol) & (state.gap < tol),
            diverged=step_diverged | _bad(state),
        )

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def solve(self, data: QPData,
              warm_start: Optional[dict] = None) -> SolveResult:
        """Solve one QP instance (jitted; first call compiles).

        ``warm_start``: optional dict of variable name -> initial value
        (e.g. a previous ``SolveResult.variables``)."""
        self._ensure_nd_plan(data)
        if warm_start is None:
            return self._solve_jit(data)
        if not hasattr(self, "_solve_warm_jit"):
            self._solve_warm_jit = jax.jit(self._solve_impl)
        return self._solve_warm_jit(data, warm_start)

    def step(self, state: IPMState, data: QPData) -> IPMState:
        """One jitted IPM iteration (for benchmarking / inspection)."""
        return self._step_jit(state, data)

    def solve_batch(self, data: QPData) -> SolveResult:
        """Solve a batch of QPs (leading batch axis on every leaf)."""
        self._ensure_nd_plan(data)
        if not hasattr(self, "_solve_batch_jit"):
            self._solve_batch_jit = jax.jit(jax.vmap(self._solve_impl))
        return self._solve_batch_jit(data)
