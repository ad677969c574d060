"""Linear-solver kernel dispatch for :class:`CompiledIPM`.

``KernelDispatchMixin`` holds the per-iteration factor-and-solve staging:
KKT assembly from the symbolic reduction (dense, block, or two-float
pair), the kernel-mode dispatch (``_make_solve`` — LDL^T / blocked
Cholesky / signed block-Cholesky / regularised LDL^T / LU / sharded /
nested-dissection / two-float), and the dense-matrix-inverse binding the
normal-equations reduction needs.  Split out of models/ipm.py (round 4)
purely for structure; behaviour is unchanged and pinned by the golden +
oracle tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.ldlt import solve_ldlt
from ..symbolic import expr as E
from . import codegen as cg


class KernelDispatchMixin:
    """Factor/solve staging shared by every CompiledIPM kernel mode."""

    def _collect_matrix_inverts(self):
        """All distinct Invert subexpressions over dense-matrix operands
        in the condensed system (lhs cells, rhs, delta definitions).

        Eliminating the leading Q/x block introduces H^{-1} with
        H = aug.lhs[0][0] (a Sum containing the symmetric matrix Q);
        elementwise inversion is unsound for those, so the solver binds a
        factored inverse per iteration instead."""
        K = E.Kind
        seen, out = set(), []
        hm_memo = {}

        def has_matrix(e):
            # memoised: the expression DAG is hash-consed with heavy
            # sharing, so unmemoised recursion is exponential
            hit = hm_memo.get(e)
            if hit is not None:
                return hit
            r = (e.kind in (K.MATRIX, K.SYMMETRIC_MATRIX) or
                 any(has_matrix(c) for c in e.children))
            hm_memo[e] = r
            return r

        def walk(e):
            if e in seen:
                return
            seen.add(e)
            if E.is_invert(e) and has_matrix(e.child):
                out.append(e)
            for c in e.children:
                walk(c)

        for row in self.red.lhs:
            for cell in row:
                walk(cell)
        for r in self.red.rhs:
            walk(r)
        for _, d in self.red.delta_definitions:
            walk(d)
        return out

    def _bind_matrix_inverts(self, env: cg.Env) -> None:
        """Evaluate each dense-matrix inverse once (LDL^T with the pivot
        floor + solve against I) and bind it into ``env`` IN PLACE, so
        every later evaluation of the condensed system short-circuits on
        the env hit.  The explicit inverse turns all downstream condensed
        algebra (A H^{-1} A^T, H^{-1} r) into plain matmuls — the
        matmul-friendly staging of the classical normal-equations recipe."""
        from ..ops.blocked_ldlt import ldlt_blocked
        for ie in self._matrix_inverts:
            if ie in env:
                continue
            child = cg.evaluate(ie.child, env, {})
            if child.tag != "matrix":
                env[ie] = cg.invert_tv(child)
                continue
            H = child.val
            L, D = ldlt_blocked(H, self.pivot_floor)
            eye = jnp.eye(H.shape[0], dtype=H.dtype)
            env[ie] = cg.matrix(solve_ldlt(L, D, eye))


    def _assemble_blocks(self, env):
        """Evaluate each cell of the consumed reduction (augmented system,
        or the condensed normal equations for kernel='normal') as a dense
        block."""
        memo = {}
        blocks = []
        for i, vi in enumerate(self.red.variables):
            si = self.red_sizes[i]
            row_blocks = []
            for j, vj in enumerate(self.red.variables):
                sj = self.red_sizes[j]
                cell = self.red.lhs[i][j]
                if cell is E.ZERO:
                    row_blocks.append(jnp.zeros((si, sj), self.dtype))
                else:
                    row_blocks.append(
                        cg.as_block(cg.evaluate(cell, env, memo), si, sj))
            blocks.append(row_blocks)
        return blocks

    def _assemble_kkt(self, env):
        blocks = self._assemble_blocks(env)
        rows = [jnp.concatenate(rb, axis=1) if len(rb) > 1 else rb[0]
                for rb in blocks]
        return jnp.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]

    def _assemble_kkt_df(self, env):
        """Two-float assembly of the consumed reduction: every cell is
        evaluated as an (hi, lo) pair (codegen_df) so barrier diagonals
        like lambda/s carry pair-relative accuracy into the
        factorisation."""
        from . import codegen_df as cgdf
        memo = {}
        rows_h, rows_l = [], []
        for i, vi in enumerate(self.red.variables):
            si = self.red_sizes[i]
            rbh, rbl = [], []
            for j, vj in enumerate(self.red.variables):
                sj = self.red_sizes[j]
                cell = self.red.lhs[i][j]
                if cell is E.ZERO:
                    z = jnp.zeros((si, sj), self.dtype)
                    rbh.append(z)
                    rbl.append(z)
                else:
                    bh, bl = cgdf.as_block(
                        cgdf.evaluate(cell, env, memo), si, sj)
                    rbh.append(bh)
                    rbl.append(bl)
            rows_h.append(jnp.concatenate(rbh, axis=1)
                          if len(rbh) > 1 else rbh[0])
            rows_l.append(jnp.concatenate(rbl, axis=1)
                          if len(rbl) > 1 else rbl[0])
        Kh = jnp.concatenate(rows_h, axis=0) if len(rows_h) > 1 \
            else rows_h[0]
        Kl = jnp.concatenate(rows_l, axis=0) if len(rows_l) > 1 \
            else rows_l[0]
        return Kh, Kl

    def _residual_fn(self, K):
        """b - K sol for refinement: plain, or two-float compensated."""
        if self.hybrid_refine:
            from ..ops.twofloat import comp_residual
            return lambda b, sol: comp_residual(b, K, sol)
        return lambda b, sol: b - K @ sol

    def _make_solve(self, env, nd_pre=None):
        """Factor the augmented KKT once; return solve(b) -> sol with
        optional iterative refinement baked in.  ``nd_pre``: loop-
        invariant slab prework for the nd diagonal-split path
        (ipm.py::_nd_prework), computed outside the solver loop."""
        if self._mode == "tf":
            # double-single assembly + factorisation; solve consumes and
            # returns (hi, lo) PAIRS.  Indefinite systems get the signed
            # proximal regularisation of 'regldlt' (the pair analogue:
            # delta ~ eps_pair^(2/3)) with pair refinement against the
            # true K removing the perturbation.
            from ..ops.ldlt_df import ldlt_df, solve_ldlt_df
            from ..ops.twofloat import df_add, df_matvec, df_neg
            Kh, Kl = self._assemble_kkt_df(env)
            if self._indefinite:
                eps_pair = 2.0 ** -48
                scale = jnp.maximum(
                    jnp.asarray(1.0, self.dtype),
                    jnp.max(jnp.abs(jnp.diagonal(Kh))))
                delta = jnp.asarray(eps_pair ** (2.0 / 3.0),
                                    self.dtype) * scale
                signs = jnp.asarray(self._sign_vec, self.dtype)
                pert = jnp.diag(delta * signs)
                Frh, Frl = df_add((Kh, Kl), (pert, jnp.zeros_like(pert)))
                nref = max(self.refine, 3)
            else:
                Frh, Frl = Kh, Kl
                nref = self.refine
            Lh, Ll, Dh, Dl = ldlt_df(Frh, Frl, self.pivot_floor)

            def solve(b):
                bh, bl = b
                if bh.shape[0] == 0:
                    return b
                sol = solve_ldlt_df(Lh, Ll, Dh, Dl, bh, bl)
                for _ in range(nref):
                    r = df_add((bh, bl),
                               df_neg(df_matvec((Kh, Kl), sol)))
                    c = solve_ldlt_df(Lh, Ll, Dh, Dl, r[0], r[1])
                    sol = df_add(sol, c)
                return sol

            return solve

        if self._mode == "sharded":
            from ..ops.sharded_ldlt import sharded_ldlt, sharded_ldlt_solve
            K = self._assemble_kkt(env)
            dim, pdim = self.red_dim, self._sharded_dim
            if pdim != dim:
                Kp = jnp.eye(pdim, dtype=self.dtype).at[:dim, :dim].set(K)
            else:
                Kp = K
            factors = sharded_ldlt(Kp, self._mesh, axis=self._mesh_axis,
                                   panel=self._sharded_panel,
                                   pivot_floor=self.pivot_floor)
            resid = self._residual_fn(K)

            def _one(r):
                rp = (jnp.zeros((pdim,), self.dtype).at[:dim].set(r)
                      if pdim != dim else r)
                sol = sharded_ldlt_solve(factors, rp, self._mesh,
                                         axis=self._mesh_axis,
                                         panel=self._sharded_panel)
                return sol[:dim]

            def solve(b):
                if b.shape[0] == 0:
                    return b
                sol = _one(b)
                for _ in range(self.refine):
                    sol = sol + _one(resid(b, sol))
                return sol

            return solve

        if self._mode == "lu":
            from jax.scipy.linalg import lu_factor, lu_solve
            K = self._assemble_kkt(env)
            factors = lu_factor(K)
            resid = self._residual_fn(K)

            def solve(b):
                if b.shape[0] == 0:
                    return b
                sol = lu_solve(factors, b)
                for _ in range(self.refine):
                    sol = sol + lu_solve(factors, resid(b, sol))
                return sol

            return solve

        if self._mode == "regldlt":
            # signed proximal regularisation K + delta * diag(signs):
            # the perturbed system is quasi-definite (Vanderbei 1995), so
            # the unpivoted batched LDL^T kernels are sound; refinement
            # against the TRUE K removes the O(delta) perturbation.  The
            # contraction factor per sweep is ~delta*||K^{-1}||*scale, so
            # eps^{2/3} reaches the dtype floor in <= 3 sweeps for
            # moderately conditioned systems.
            K = self._assemble_kkt(env)
            eps = float(jnp.finfo(self.dtype).eps)
            scale = jnp.maximum(jnp.asarray(1.0, self.dtype),
                                jnp.max(jnp.abs(jnp.diagonal(K))))
            delta = jnp.asarray(eps ** (2.0 / 3.0), self.dtype) * scale
            signs = jnp.asarray(self._sign_vec, self.dtype)
            Kr = K + jnp.diag(delta * signs)
            L, D = self._factor(Kr)
            resid = self._residual_fn(K)
            nref = max(self.refine, 3)

            def solve(b):
                if b.shape[0] == 0:
                    return b
                sol = self._solve_kernel(L, D, b)
                for _ in range(nref):
                    sol = sol + self._solve_kernel(L, D, resid(b, sol))
                return sol

            return solve

        if self._mode == "blockg":
            from ..ops.blockg import (blockg_factor, blockg_matvec,
                                      blockg_solve)
            blocks = self._assemble_blocks(env)
            factors = blockg_factor(blocks, self.group_signs)
            offs = []
            off = 0
            for s in self.aug_sizes:
                offs.append(off)
                off += s

            if self.hybrid_refine and self.refine:
                resid = self._residual_fn(self._assemble_kkt(env))
            else:
                def resid(b, sol):
                    parts = [sol[o:o + s]
                             for o, s in zip(offs, self.aug_sizes)]
                    return b - jnp.concatenate(
                        blockg_matvec(blocks, parts))

            def solve(b):
                if b.shape[0] == 0:
                    return b
                sol = blockg_solve(factors, b)
                for _ in range(self.refine):
                    sol = sol + blockg_solve(factors, resid(b, sol))
                return sol

            return solve

        if self._mode == "block":
            from ..ops.block_solve import (block2_factor,
                                           block2_factor_inv,
                                           block2_matvec, block2_solve,
                                           block2_solve_inv)
            blocks = self._assemble_blocks(env)
            H, BT = blocks[0][0], blocks[0][1]
            B, negC = blocks[1][0], blocks[1][1]
            C = -negC
            if self._block_inv:
                # explicit H^{-1}/S^{-1}: one n-rhs solve pair up front
                # (matmul throughput) so the 4+ direction solves per
                # iteration become matvecs instead of latency-bound
                # 1-rhs TriangularSolves
                factors = block2_factor_inv(H, B, C)
                block2_solve = block2_solve_inv
            else:
                factors = block2_factor(H, B, C)
            n1 = self.aug_sizes[0]
            if self.hybrid_refine and self.refine:
                resid = self._residual_fn(self._assemble_kkt(env))
            else:
                def resid(b, sol):
                    e1, e2 = block2_matvec(H, B, C, sol[:n1], sol[n1:])
                    return b - jnp.concatenate([e1, e2])

            def solve(b):
                dx, dy = block2_solve(factors, b[:n1], b[n1:])
                sol = jnp.concatenate([dx, dy])
                for _ in range(self.refine):
                    r = resid(b, sol)
                    cx, cy = block2_solve(factors, r[:n1], r[n1:])
                    sol = sol + jnp.concatenate([cx, cy])
                return sol

            return solve

        if self._mode == "nd":
            from ..ops.ndiss import nd_factor, nd_solve
            if self._nd_plan is None:
                raise RuntimeError(
                    "kernel='nd' has no dissection plan; pass nd_pattern= "
                    "to the constructor or call solve()/solve_batch() "
                    "(which derive it from the data) before step()")
            plan = self._nd_plan
            if nd_pre is not None:
                # IPM iterations only change the KKT's DIAGONAL (barrier
                # terms; validated numerically at plan time, ipm.py::
                # _check_nd_diag_split).  The loop-invariant slabs were
                # extracted OUTSIDE the solver loop (_nd_prework); the
                # in-loop factorisation consumes them plus the
                # per-iteration barrier diagonal only.
                from ..ops.ndiss import nd_factor_pre
                pre, diag_ref = nd_pre
                w = self._assemble_diag(env) - diag_ref
                factors = nd_factor_pre(pre, plan, diag_delta=w,
                                        pivot_floor=self.pivot_floor)
                if self.refine:
                    K = self._assemble_kkt(env)
                    resid = self._residual_fn(K)
            else:
                K = self._assemble_kkt(env)
                factors = nd_factor(K, plan, self.pivot_floor)
                resid = self._residual_fn(K)

            def solve(b):
                if b.shape[0] == 0:
                    return b
                sol = nd_solve(plan, factors, b)
                for _ in range(self.refine):
                    sol = sol + nd_solve(plan, factors, resid(b, sol))
                return sol

            return solve

        if self._mode == "normal":
            # bind H^{-1} first (mutates env: the residual/corrector envs
            # derive from this env by dict copy, so the binding propagates
            # to every rhs / delta-definition evaluation this iteration)
            self._bind_matrix_inverts(env)
            return self._make_solve_dense(env)

        return self._make_solve_dense(env)

    def _nd_ref_env(self, env):
        """Reference environment for the nd diagonal split: variables
        bound to the same data-derived strictly-interior point
        init_state uses (bound midpoints for x/s — ones would sit ON a
        bound whenever a bound equals 1, blowing the barrier inverses),
        mu to a constant.  Everything depends only on the data, so the
        KKT assembled against it is loop-invariant."""
        o = self.symbols
        renv = dict(env)
        mids = {}
        if o.x in self.var_index:
            mids[o.x] = 0.5 * (env[o.l_x].val + env[o.u_x].val)
        if o.s_A_ineq in self.var_index:
            mids[o.s_A_ineq] = 0.5 * (env[o.l_A_ineq].val +
                                      env[o.u_A_ineq].val)
        for var, sz in zip(self.full.variables, self.var_sizes):
            renv[var] = cg.vector(mids.get(
                var, jnp.ones((sz,), self.dtype)))
        renv[self.symbols.mu] = cg.scalar(
            jnp.asarray(1.0, self.dtype))
        return renv

    def _assemble_diag(self, env):
        """Concatenated diagonal of the consumed reduction's diagonal
        cells (the only cells an IPM iteration changes when the nd
        diagonal split is valid)."""
        memo = {}
        parts = []
        for i, vi in enumerate(self.red.variables):
            si = self.red_sizes[i]
            cell = self.red.lhs[i][i]
            if cell is E.ZERO:
                parts.append(jnp.zeros((si,), self.dtype))
            else:
                parts.append(jnp.diagonal(cg.as_block(
                    cg.evaluate(cell, env, memo), si, si)))
        return (jnp.concatenate(parts) if parts
                else jnp.zeros((0,), self.dtype))

    def _make_solve_dense(self, env):
        """Dense LDL^T factor+solve of the assembled reduction (the
        default path; also consumes the bound H^{-1} of mode='normal')."""
        K = self._assemble_kkt(env)
        L, D = self._factor(K)
        resid = self._residual_fn(K)

        def solve(b):
            if b.shape[0] == 0:
                return b
            sol = self._solve_kernel(L, D, b)
            for _ in range(self.refine):
                sol = sol + self._solve_kernel(L, D, resid(b, sol))
            return sol

        return solve
