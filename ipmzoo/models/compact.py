"""Compaction-scheduled batched solving for :class:`CompiledIPM`.

``CompactScheduleMixin`` holds the straggler-free batched engines: the
masked fixed-step / early-exit iteration loops (freeze-on-convergence,
NaN rollback) and the staged gather-compact-resume schedule of
``solve_batch_compact``.  Split out of models/ipm.py (round 4) purely
for structure; behaviour is unchanged and pinned by tests/test_compact.py.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from . import codegen as cg
from .data import QPData
from .state import IPMState, SolveResult


class CompactScheduleMixin:
    """Masked iteration loops + the gather/compact/resume schedule."""

    def _masked_steps(self, state, data, diverged, res_tol, k: int,
                      gondzio: Optional[int] = None):
        """Run ``k`` vmapped iterations; converged/diverged instances are
        frozen (their state re-enters unchanged) and a step that goes
        NaN/inf rolls back to the last good iterate, as in
        :meth:`_solve_impl`."""
        stepv = jax.vmap(
            functools.partial(self._step_impl, gondzio=gondzio))

        def mask_like(m, leaf):
            return m.reshape(m.shape + (1,) * (leaf.ndim - 1))

        def body(_, carry):
            st, div = carry
            done = (st.residual < res_tol) & (st.gap < self.tol)
            frozen = done | div
            new = stepv(st, data)
            bad = (jnp.isnan(new.residual) | jnp.isinf(new.residual) |
                   jnp.isnan(new.gap) | jnp.isinf(new.gap))
            keep = frozen | bad
            merged = jax.tree_util.tree_map(
                lambda o, n_: jnp.where(mask_like(keep, n_), o, n_),
                st, new)
            return merged, div | (bad & ~frozen)

        return jax.lax.fori_loop(0, k, body, (state, diverged))

    def _masked_while(self, state, data, frozen0, res_tol, max_steps: int,
                      gondzio: Optional[int] = None):
        """Early-exit variant of :meth:`_masked_steps`: iterates until
        every instance is frozen (converged, diverged, or externally
        frozen via ``frozen0``) or ``max_steps`` is reached.  Same
        freeze/NaN-rollback semantics."""
        stepv = jax.vmap(
            functools.partial(self._step_impl, gondzio=gondzio))

        def mask_like(m, leaf):
            return m.reshape(m.shape + (1,) * (leaf.ndim - 1))

        def done(st):
            return (st.residual < res_tol) & (st.gap < self.tol)

        def cond(carry):
            st, div, it = carry
            frozen = frozen0 | done(st) | div
            return jnp.logical_and(it < max_steps, ~jnp.all(frozen))

        def body(carry):
            st, div, it = carry
            frozen = frozen0 | done(st) | div
            new = stepv(st, data)
            bad = (jnp.isnan(new.residual) | jnp.isinf(new.residual) |
                   jnp.isnan(new.gap) | jnp.isinf(new.gap))
            keep = frozen | bad
            merged = jax.tree_util.tree_map(
                lambda o, n_: jnp.where(mask_like(keep, n_), o, n_),
                st, new)
            return merged, div | (bad & ~frozen), it + 1

        state, diverged, _ = jax.lax.while_loop(
            cond, body,
            (state, jnp.zeros(res_tol.shape, bool),
             jnp.asarray(0, jnp.int32)))
        return state, diverged

    def _escalation_twin(self):
        """Two-float twin of this solver for the escalation stage.

        Instances at the f32 representation floor
        (residual just above tol that NO f32 iterate can express) are
        finished in double-single pairs."""
        if self.two_float:
            return self
        esc = getattr(self, "_esc_twin", None)
        if esc is None:
            from .ipm import CompiledIPM
            esc = CompiledIPM(
                self.settings, self.n, self.m_ineq, self.m_eq,
                names=self.names, dtype=self.dtype, tol=self.tol,
                max_iter=self.max_iter, mu0=self.mu0, delta0=self.delta0,
                pivot_floor=self.pivot_floor,
                fraction_to_boundary=self.fraction_to_boundary,
                mu_floor=self.mu_floor, scale_tol=self.scale_tol,
                gondzio=self.gondzio, two_float=True)
            self._esc_twin = esc
        return esc

    def _escalate_batch(self, data: QPData, state, res_tol, diverged,
                        esc_cap: int, esc_iters: int, gondzio: int):
        """Warm two-float refinement of the residual-floor stragglers.

        Gathers the unconverged instances, promotes their f32 iterates
        to (hi, lo=0) pairs — they are already essentially optimal, so
        warm pair refinement converges in a couple of iterations — and
        merges back rounded iterates with the pair-accurate metrics.
        Runs inside the same jit as the compact stages."""
        B = data.Q.shape[0]
        cap = min(esc_cap, B)
        esc = self._escalation_twin()
        done = (state.residual < res_tol) & (state.gap < self.tol)
        take = jnp.argsort(done)[:cap]
        e_data = jax.tree_util.tree_map(lambda a: a[take], data)
        e_was = done[take]
        vals = tuple(jnp.stack([v[take], jnp.zeros_like(v[take])], axis=1)
                     for v in state.vars)

        def metrics_one(d, vs):
            return esc._metrics(esc._envm(d, vs, 0.0))

        residual, gap = jax.vmap(metrics_one)(e_data, vals)
        e_state = IPMState(
            vars=vals,
            mu=jnp.maximum(state.mu[take],
                           jnp.asarray(esc.mu_floor, self.dtype)),
            iteration=jnp.zeros((cap,), jnp.int32),
            residual=residual, gap=gap)
        e_tol = res_tol[take]
        e_state, e_div = esc._masked_while(e_state, e_data, e_was, e_tol,
                                           esc_iters, gondzio=gondzio)
        e_conv = ((e_state.residual < e_tol) & (e_state.gap < self.tol)
                  & ~e_div)
        use = (~e_was) & e_conv

        def put(dst, src):
            upd = jnp.where(use.reshape((-1,) + (1,) * (src.ndim - 1)),
                            src, dst[take])
            return dst.at[take].set(upd)

        new_vars = tuple(put(v, ev[:, 0] + ev[:, 1])
                         for v, ev in zip(state.vars, e_state.vars))
        state = IPMState(
            vars=new_vars,
            mu=put(state.mu, e_state.mu),
            iteration=put(state.iteration,
                          state.iteration[take] + e_state.iteration),
            residual=put(state.residual, e_state.residual),
            gap=put(state.gap, e_state.gap))
        return state, diverged

    def _compact_impl(self, data: QPData, schedule, tail_gondzio,
                      tail_restart, esc_cap: int = 0,
                      esc_iters: int = 40):
        """Whole-batch solve with device-side compaction between stages.

        A vmapped ``while_loop`` makes every instance pay for the
        slowest one: a single straggler keeps all ``B`` lanes stepping
        (frozen lanes still execute) to ``max_iter``.  Instead, run a
        fixed number of masked steps on the full batch, then argsort the
        done-mask (actives first), gather the leading ``B // divisor``
        slots — a static shape — and continue on that sub-batch only,
        scattering results back.  Typical workloads converge >99% of
        instances in the first stage, so the tail costs ~1/divisor of a
        full-batch step.  Instances that exceed a stage's capacity stay
        where they are and simply report unconverged — no wrong answers,
        and the convergence rate surfaces the event.

        Tail stages RESTART still-active instances from the initial
        iterate and run with ``tail_gondzio`` Gondzio centrality-
        corrector rounds: plain Mehrotra CYCLES on a small fraction of
        instances (observed: residual oscillation on a well-conditioned
        box QP, in f64 too — an algorithmic failure mode, not a
        precision one).  The cycle is an attractor — switching on
        Gondzio mid-cycle stays trapped — but Gondzio from a cold start
        converges in ~11 iterations on the same instance, so the tail
        re-initialises.  Cumulative per-instance iteration counts are
        preserved for honest throughput accounting.  Running Gondzio
        only on the compacted tail keeps the full-batch stage at
        plain-Mehrotra cost."""
        B = data.Q.shape[0]
        state = jax.vmap(self.init_state)(data)
        dt = self.dtype
        if self.scale_tol:
            res_tol = self.tol * (1.0 + state.residual)
        else:
            res_tol = jnp.full((B,), self.tol, dt)
        diverged = jnp.zeros((B,), bool)

        (k0, div0), *rest = schedule
        assert div0 == 1, "first stage must cover the full batch"
        state, diverged = self._masked_steps(state, data, diverged,
                                             res_tol, k0)

        for (k, divisor) in rest:
            cap = max(B // divisor, 1)
            done = (state.residual < res_tol) & (state.gap < self.tol)
            frozen = done | diverged
            # gather priority: actives first, then diverged (which get
            # their Gondzio second chance), converged last as padding
            priority = 2 * done.astype(jnp.int32) + \
                (diverged & ~done).astype(jnp.int32)
            take = jnp.argsort(priority)[:cap]
            sub = jax.tree_util.tree_map(lambda a: a[take],
                                         (state, data, diverged, res_tol))
            s_state, s_data, s_div, s_tol = sub
            # restart unconverged instances (active OR diverged — the
            # latter get a second chance under Gondzio) from the initial
            # iterate (a Mehrotra cycle is an attractor; see docstring),
            # keeping their cumulative iteration count; converged slots
            # gathered as padding keep their state
            if tail_restart:
                s_done = ((s_state.residual < s_tol) &
                          (s_state.gap < self.tol))
                fresh = jax.vmap(self.init_state)(s_data)
                fresh = IPMState(vars=fresh.vars, mu=fresh.mu,
                                 iteration=s_state.iteration,
                                 residual=fresh.residual, gap=fresh.gap)
                s_state = jax.tree_util.tree_map(
                    lambda o, n_: jnp.where(
                        s_done.reshape(s_done.shape +
                                       (1,) * (n_.ndim - 1)), o, n_),
                    s_state, fresh)
                s_div = jnp.where(s_done, s_div, False)
            s_state, s_div = self._masked_steps(s_state, s_data, s_div,
                                                s_tol, k,
                                                gondzio=tail_gondzio)
            state = jax.tree_util.tree_map(
                lambda f, s: f.at[take].set(s), state, s_state)
            diverged = diverged.at[take].set(s_div)

        # escalation BEFORE the mop-up: instances at the f32
        # representation floor can NEVER satisfy the while-loop's
        # convergence test in working precision, so running the
        # full-batch mop-up first makes two floor-stuck lanes burn its
        # entire (max_iter - k0)-step budget at full batch width.
        # Finish them in two-float pairs first (warm — they are already
        # near-optimal); the mop-up then only spins on genuine
        # capacity-overflow actives.
        if esc_cap:
            state, diverged = self._escalate_batch(
                data, state, res_tol, diverged, esc_cap, esc_iters,
                tail_gondzio)

        # Full-batch mop-up: a stage whose active count exceeds its
        # 1/divisor capacity silently leaves instances unconverged (the
        # gather drops them on the floor) — observed at tol 1e-6 with
        # the old (12, 8) stage-2 schedule, where stage 1 converged ~6%
        # fewer instances than at 1e-5 and the 1/8 cap overflowed.  The
        # early-exit masked while costs one cond evaluation when
        # everything already converged, and full-batch steps only for
        # as long as any instance is active, so the compact engine is
        # never worse-converging than solve_batch.  Budget: an instance
        # dropped after stage 1 is still owed max_iter - k0 iterations;
        # per-instance totals can therefore exceed max_iter, like the
        # restart tails' cumulative counts.  Gondzio rounds ride along
        # (free when no lane is active) so a capacity-dropped cycler at
        # least gets the corrector, though without the cold restart the
        # tails provide.
        done = (state.residual < res_tol) & (state.gap < self.tol)
        state, mop_div = self._masked_while(
            state, data, done | diverged, res_tol,
            max(self.max_iter - schedule[0][0], 0), gondzio=tail_gondzio)
        diverged = diverged | mop_div

        def finish(st, d, rtol, div):
            env = self._env(d, st.vars, st.mu)
            f = self._cgm.evaluate(self.objective_expr, env).val \
                if self.two_float else cg.evaluate(self.objective_expr,
                                                   env).val
            return SolveResult(
                x=self._var_val(st.vars[self.var_index[self.symbols.x]]),
                variables={v.name: self._var_val(val) for v, val in
                           zip(self.full.variables, st.vars)},
                objective=f,
                iterations=st.iteration,
                residual=st.residual,
                gap=st.gap,
                converged=(st.residual < rtol) & (st.gap < self.tol),
                diverged=div)

        return jax.vmap(finish)(state, data, res_tol, diverged)

    def solve_batch_compact(self, data: QPData, schedule=None,
                            tail_gondzio: int = 2,
                            tail_restart: bool = True,
                            esc_cap="auto",
                            esc_iters: int = 40) -> SolveResult:
        """Straggler-free batched solve (see :meth:`_compact_impl`).

        ``schedule``: list of ``(steps, batch_divisor)`` stages; the
        first divisor must be 1.  The default spends 12 iterations on
        the full batch, 12 more on the slowest eighth, and the remaining
        iteration budget on the slowest 1/64th.  ``tail_gondzio``:
        Gondzio corrector rounds for the tail stages (anti-cycling).
        ``esc_cap``: capacity of the final two-float escalation stage
        for f32-representation-floor stragglers ('auto' = 32 when the
        working dtype's own floor can sit above the tolerance, i.e. f32
        at tight tolerances; 0 otherwise)."""
        self._ensure_nd_plan(data)
        if esc_cap == "auto":
            eps = float(jnp.finfo(self.dtype).eps)
            # the f32 iterate-representation floor is ~eps * ||residual
            # scale||; escalation only helps when tol is near/below it
            esc_cap = 32 if (not self.two_float and
                             self.tol <= eps * 20) else 0
        B = data.Q.shape[0]
        if schedule is None:
            if B < 64:
                schedule = [(self.max_iter, 1)]
            elif self.tol >= 1e-5:
                # stage 1 must converge >87.5% of the batch or the 1/8
                # stage-2 cap overflows into the (full-batch-cost)
                # mop-up: measured p87.5 on the bench workload is 8
                # iterations at tol 1e-5
                k0 = min(self.max_iter, 12)
                k1 = min(max(self.max_iter - k0, 0), 12)
                k2 = max(self.max_iter - k0 - k1, 0)
                schedule = [(k0, 1)]
                if k1:
                    schedule.append((k1, 8))
                if k2:
                    schedule.append((k2, 64))
            else:
                # tighter tolerances converge later and wider: at 1e-6
                # the old (14,1)(12,8)(...,64) schedule left ~450 active
                # after stage 2 against a 1/64 cap of 160, and the ~300
                # overflow lanes fell through to the full-batch mop-up.
                # Wider tail stages hold the whole distribution:
                # (16,1)(16,4)(rest,32) leaves 443 -> 95 -> 2 active
                # after the stages at the same 100% convergence, no
                # overflow.
                k0 = min(self.max_iter, 16)
                k1 = min(max(self.max_iter - k0, 0), 16)
                k2 = max(self.max_iter - k0 - k1, 0)
                schedule = [(k0, 1)]
                if k1:
                    schedule.append((k1, 4))
                if k2:
                    schedule.append((k2, 32))
        key = (B, tuple(schedule), tail_gondzio, tail_restart, esc_cap,
               esc_iters)
        cache = getattr(self, "_compact_cache", None)
        if cache is None:
            cache = self._compact_cache = {}
        if key not in cache:
            cache[key] = jax.jit(
                functools.partial(self._compact_impl,
                                  schedule=tuple(schedule),
                                  tail_gondzio=tail_gondzio,
                                  tail_restart=tail_restart,
                                  esc_cap=esc_cap, esc_iters=esc_iters))
        return cache[key](data)

