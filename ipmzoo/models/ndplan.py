"""Nested-dissection plan management for :class:`CompiledIPM`.

``NdPlanMixin`` holds the kernel='nd' plan lifecycle: deriving the
separator-tree plan from the data's sparsity at first contact, the
calibrated-cost-model auto-fallback that refuses plans predicted to
lose to the dense kernels, and the one-time diagonal-split validation.
Split out of models/ipm.py (round 5) purely for structure; behaviour is
unchanged and pinned by tests/test_ndiss.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .data import QPData


class NdPlanMixin:
    """Plan derivation + auto-fallback for the nested-dissection kernel."""

    def _maybe_nd_fallback(self) -> None:
        """Refuse a nested-dissection plan predicted to lose to dense.

        Auto-selection must never pick a losing nd plan:
        when the calibrated time model (ops/ndiss.py::
        nd_predicted_speedup — per-level latency + flop rate vs dense
        floor + cubic, fitted to the measured crossover table) predicts
        < 1.05x over the dense factorisation, switch to the kernel the
        dense auto rule would choose and record ``nd_fell_back``.  The
        margin is 5%: with the model calibrated in TIME the old 1.5x
        flop-model guard band silently discarded real wins just above
        the crossover."""
        from ..ops.ndiss import nd_predicted_speedup
        if not self._nd_fallback or self._nd_plan is None:
            return
        # below the model's calibration range (the crossover table
        # starts at n=256) the dense-floor extrapolation is
        # unreliable and the dense kernel is strictly simpler: prefer it
        if self._nd_plan.n >= 192 and \
                nd_predicted_speedup(self._nd_plan) >= 1.05:
            return
        self.nd_fell_back = True
        if self._can_block and self.n >= 384:
            self._mode = "block"
        elif self.aug_dim >= 384:
            self._mode = "blockg"
        else:
            self._mode = "ldlt"

    def _ensure_nd_plan(self, data: QPData) -> None:
        """Derive the nested-dissection plan from the data's sparsity
        (kernel='nd' with no explicit nd_pattern): assemble ONE KKT
        matrix eagerly at the initial iterate and dissect its nonzero
        pattern.  Barrier terms only touch diagonal blocks, so the
        pattern is iteration-invariant; the plan is cached and baked
        into the jitted solve as constants."""
        if self._mode != "nd":
            return
        if jnp.asarray(data.Q).ndim == 3:      # batched: structure from
            data = jax.tree_util.tree_map(lambda a: a[0], data)  # inst. 0
        if self._nd_plan is None:
            from ..ops.ndiss import nd_plan
            state = self.init_state(data)
            env = self._env(data, state.vars,
                            jnp.asarray(self.mu0, self.dtype))
            K = np.asarray(self._assemble_kkt(env))
            # structural signs let the amalgamated top factor as two
            # dense Cholesky stages (ops/ndiss.py::_signed_top_factor)
            self._nd_plan = nd_plan(K != 0, leaf=self._nd_leaf,
                                    signs=self._sign_vec)
            self._maybe_nd_fallback()
        if self._mode == "nd" and not hasattr(self, "_nd_diag_split"):
            self._check_nd_diag_split(data)

    def _check_nd_diag_split(self, data: QPData) -> None:
        """Validate (numerically, once, on the host) that IPM iterations
        only change the KKT's DIAGONAL for this formulation: assemble
        the reduction at two different variable/mu assignments and
        compare off-diagonals.  True across the standard lattice
        (barrier terms are diagonal); false e.g. for penalty handlings
        whose mu^-1 C^T C block is off-diagonal — those keep the full
        per-iteration permute path."""
        state = self.init_state(data)
        vars2 = tuple(jnp.abs(v) + 0.5 for v in state.vars)
        K1 = np.asarray(self._assemble_kkt(
            self._env(data, state.vars, 0.7)))
        K2 = np.asarray(self._assemble_kkt(self._env(data, vars2, 0.31)))
        off = ~np.eye(K1.shape[0], dtype=bool)
        self._nd_diag_split = bool(np.array_equal(K1[off], K2[off]))
