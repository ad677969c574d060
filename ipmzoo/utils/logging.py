"""Structured solve logging and iteration tracing.

The reference prints ``iter: k, f: ..., res: ..., gap: ...`` per iteration
from inside its host loop (Optimizer.cpp:131-132).  Our iteration runs
on-device inside a ``lax.while_loop`` with no host round-trips, so the
equivalent observability surface is:

* :func:`solve_summary` — one structured record per solve (iterations,
  residual, gap, objective, convergence) from the returned result.
* :class:`IterationTrace` — an opt-in traced-solve helper that runs the
  jitted ``step`` function iteration by iteration from the host (each
  step is still a single compiled XLA program), recording the per-
  iteration metrics exactly like the reference log line.  Use for
  debugging, not for production throughput.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import List, Optional

logger = logging.getLogger("ipmzoo")


def solve_summary(result, log=True) -> dict:
    rec = {
        "iterations": int(result.iterations),
        "residual": float(result.residual),
        "gap": float(result.gap),
        "objective": float(result.objective),
        "converged": bool(result.converged),
    }
    if log:
        logger.info("solve: %s", json.dumps(rec))
    return rec


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    objective: float
    residual: float
    gap: float
    mu: float


class IterationTrace:
    """Run a CompiledIPM solve step-by-step, recording metrics.

    >>> trace = IterationTrace(solver)
    >>> records = trace.run(data)
    """

    def __init__(self, solver, max_iter: Optional[int] = None):
        self.solver = solver
        self.max_iter = max_iter or solver.max_iter

    def run(self, data) -> List[IterationRecord]:
        import jax.numpy as jnp
        from ..models import codegen as cg
        solver = self.solver
        state = solver.init_state(data)
        records: List[IterationRecord] = []

        def record(state):
            env = solver._env(data, state.vars, state.mu)
            f = float(cg.evaluate(solver.objective_expr, env).val)
            rec = IterationRecord(
                iteration=int(state.iteration), objective=f,
                residual=float(state.residual), gap=float(state.gap),
                mu=float(state.mu))
            records.append(rec)
            logger.info("iter: %d, f: %e, res: %e, gap: %e", rec.iteration,
                        rec.objective, rec.residual, rec.gap)
            return rec

        rec = record(state)
        while (rec.iteration < self.max_iter and
               not (rec.residual < solver.tol and rec.gap < solver.tol)):
            state = solver.step(state, data)
            rec = record(state)
        return records
