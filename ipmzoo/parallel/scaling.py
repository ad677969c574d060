"""Strong-scaling efficiency measurement for the dp (batched-QP) axis.

BASELINE.md sets a >=80% iterations/s scaling-efficiency target from one
chip to a pod slice.  The reference has no parallelism at all (SURVEY
§2.5), so the harness here is the measurement instrument, exercised on
the CPU virtual mesh in tests and ready to run unchanged the day a
multi-chip slice is attached: it times the same whole-batch stepping
workload on ONE device and dp-sharded over ALL devices and reports

    efficiency = t_1dev / (n_devices * t_ndev)

(strong scaling: fixed total batch).  All timings are two-point
slope-timed (:mod:`ipmzoo.utils.timing`) so dispatch/sync
constants cancel.

Note for virtual CPU meshes: the N "devices" share one physical CPU, so
the efficiency number there only validates the harness mechanics, not
hardware scaling.
"""

from __future__ import annotations

import dataclasses

import jax
from jax import lax

from ..utils.timing import measure_chain
from .mesh import batch_sharding, make_mesh


@dataclasses.dataclass
class ScalingReport:
    n_devices: int
    steps: int
    batch: int
    t_1dev: float           # seconds per `steps` whole-batch steps, 1 device
    t_ndev: float           # same workload dp-sharded over all devices
    iters_per_s_1dev: float
    iters_per_s_ndev: float
    speedup: float          # t_1dev / t_ndev
    efficiency: float       # speedup / n_devices  (1.0 = perfect)

    def summary(self) -> str:
        return (f"dp scaling: {self.batch} QPs x {self.steps} steps, "
                f"{self.n_devices} device(s): "
                f"{self.iters_per_s_1dev:.3g} it/s (1 dev) -> "
                f"{self.iters_per_s_ndev:.3g} it/s ({self.n_devices} dev), "
                f"speedup {self.speedup:.2f}x, "
                f"efficiency {100 * self.efficiency:.1f}%")


def _time_steps(solver, data, steps: int) -> float:
    stepv = jax.vmap(solver._step_impl)

    @jax.jit
    def k_steps(state):
        return lax.fori_loop(0, steps, lambda i, s: stepv(s, data), state)

    state = jax.jit(jax.vmap(solver.init_state))(data)
    return measure_chain(k_steps, state) * 1.0


def dp_scaling_report(solver, data, steps: int = 10,
                      devices=None) -> ScalingReport:
    """Measure strong-scaling efficiency of dp-sharded batched stepping.

    ``solver`` is a :class:`~ipmzoo.models.ipm.CompiledIPM`; ``data``
    a batched :class:`~ipmzoo.models.data.QPData`.  The whole batch
    is stepped ``steps`` times (a) resident on one device and (b)
    sharded over the full dp mesh; both runs execute the identical jitted
    program modulo sharding, so the ratio isolates the parallel speedup.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    batch = int(jax.tree_util.tree_leaves(data)[0].shape[0])

    # (a) single device: whole batch resident on devices[0]
    data_1 = jax.device_put(data, devices[0])
    t1 = _time_steps(solver, data_1, steps)

    # (b) dp-sharded over the full mesh
    if n_dev > 1:
        mesh = make_mesh(devices=devices)
        data_n = jax.device_put(data, batch_sharding(mesh))
        tn = _time_steps(solver, data_n, steps)
    else:
        tn = t1

    speedup = t1 / tn
    return ScalingReport(
        n_devices=n_dev, steps=steps, batch=batch, t_1dev=t1, t_ndev=tn,
        iters_per_s_1dev=batch * steps / t1,
        iters_per_s_ndev=batch * steps / tn,
        speedup=speedup, efficiency=speedup / n_dev)
