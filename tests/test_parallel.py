"""Data-parallel batched solving over the virtual device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ipmzoo.formulations import Bounds, InequalityHandling, Settings
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.parallel.mesh import batch_sharding, make_mesh, replicated


def random_batch(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
    return QPData(
        Q=jnp.asarray(Q), c=jnp.asarray(rng.normal(size=(batch, n))),
        A_ineq=jnp.zeros((batch, 0, n)), l_A_ineq=jnp.zeros((batch, 0)),
        u_A_ineq=jnp.zeros((batch, 0)), A_eq=jnp.zeros((batch, 0, n)),
        b_eq=jnp.zeros((batch, 0)),
        l_x=jnp.asarray(-np.abs(rng.normal(size=(batch, n))) - 1),
        u_x=jnp.asarray(np.abs(rng.normal(size=(batch, n))) + 1))


def test_mesh_helpers():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    s = batch_sharding(mesh)
    assert s.spec == P("dp")
    assert replicated(mesh).spec == P()


def test_sharded_batch_solve_matches_unsharded():
    n = 6
    batch = 16
    data = random_batch(batch, n, seed=1)
    solver = CompiledIPM(Settings(inequalities=Bounds.NONE), n=n)

    res_plain = solver.solve_batch(data)

    mesh = make_mesh()
    shard = batch_sharding(mesh)
    data_sharded = jax.device_put(data, shard)
    res_sharded = jax.jit(jax.vmap(solver._solve_impl))(data_sharded)

    assert bool(jnp.all(res_plain.converged))
    assert bool(jnp.all(res_sharded.converged))
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_plain.x), rtol=1e-10,
                               atol=1e-10)
    # outputs stay sharded over the mesh
    assert res_sharded.x.sharding.is_equivalent_to(shard, res_sharded.x.ndim) \
        or res_sharded.x.sharding.num_devices == 8


def test_dp_scaling_report_cpu_mesh(capsys):
    """Scaling-efficiency harness (BASELINE.md >=80% target): sharded and
    single-device runs of the same batch produce identical numerics, and
    the report carries a well-formed efficiency figure.  On the virtual
    CPU mesh the efficiency *value* is not meaningful (8 'devices' share
    one CPU) — the assert is on mechanics, not the threshold."""
    from ipmzoo.parallel.scaling import dp_scaling_report

    n, batch = 6, 16
    data = random_batch(batch, n, seed=2)
    solver = CompiledIPM(Settings(inequalities=Bounds.NONE), n=n)

    report = dp_scaling_report(solver, data, steps=5)
    assert report.n_devices == 8
    assert report.batch == batch and report.steps == 5
    assert report.t_1dev > 0 and report.t_ndev > 0
    assert report.speedup == pytest.approx(report.t_1dev / report.t_ndev)
    assert report.efficiency == pytest.approx(report.speedup / 8)
    summary = report.summary()
    assert "efficiency" in summary and "8 dev" in summary
    print(summary)

    # numerics: K sharded steps == K single-device steps, bitwise-ish
    mesh = make_mesh()
    stepv = jax.jit(jax.vmap(solver._step_impl))
    state0 = jax.jit(jax.vmap(solver.init_state))(data)

    def run(d, s):
        for _ in range(3):
            s = stepv(s, d)
        return s

    s_plain = run(jax.device_put(data, jax.devices()[0]),
                  jax.device_put(state0, jax.devices()[0]))
    shard = batch_sharding(mesh)
    s_shard = run(jax.device_put(data, shard),
                  jax.device_put(state0, shard))
    np.testing.assert_allclose(np.asarray(s_shard.vars),
                               np.asarray(s_plain.vars),
                               rtol=1e-12, atol=1e-12)


def test_graft_entry_single_chip():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.vars)
    assert out.iteration.shape == (8,)


def test_graft_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
