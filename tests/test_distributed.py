"""Multi-process launcher: real 2-process jax.distributed run on CPU.

Spawns two subprocesses that initialise jax.distributed against a local
coordinator, build a cross-process mesh, and psum a sharded array —
the same code path a multi-host launch uses (with ICI/DCN instead of
Gloo)."""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    proc_id = int(sys.argv[1])
    port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from ipmzoo.parallel.distributed import (initialize,
                                                 local_batch_slice)
    initialize(coordinator_address="127.0.0.1:" + port, num_processes=2,
               process_id=proc_id)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    assert jax.process_count() == 2
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    B = 8
    sl = local_batch_slice(B)
    local_data = jnp.arange(B, dtype=jnp.float32)[sl]
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), np.asarray(local_data), (B,))
    out = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(jnp.sum(x), "dp"),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P()))(garr)
    total = float(np.asarray(jax.device_get(out.addressable_data(0))))
    assert abs(total - 28.0) < 1e-6, total
    print("OK", proc_id, total)
""")


def _free_port() -> str:
    """Ephemeral coordinator port: a fixed port collides when test runs
    overlap (parallel CI, a previous hung run)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_psum(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.pop("XLA_FLAGS", None)  # no virtual device splitting here
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        # a hung coordinator must fail THIS test, not stall the suite:
        # enforce the deadline here (pytest-timeout is not installed)
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        pytest.fail("distributed workers timed out after 240s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"OK {i} 28.0" in out
