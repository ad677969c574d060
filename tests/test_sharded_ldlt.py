"""Panel-sharded single-KKT factorization across the 8-device mesh.

The TP axis of SURVEY §2.5: one quasi-definite KKT system row-sharded
over the mesh, factored cooperatively (psum-broadcast panels, local
trailing matmuls), matching the unsharded panel-blocked factorisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.ops.blocked_ldlt import ldlt_blocked
from ipmzoo.ops.sharded_ldlt import (shard_kkt, sharded_ldlt,
                                         sharded_ldlt_solve)
from ipmzoo.parallel.mesh import make_mesh


def kkt(n, m, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n, n))
    H = H @ H.T / n + scale * np.eye(n)
    S = rng.normal(size=(m, m))
    S = S @ S.T / m + np.eye(m)
    B = rng.normal(size=(m, n))
    return np.block([[H, B.T], [B, -S]])


@pytest.mark.parametrize("panel", [32, 64])
def test_sharded_factor_matches_unsharded(panel):
    K = kkt(384, 128, seed=0)           # dim 512 over 8 devices
    mesh = make_mesh(axis_names=("tp",))
    Ks = shard_kkt(jnp.asarray(K), mesh)
    L, Lds, D = sharded_ldlt(Ks, mesh, panel=panel)
    L0, D0 = ldlt_blocked(jnp.asarray(K))
    np.testing.assert_allclose(np.asarray(jax.device_get(L)),
                               np.asarray(L0), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(np.asarray(D), np.asarray(D0),
                               rtol=1e-10, atol=1e-10)
    # the factor comes back still sharded over the mesh rows
    assert L.sharding.num_devices == 8


def test_sharded_solve():
    K = kkt(384, 128, seed=1)
    mesh = make_mesh(axis_names=("tp",))
    Ks = shard_kkt(jnp.asarray(K), mesh)
    factors = sharded_ldlt(Ks, mesh, panel=64)
    b = np.random.default_rng(2).normal(size=512)
    x = sharded_ldlt_solve(factors, jnp.asarray(b), mesh, panel=64)
    np.testing.assert_allclose(K @ np.asarray(x), b, rtol=1e-10,
                               atol=1e-10)


def test_bad_shapes_rejected():
    mesh = make_mesh(axis_names=("tp",))
    with pytest.raises(ValueError):
        sharded_ldlt(jnp.eye(100), mesh)            # 100 % 8 != 0
    with pytest.raises(ValueError):
        sharded_ldlt(jnp.eye(512), mesh, panel=48)  # 48 does not divide 64


@pytest.mark.slow
def test_large_kkt_factors_across_mesh():
    """VERDICT criterion: an n>=4096 KKT system factors across the
    8-device mesh; verified by L D L^T reconstruction (an unsharded
    reference factorisation at this size would double the runtime)."""
    K = kkt(3584, 512, seed=3, scale=2.0)           # dim 4096
    mesh = make_mesh(axis_names=("tp",))
    Ks = shard_kkt(jnp.asarray(K), mesh)
    L, Lds, D = sharded_ldlt(Ks, mesh)
    Lg = np.asarray(jax.device_get(L))
    err = np.max(np.abs(Lg @ np.diag(np.asarray(D)) @ Lg.T - K))
    assert err < 1e-9
    b = np.random.default_rng(4).normal(size=4096)
    x = sharded_ldlt_solve((L, Lds, D), jnp.asarray(b), mesh)
    resid = np.max(np.abs(K @ np.asarray(x) - b))
    assert resid < 1e-9
