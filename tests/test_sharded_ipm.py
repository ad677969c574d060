"""End-to-end IPM with the panel-sharded LDL^T (kernel='sharded').

The TP-axis consumer (VERDICT r2 task 4): ONE KKT system too large for a
single device is row-sharded over the mesh and factored cooperatively
inside every Mehrotra iteration.  Correctness bar: sharded solves must
match the unsharded solver's iterates/solution on the same data
(reference semantics anchor: the factorisation is the same unpivoted
LDL^T with the 1e-8 pivot floor,
/root/reference/src/NumericalOptimization/LinearSolvers.cpp:26-28).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import Bounds, InequalityHandling, Settings
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.parallel.mesh import make_mesh

BOX = Settings(inequalities=Bounds.NONE,
               inequality_handling=InequalityHandling.SLACKS)


def _box_qp(n, seed=0, dtype=np.float64, scale=1.0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = (M @ M.T / n + np.eye(n)) * scale
    return QPData.make(Q=Q, c=rng.normal(size=n),
                       l_x=np.full(n, -2.0), u_x=np.full(n, 2.0),
                       dtype=dtype)


def _mesh(ndev=8):
    if len(jax.devices()) < ndev:
        pytest.skip(f"needs {ndev} devices")
    return make_mesh((ndev,), ("tp",), jax.devices()[:ndev])


class TestShardedIPM:
    def test_matches_unsharded_full_solve(self):
        """Full Mehrotra solve with the sharded factor == the plain
        solver, to tolerance, on an 8-device mesh (aug_dim divides
        evenly: panel 8, 64 rows over 8 devices)."""
        mesh = _mesh()
        n = 64
        data = _box_qp(n)
        sharded = CompiledIPM(BOX, n=n, dtype=jnp.float64, tol=1e-8,
                              kernel="sharded", mesh=mesh, panel=8)
        plain = CompiledIPM(BOX, n=n, dtype=jnp.float64, tol=1e-8,
                            kernel="jnp")
        rs = sharded.solve(data)
        rp = plain.solve(data)
        assert bool(rs.converged)
        assert bool(rp.converged)
        assert int(rs.iterations) == int(rp.iterations)
        np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rp.x),
                                   rtol=0, atol=1e-9)

    def test_identity_padding_any_dim(self):
        """aug_dim NOT divisible by devices*panel: the identity padding
        makes the sharded factor well-defined and the solution
        unchanged."""
        mesh = _mesh()
        n = 50   # pads to 64 with panel=8 over 8 devices
        data = _box_qp(n, seed=3)
        sharded = CompiledIPM(BOX, n=n, dtype=jnp.float64, tol=1e-8,
                              kernel="sharded", mesh=mesh, panel=8)
        assert sharded._sharded_dim == 64
        plain = CompiledIPM(BOX, n=n, dtype=jnp.float64, tol=1e-8,
                            kernel="jnp")
        rs = sharded.solve(data)
        rp = plain.solve(data)
        assert bool(rs.converged)
        np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rp.x),
                                   rtol=0, atol=1e-9)

    def test_ineq_formulation_sharded(self):
        """A formulation with inequality blocks (3+ variable groups in
        the augmented system) also solves sharded == unsharded."""
        mesh = _mesh()
        n, m = 24, 8
        rng = np.random.default_rng(1)
        M = rng.normal(size=(n, n))
        data = QPData.make(
            Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
            A_ineq=rng.normal(size=(m, n)),
            l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
            u_A_ineq=np.abs(rng.normal(size=m)) + 1,
            l_x=np.full(n, -5.0), u_x=np.full(n, 5.0))
        sharded = CompiledIPM(Settings(), n=n, m_ineq=m,
                              dtype=jnp.float64, tol=1e-8,
                              kernel="sharded", mesh=mesh, panel=4)
        plain = CompiledIPM(Settings(), n=n, m_ineq=m,
                            dtype=jnp.float64, tol=1e-8, kernel="jnp")
        rs = sharded.solve(data)
        rp = plain.solve(data)
        assert bool(rs.converged)
        np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rp.x),
                                   rtol=0, atol=1e-8)

    def test_requires_mesh(self):
        with pytest.raises(ValueError, match="mesh"):
            CompiledIPM(BOX, n=8, kernel="sharded")


@pytest.mark.slow
def test_sharded_large_qp_solves():
    """VERDICT r2 task 4 'done' bar: an n>=4096 QP solves to tolerance
    across 8 virtual devices with sharded==unsharded iterates."""
    mesh = _mesh()
    n = 4096
    data = _box_qp(n, dtype=np.float32, scale=1.0)
    sharded = CompiledIPM(BOX, n=n, dtype=jnp.float32, tol=1e-4,
                          kernel="sharded", mesh=mesh, panel=128,
                          max_iter=40, scale_tol=True)
    rs = sharded.solve(data)
    assert bool(rs.converged)
    plain = CompiledIPM(BOX, n=n, dtype=jnp.float32, tol=1e-4,
                        kernel="jnp", max_iter=40, scale_tol=True)
    rp = plain.solve(data)
    assert int(rs.iterations) == int(rp.iterations)
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rp.x),
                               rtol=0, atol=5e-3)
