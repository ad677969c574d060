"""Batched Pallas LDL^T kernels (Triton route, interpret mode on the CPU)
against the plain f64 reference, ops/ldlt.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.ops import pallas_ldlt as P
from ipmzoo.ops.ldlt import batched_ldlt, batched_solve_ldlt
from ipmzoo.ops.pallas_ldlt import (batched_ldlt_pallas,
                                    batched_solve_ldlt_pallas, ldlt_auto,
                                    solve_ldlt_auto)


def qd_batch(B, n1, n2, seed=0):
    """Random quasi-definite [[H, A^T], [A, -S]] matrices (f64)."""
    def one(s):
        rng = np.random.default_rng(seed * 1000 + s)
        H = rng.normal(size=(n1, n1))
        H = H @ H.T + n1 * np.eye(n1)
        S = rng.normal(size=(n2, n2))
        S = S @ S.T + n2 * np.eye(n2)
        A = rng.normal(size=(n2, n1))
        return np.block([[H, A.T], [A, -S]])
    return jnp.asarray(np.stack([one(s) for s in range(B)]))


# (B, n1, n2): B below, at and past one batch tile (the default tiles
# hold 32 instances); n = 1, a power of two, and orders that pad to the
# next power of two
SHAPES = [(3, 5, 2), (37, 11, 6), (5, 1, 0), (8, 5, 3), (33, 2, 1)]


def _residual(A, X, R):
    return float(jnp.max(jnp.abs(jnp.einsum("bij,bj...->bi...", A, X) - R)))


@pytest.mark.parametrize("B,n1,n2", SHAPES)
def test_factor_matches_reference(B, n1, n2):
    A = qd_batch(B, n1, n2)
    Lp, Dp = batched_ldlt_pallas(A, interpret=True)
    Lx, Dx = batched_ldlt(A, 1e-8)
    np.testing.assert_allclose(np.asarray(Lp), np.asarray(Lx),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(Dp), np.asarray(Dx),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("B,n1,n2", SHAPES)
def test_solve_matches_reference(B, n1, n2):
    A = qd_batch(B, n1, n2, seed=1)
    n = n1 + n2
    L, D = batched_ldlt(A, 1e-8)
    b = jnp.asarray(np.random.default_rng(0).normal(size=(B, n)))
    xp = batched_solve_ldlt_pallas(L, D, b, interpret=True)
    np.testing.assert_allclose(np.asarray(xp),
                               np.asarray(batched_solve_ldlt(L, D, b)),
                               rtol=1e-9, atol=1e-9)
    assert _residual(A, xp, b) < 1e-8


def test_pivot_floor_in_kernel():
    A = jnp.zeros((2, 4, 4))
    L, D = batched_ldlt_pallas(A, interpret=True)
    assert np.all(np.asarray(D) == 1e-8)
    assert np.all(np.isfinite(np.asarray(L)))
    x = batched_solve_ldlt_pallas(L, D, jnp.zeros((2, 4)), interpret=True)
    assert np.all(np.asarray(x) == 0.0)


def test_f32_kernel_close_to_f64_reference():
    A = qd_batch(9, 16, 8, seed=4)
    b = jnp.asarray(np.random.default_rng(3).normal(size=(9, 24)))
    L, D = batched_ldlt_pallas(A.astype(jnp.float32), interpret=True)
    x = batched_solve_ldlt_pallas(L, D, b.astype(jnp.float32),
                                  interpret=True)
    _, Dx = batched_ldlt(A, 1e-8)
    assert float(jnp.max(jnp.abs(D - Dx) / jnp.abs(Dx))) < 1e-4
    rel = _residual(A, x.astype(jnp.float64), b) / float(jnp.max(jnp.abs(b)))
    assert rel < 1e-4


@pytest.mark.parametrize("B,tile,bt,Bpad", [(3, (32, 4), 4, 4),
                                            (37, (32, 4), 32, 64),
                                            (64, (128, 1), 64, 64),
                                            (1, (32, 4), 2, 2)])
def test_tile_and_padding(B, tile, bt, Bpad):
    assert P._dims(B, 7, tile) == (8, bt, Bpad)
    assert P._dims(B, 1, tile)[0] == 2


def test_custom_vmap_dispatch_on_cpu_uses_plain_path():
    """On the CPU the batched rule takes the plain vmapped path (no
    kernel, no interpreter): same answers as the single-instance call."""
    B, n1, n2 = 4, 6, 3
    n = n1 + n2
    A = qd_batch(B, n1, n2)
    b = jnp.asarray(np.random.default_rng(1).normal(size=(B, n)))
    L0, D0 = ldlt_auto(A[0])
    x0 = solve_ldlt_auto(L0, D0, b[0])
    np.testing.assert_allclose(np.asarray(A[0] @ x0), np.asarray(b[0]),
                               atol=1e-8)
    assert "pallas_call" not in str(jax.make_jaxpr(jax.vmap(ldlt_auto))(A))
    Lv, Dv = jax.vmap(ldlt_auto)(A)
    xv = jax.vmap(solve_ldlt_auto)(Lv, Dv, b)
    np.testing.assert_allclose(np.asarray(Lv[0]), np.asarray(L0),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(xv[0]), np.asarray(x0),
                               rtol=1e-9, atol=1e-9)


def test_custom_vmap_solve_broadcasts_unbatched_factors():
    A = qd_batch(1, 5, 2)[0]
    L, D = ldlt_auto(A)
    bs = jnp.asarray(np.random.default_rng(4).normal(size=(3, 7)))
    xs = jax.vmap(lambda b: solve_ldlt_auto(L, D, b))(bs)
    np.testing.assert_allclose(np.asarray(xs @ A.T), np.asarray(bs),
                               atol=1e-8)


def test_ldlt_auto_large_dim_stays_correct():
    """A batched factor/solve above the kernel's order limit routes to
    the XLA blocked path and stays correct."""
    rng = np.random.default_rng(5)
    n, B = 160, 3
    M = rng.normal(size=(B, n, n))
    A = jnp.asarray(M @ np.swapaxes(M, 1, 2) + n * np.eye(n), jnp.float64)
    b = jnp.asarray(rng.normal(size=(B, n)), jnp.float64)
    L, D = jax.vmap(ldlt_auto)(A)
    x = jax.vmap(solve_ldlt_auto)(L, D, b)
    r = jnp.einsum("bij,bj->bi", A, x) - b
    assert float(jnp.max(jnp.abs(r))) < 1e-7


@pytest.mark.parametrize("fn,args", [
    ("batched_ldlt_pallas", ("A",)),
    ("batched_solve_ldlt_pallas", ("L", "D", "b"))])
def test_kernels_lower_for_cuda(fn, args):
    """Each kernel lowers to the Triton route for CUDA (the Triton IR is
    built here; only the card compiles it to PTX)."""
    A = qd_batch(40, 16, 8).astype(jnp.float32)
    vals = {"A": A, "L": A, "D": A[:, :, 0], "b": A[:, :, 1]}
    lowered = jax.jit(getattr(P, fn)).trace(
        *(vals[a] for a in args)).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()
