"""solve_batch_compact: straggler-free batched solving.

Covers VERDICT round-1 items: convergence-validated batched full solves
(the benchmark's default engine), the dtype-tied mu floor, and the
Gondzio tail stages that break Mehrotra cycling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipmzoo.formulations import Settings
from ipmzoo.models import CompiledIPM, QPData


def _random_batch(batch, n, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
    return QPData(
        Q=jnp.asarray(Q, dtype),
        c=jnp.asarray(rng.normal(size=(batch, n)), dtype),
        A_ineq=jnp.asarray(rng.normal(size=(batch, m, n)), dtype),
        l_A_ineq=jnp.asarray(-np.abs(rng.normal(size=(batch, m))) - 1,
                             dtype),
        u_A_ineq=jnp.asarray(np.abs(rng.normal(size=(batch, m))) + 1,
                             dtype),
        A_eq=jnp.zeros((batch, 0, n), dtype),
        b_eq=jnp.zeros((batch, 0), dtype),
        l_x=jnp.full((batch, n), -5.0, dtype),
        u_x=jnp.full((batch, n), 5.0, dtype))


class TestCompact:
    def test_matches_plain_solve_batch(self):
        data = _random_batch(192, 8, 4, jnp.float64)
        s = CompiledIPM(Settings(), n=8, m_ineq=4, dtype=jnp.float64,
                        tol=1e-8, kernel="jnp")
        r1 = s.solve_batch(data)
        # tail_gondzio=0 + no restart: pure compaction must reproduce
        # the plain solver's iterates exactly (who keeps stepping
        # changes, the steps themselves must not)
        r2 = s.solve_batch_compact(data, tail_gondzio=0,
                                   tail_restart=False)
        c1, c2 = np.asarray(r1.converged), np.asarray(r2.converged)
        assert c1.mean() == 1.0 and c2.mean() == 1.0
        both = c1 & c2
        np.testing.assert_allclose(np.asarray(r2.x)[both],
                                   np.asarray(r1.x)[both],
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(np.asarray(r1.iterations),
                                      np.asarray(r2.iterations))
        # default tail (gondzio=2) may take a different path on slow
        # instances but must agree to solution tolerance
        r3 = s.solve_batch_compact(data)
        assert np.asarray(r3.converged).mean() == 1.0
        np.testing.assert_allclose(np.asarray(r3.x), np.asarray(r1.x),
                                   rtol=0, atol=1e-6)

    def test_small_batch_single_stage(self):
        data = _random_batch(8, 8, 4, jnp.float64)
        s = CompiledIPM(Settings(), n=8, m_ineq=4, dtype=jnp.float64,
                        tol=1e-8, kernel="jnp")
        r = s.solve_batch_compact(data)
        assert np.asarray(r.converged).all()

    def test_custom_schedule_capacity_overflow_mopped_up(self):
        # a schedule whose tail capacity cannot hold the active set
        # (cap 1 of ~64 actives here) used to silently leave the
        # overflow unconverged; the full-batch mop-up stage now finishes
        # them — the compact engine is never worse-converging than
        # solve_batch within the same per-instance budget
        data = _random_batch(64, 8, 4, jnp.float64)
        s = CompiledIPM(Settings(), n=8, m_ineq=4, dtype=jnp.float64,
                        tol=1e-8, kernel="jnp")
        r = s.solve_batch_compact(data, schedule=[(1, 1), (30, 64)])
        full = s.solve_batch(data)
        assert np.asarray(full.converged).all()
        assert np.asarray(r.converged).all()
        # the mop-up runs Gondzio rounds (plain solve_batch does not),
        # so converged iterates agree to solution tolerance, not bitwise
        np.testing.assert_allclose(np.asarray(r.x), np.asarray(full.x),
                                   atol=1e-5)

    def test_f32_full_convergence_with_tail_gondzio(self):
        data = _random_batch(256, 16, 8, jnp.float32, seed=3)
        s = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float32,
                        tol=1e-5, kernel="jnp")
        r = s.solve_batch_compact(data)
        assert np.asarray(r.converged).mean() >= 0.99


class TestMuFloor:
    def test_auto_floor_tied_to_dtype(self):
        s32 = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=jnp.float32,
                          kernel="jnp")
        s64 = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=jnp.float64,
                          kernel="jnp")
        eps32 = float(jnp.finfo(jnp.float32).eps)
        eps64 = float(jnp.finfo(jnp.float64).eps)
        assert s32.mu_floor == pytest.approx(eps32 ** 2)
        assert s64.mu_floor == pytest.approx(eps64 ** 2)

    def test_floor_does_not_block_1e8_convergence(self):
        data = _random_batch(32, 8, 4, jnp.float64)
        s = CompiledIPM(Settings(), n=8, m_ineq=4, dtype=jnp.float64,
                        tol=1e-8, kernel="jnp")
        r = s.solve_batch(data)
        assert np.asarray(r.converged).all()
        assert np.asarray(r.gap).max() < 1e-8


class TestMehrotraCycling:
    """Plain Mehrotra cycles on some well-conditioned instances (a
    period-3 residual oscillation, reproducible in f64); Gondzio
    centrality correctors break the cycle.  Pin both facts."""

    def _cycler(self):
        # instance 2487 of the benchmark workload (seed 0, B=10240)
        rng = np.random.default_rng(0)
        B, n, m = 10240, 16, 8
        M = rng.normal(size=(B, n, n)).astype(np.float32)
        Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n,
                                                         dtype=np.float32)
        c = rng.normal(size=(B, n))
        A = rng.normal(size=(B, m, n))
        lA = -np.abs(rng.normal(size=(B, m))) - 1
        uA = np.abs(rng.normal(size=(B, m))) + 1
        i = 2487
        dt = jnp.float64
        return QPData(
            Q=jnp.asarray(Q[i:i + 1], dt), c=jnp.asarray(c[i:i + 1], dt),
            A_ineq=jnp.asarray(A[i:i + 1], dt),
            l_A_ineq=jnp.asarray(lA[i:i + 1], dt),
            u_A_ineq=jnp.asarray(uA[i:i + 1], dt),
            A_eq=jnp.zeros((1, 0, n), dt), b_eq=jnp.zeros((1, 0), dt),
            l_x=jnp.full((1, n), -5.0, dt), u_x=jnp.full((1, n), 5.0, dt))

    def test_gondzio_breaks_cycle(self):
        data = self._cycler()
        plain = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float64,
                            tol=1e-8, max_iter=60, kernel="jnp")
        rp = plain.solve_batch(data)
        assert not bool(np.asarray(rp.converged)[0])  # pins the cycle
        gz = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float64,
                         tol=1e-8, max_iter=60, kernel="jnp", gondzio=2)
        rg = gz.solve_batch(data)
        assert bool(np.asarray(rg.converged)[0])
        assert int(np.asarray(rg.iterations)[0]) < 20

    def test_compact_tail_gondzio_rescues_cycler(self):
        data = self._cycler()
        # batch: 63 easy instances + the cycler; default schedule's tail
        # stages (gondzio=2) must rescue it within max_iter
        easy = _random_batch(63, 16, 8, jnp.float64, seed=1)
        batch = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b]), easy, data)
        s = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float64,
                        tol=1e-8, kernel="jnp")
        r = s.solve_batch_compact(batch, schedule=[(12, 1), (12, 8),
                                                   (40, 16)])
        assert np.asarray(r.converged).all()


class TestEscalation:
    """The XLA compact engine's final two-float escalation stage:
    f32-representation-floor stragglers are finished warm in
    double-single pairs."""

    def test_escalation_rescues_starved_batch(self):
        # starve every earlier stage (budget 3, no mop-up headroom) so
        # only the escalation stage can converge the batch
        B, n, m = 8, 6, 3
        data = _random_batch(B, n, m, jnp.float64, seed=5)
        s = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float64,
                        tol=1e-8, max_iter=3)
        starved = s.solve_batch_compact(data, schedule=[(3, 1)],
                                        esc_cap=0)
        assert not bool(jnp.all(starved.converged))
        out = s.solve_batch_compact(data, schedule=[(3, 1)],
                                    esc_cap=B, esc_iters=60)
        assert bool(jnp.all(out.converged))
        ref = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=jnp.float64,
                          kernel="jnp", max_iter=60).solve_batch(data)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                                   rtol=1e-6, atol=1e-6)

    def test_auto_cap_tied_to_dtype_and_tol(self):
        import jax.numpy as jnp
        s32 = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=jnp.float32,
                          tol=1e-6)
        s64 = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=jnp.float64,
                          tol=1e-6)
        data = _random_batch(4, 4, 2, jnp.float64, seed=6)
        d32 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), data)
        s32.solve_batch_compact(d32)
        s64.solve_batch_compact(data)
        # f32 at tol 1e-6 builds the pair twin; f64 never needs it
        assert hasattr(s32, "_esc_twin")
        assert not hasattr(s64, "_esc_twin")
