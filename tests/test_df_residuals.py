"""Two-float staged residual evaluation (models/codegen_df.py).

The claim under test: near an optimum, residual rows are pure
cancellation, so f32 staged evaluation noise-floors them while the
two-float pipeline tracks the f64 value.  Tests run the evaluators
eagerly (no while_loop compiles — the df graphs are large and the
feature is opt-in for production large-n runs)."""

import jax
import jax.numpy as jnp
import numpy as np

from ipmzoo.formulations import Settings
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.models import codegen_df as cgdf


def _problem(n=16, mi=6, seed=0, dtype=None):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T / n + np.eye(n)
    xf = rng.uniform(-0.5, 0.5, size=n)
    A = rng.normal(size=(mi, n))
    return QPData.make(Q=Q, c=rng.normal(size=n), A_ineq=A,
                       l_A_ineq=A @ xf - 1, u_A_ineq=A @ xf + 1,
                       l_x=np.full(n, -2.0), u_x=np.full(n, 2.0),
                       dtype=dtype)


class TestDFMetrics:
    def test_df_metrics_track_f64_at_optimum(self):
        """Evaluate the KKT residual at (the f32 rounding of) an f64
        optimum: truth is computed in f64 from the SAME f32 point, so
        the comparison isolates evaluation error."""
        n, mi = 16, 6
        data64 = _problem(n, mi)
        s64 = CompiledIPM(Settings(), n=n, m_ineq=mi, tol=1e-11,
                          max_iter=60)
        r64 = s64.solve(data64)
        assert bool(r64.converged)

        # round the optimal point and the data to f32
        vars32 = tuple(jnp.asarray(np.asarray(v), jnp.float32)
                       for v in (r64.variables[v.name]
                                 for v in s64.full.variables))
        data32 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float32), data64)

        # f64 truth AT the f32 point
        vars64 = tuple(jnp.asarray(np.asarray(v), jnp.float64)
                       for v in vars32)
        data64r = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), data32)
        env64 = s64._env(data64r, vars64, 0.0)
        res_true, gap_true = s64._metrics(env64)
        res_true = float(res_true)

        s32p = CompiledIPM(Settings(), n=n, m_ineq=mi,
                           dtype=jnp.float32)
        env32 = s32p._env(data32, vars32, 0.0)
        res_plain = float(s32p._metrics(env32)[0])

        s32d = CompiledIPM(Settings(), n=n, m_ineq=mi,
                           dtype=jnp.float32, df_residuals=True)
        res_df = float(s32d._metrics(cgdf.lift_env(env32))[0])

        # truth at a rounded point is ~1e-6 (rounding the point itself
        # perturbs the residual); the df metric must track it closely,
        # the plain f32 metric floats above on evaluation noise
        assert abs(res_df - res_true) <= 2e-2 * res_true + 1e-9
        assert abs(res_plain - res_true) > 5 * abs(res_df - res_true)

    def test_df_gap_matches(self):
        n, mi = 12, 4
        data = _problem(n, mi, seed=3, dtype=jnp.float32)
        s = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32)
        sd = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                         df_residuals=True)
        st = s.init_state(data)
        env = s._env(data, st.vars, 0.0)
        g_plain = float(s._metrics(env)[1])
        g_df = float(sd._metrics(cgdf.lift_env(env))[1])
        assert abs(g_plain - g_df) <= 1e-5 * max(abs(g_plain), 1.0)


class TestDFSolver:
    def test_eager_steps_converge(self):
        """Run _step_impl eagerly (no jit) with df_residuals: the df
        pipeline must drive the same Mehrotra iteration to the
        reference tolerances in f32."""
        n, mi = 8, 3
        data = _problem(n, mi, seed=5, dtype=jnp.float32)
        s = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                        tol=1e-6, df_residuals=True)
        state = s.init_state(data)
        for _ in range(25):
            if float(state.residual) < 1e-6 and float(state.gap) < 1e-6:
                break
            state = s._step_impl(state, data)
        assert float(state.residual) < 1e-6
        assert float(state.gap) < 1e-6

    def test_eager_steps_match_plain_early(self):
        """Far from the optimum (no cancellation) df and plain paths
        compute the same iteration."""
        n, mi = 8, 3
        data = _problem(n, mi, seed=6, dtype=jnp.float32)
        s = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                        df_residuals=False)
        sd = CompiledIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                         df_residuals=True)
        st = s.init_state(data)
        std = sd.init_state(data)
        for _ in range(3):
            st = s._step_impl(st, data)
            std = sd._step_impl(std, data)
        for a, b in zip(st.vars, std.vars):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-5)
