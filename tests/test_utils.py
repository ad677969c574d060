"""Utils: timer, checkpointing, iteration trace, solve summary."""

import numpy as np
import jax.numpy as jnp
import pytest

from ipmzoo.formulations import InequalityHandling, Settings
from ipmzoo.models import CompiledIPM, QPData
from ipmzoo.utils import (IterationTrace, Timer, load_metadata,
                              load_state, save_state, solve_summary)


def test_timer_sections():
    t = Timer()
    with t.section("a"):
        with t.section("b"):
            pass
    assert t.elapsed("a") >= t.elapsed("b") >= 0
    out = t.report(print_fn=None)
    assert "a:" in out and "b:" in out


def test_checkpoint_roundtrip(tmp_path):
    state = {"x": jnp.arange(5.0), "nested": (jnp.ones((2, 2)),
                                              jnp.asarray(3))}
    path = str(tmp_path / "st.npz")
    save_state(path, state, {"iteration": 7})
    loaded = load_state(path, state)
    np.testing.assert_array_equal(np.asarray(loaded["x"]),
                                  np.asarray(state["x"]))
    np.testing.assert_array_equal(np.asarray(loaded["nested"][0]),
                                  np.ones((2, 2)))
    assert load_metadata(path) == {"iteration": 7}


@pytest.fixture(scope="module")
def demo_solver():
    return CompiledIPM(Settings(
        inequality_handling=InequalityHandling.SLACKED_SLACKS), 2, 1)


def demo_data():
    return QPData.make(
        Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
        A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
        l_x=[0.0, 0.0], u_x=[10.0, 10.0], dtype=jnp.float64)


def test_iteration_trace_matches_reference_log(demo_solver):
    """The host-stepped trace reproduces the reference's per-iteration
    log line values (Optimizer.cpp:131-132) for the demo QP."""
    records = IterationTrace(demo_solver).run(demo_data())
    assert records[0].iteration == 0
    np.testing.assert_allclose(records[0].objective, -21.25, rtol=1e-10)
    np.testing.assert_allclose(records[0].residual, 14.07409, rtol=1e-5)
    np.testing.assert_allclose(records[0].gap, 1.0, rtol=1e-10)
    # converged end state matches the oracle trace
    assert records[-1].residual < 1e-8 and records[-1].gap < 1e-8
    assert len(records) - 1 == 12


def test_solve_summary(demo_solver):
    res = demo_solver.solve(demo_data())
    rec = solve_summary(res, log=False)
    assert rec["converged"] is True
    assert rec["iterations"] == 12


def test_solver_state_checkpoint_resume(tmp_path, demo_solver):
    """Solve can be checkpointed mid-run and resumed bitwise."""
    data = demo_data()
    st = demo_solver.init_state(data)
    for _ in range(3):
        st = demo_solver.step(st, data)
    path = str(tmp_path / "ipm.npz")
    save_state(path, st)
    st2 = load_state(path, st)
    a = demo_solver.step(st, data)
    b = demo_solver.step(st2, data)
    for va, vb in zip(a.vars, b.vars):
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
