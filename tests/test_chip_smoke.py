"""chip_smoke.py off the card: it refuses a CPU backend before printing
its result line, and its checks and SciPy reference work."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke


def test_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_check_prints_and_raises(capsys):
    chip_smoke.check("err", 1e-7, 1e-6)
    assert "err: 1.000e-07 (limit 1e-06)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.check("err", 2e-6, 1e-6)
    with pytest.raises(SystemExit):
        chip_smoke.check("err", float("nan"), 1e-6)


def test_scipy_reference_agrees_with_ipm_on_4_instances():
    """The phase-3 comparison helper on 4 instances of the bench batch,
    against the f64 IPM."""
    from ipmzoo.formulations import Settings
    from ipmzoo.models import CompiledIPM
    data = bench.make_batch(4, 16, 8, jnp.float64)
    res = CompiledIPM(Settings(), n=16, m_ineq=8, dtype=jnp.float64,
                      tol=1e-9).solve_batch(data)
    assert bool(jnp.all(res.converged))
    host = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), data)
    x_err, f_err = chip_smoke.compare_with_scipy(
        host, np.asarray(res.x), np.asarray(res.objective), range(4))
    assert x_err < 1e-5
    assert f_err < 1e-8


def test_qd_batch_is_quasi_definite():
    A = chip_smoke.qd_batch(3, 5, 2)
    assert A.shape == (3, 7, 7)
    np.testing.assert_allclose(A, np.swapaxes(A, 1, 2))
    assert np.all(np.linalg.eigvalsh(A[:, :5, :5]) > 0)
    assert np.all(np.linalg.eigvalsh(-A[:, 5:, 5:]) > 0)
