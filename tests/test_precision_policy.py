"""The library pins jax_default_matmul_precision to 'highest'.

On the GPU, XLA's DEFAULT f32 matmul precision may run the product in
TF32 (about three decimal digits — utils/precision.py docstring).
Every XLA-path engine assembles KKT
systems and residuals out of matmuls, so the whole convergence story
(tests/test_precision_floor.py's 1e-6 f32 floor, the two-float 1e-8
line) silently breaks on hardware without this pin.  The reference's
CPU doubles are always exact (/root/reference/src/NumericalOptimization
/Evaluation.cpp); this is that guarantee, ported to the device.
"""

import jax

import ipmzoo.ops  # noqa: F401  (import applies the policy)
from ipmzoo.utils import precision


def test_import_pins_highest_precision():
    assert jax.config.jax_default_matmul_precision == "highest"


def test_apply_is_idempotent_and_respects_user_choice(monkeypatch):
    # once applied, a second call is a no-op even if the user has since
    # chosen something else — we never fight an explicit user setting
    jax.config.update("jax_default_matmul_precision", "bfloat16")
    try:
        precision.apply_default_matmul_precision()
        assert jax.config.jax_default_matmul_precision == "bfloat16"
        # and a fresh (unapplied) module run also defers to the existing
        # non-None user value
        monkeypatch.setattr(precision, "_APPLIED", False)
        precision.apply_default_matmul_precision()
        assert jax.config.jax_default_matmul_precision == "bfloat16"
    finally:
        jax.config.update("jax_default_matmul_precision", "highest")


def test_env_opt_out(monkeypatch):
    monkeypatch.setenv("IPMZOO_MATMUL_PRECISION", "default")
    monkeypatch.setattr(precision, "_APPLIED", False)
    before = jax.config.jax_default_matmul_precision
    precision.apply_default_matmul_precision()
    assert jax.config.jax_default_matmul_precision == before
