import os

# Unit tests run on the CPU with x64 and a virtual 8-device mesh, so
# sharded / collective paths are exercised deterministically without a
# GPU.  Pallas kernels run here only in interpret mode, when a test asks
# for it; the card is exercised by chip_smoke.py and bench.py.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already have been imported by a pytest plugin, in which case the
# env vars above came too late — use the config API as well.
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
