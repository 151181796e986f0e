import os

# Tests see the single real CPU device (the dry-run sets its own XLA_FLAGS in
# a subprocess; never set xla_force_host_platform_device_count globally here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the CUDA kernels have no CPU "
        "mode); skips without one")
