"""Test configuration: force an 8-device virtual CPU platform so
multi-device sharding tests run without TPU hardware.

Note: the TPU plugin in this image overrides JAX_PLATFORMS via
jax.config at import time, so we must override back through jax.config
(env vars alone are ignored).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Small-matrix SE(3)/LM math needs full f32 matmuls (TPU default is bf16).
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skips "
        "without one")
