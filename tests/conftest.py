"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Parity/accuracy tests run in float64 on the CPU backend; sharding tests use
the 8 virtual CPU devices.  Code that needs the GPU is driven by
chip_smoke.py, not by this suite.
"""

import os

# The suite always runs on the local CPU backend, whatever the environment
# selects.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu"
