"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the host
platform to expose 8 virtual devices, mirroring how the reference tests
multi-node with 2 MPI ranks on one box (SURVEY.md §4). The GPU is exercised
by ``chip_smoke.py`` at the repository root, not by this suite.
"""

import os

# Force CPU even where a GPU is attached; override with TIKE_TEST_PLATFORM.
# Set the config directly as well as the env var, in case jax is already
# imported.
_platform = os.environ.get("TIKE_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)
jax.config.update("jax_num_cpu_devices", 8)
