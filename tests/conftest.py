"""Test configuration: run on a virtual 8-device CPU mesh by default.

Multi-chip sharding is validated on host devices
(xla_force_host_platform_device_count), mirroring how the reference treats
its SERIAL backend as the reference implementation all device backends must
match (reference: tests/mgard-x/CMakeLists.txt:12-53). Set MGARD_TEST_GPU=1
to leave the platform to JAX (the GPU when there is one); the on-card smoke
matrix (tests/test_gpu_smoke.py, marker ``gpu``) runs only then.

The platform is *forced* (not setdefault): where JAX_PLATFORMS is already
exported the numeric-oracle suite must still run on CPU.
"""

import os

if not os.environ.get("MGARD_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    # The persistent compile cache would hold XLA:CPU executables compiled
    # for whatever machine ran the suite last; keep the CPU suite off it
    # (subprocesses inherit the setting).
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


# ----------------------------------------------------------------------
# Every jitted executable the CPU backend loads stays mapped for the life
# of the process, and the suite compiles thousands of programs — enough to
# reach the kernel's vm.max_map_count limit (65530 by default), after which
# the next executable load segfaults at whichever compile crosses it.
# jax.clear_caches() releases the mappings, so drop compiled state between
# test modules.
import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_jit_mappings_per_module():
    yield
    import jax

    jax.clear_caches()
    gc.collect()
