"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars BEFORE jax is imported anywhere (SURVEY.md section 4d).
"""

import os

# Belt: env vars for the case where jax has not been imported yet.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Suspenders: if jax was imported before this file ran (a plugin, a
# sitecustomize), the env vars above were read too late — the config API
# still wins as long as no backend has been initialized.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compile cache: the mesh-path test modules recompile the same
# shard_map programs every run; cached runs skip that. Keyed by full
# config+program hash, so correctness-neutral.
from lsm_tpu.cli.common import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
