"""Test configuration: virtual 8-device CPU mesh + float64 enabled.

Tests run on CPU so that (a) the float64 parity path can hit the reference's
1e-12 accuracy gates (reference: test/testIIR.cpp:59), and (b) multi-device
sharding is exercised on an 8-device virtual mesh without a cluster
(SURVEY.md §4 "porting the methodology").  The GPU runs are chip_smoke.py
and the bench*.py scripts.
"""

import jax

# The suite runs on the virtual 8-device CPU mesh even where a GPU is
# present (jax.config, so it holds whatever JAX_PLATFORMS says).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import os
import random

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5D5B)


def pytest_collection_modifyitems(config, items):
    """Randomized test order — the reference CI's ``--order rand`` (reference:
    .github/workflows/cmake-single-platform.yml:61), dependency-free.

    Enabled with SDSP_TEST_ORDER=random (tools/ci.sh does); the seed is
    printed for reproduction and can be pinned with SDSP_TEST_SEED.
    """
    if os.environ.get("SDSP_TEST_ORDER") != "random":
        return
    seed = int(os.environ.get("SDSP_TEST_SEED", random.randrange(1 << 32)))
    print(f"\n[conftest] shuffling test order, SDSP_TEST_SEED={seed}")
    random.Random(seed).shuffle(items)
