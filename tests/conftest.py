"""Test configuration: the CPU backend with 8 virtual devices, so sharding
tests run anywhere. Must run before jax is imported. Tests that need a GPU
carry the ``gpu`` marker and skip here (see the ``gpu`` fixture)."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cuda_recommender_tpu.data import datasets  # noqa: E402


@pytest.fixture(scope="session")
def small_data():
    """Small power-law synthetic dataset shared across tests."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="session")
def tiny_data():
    return datasets.synthetic(m=40, n=25, nnz=400, seed=3, power_law=False)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none (the CPU
    test run). Decided here, at run time, so every test worker collects
    the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda "
                    "pytest -m gpu")
    return dev
