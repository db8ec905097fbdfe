"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding is
exercised without a GPU. The env vars must be set before jax initializes
its backends, hence at conftest import time. Tests that need the card carry
the `gpu` marker and skip here (see the `gpu_device` fixture).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / large-scale tests (minutes)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (chip_smoke.py runs these)"
    )


def pytest_sessionstart(session):
    if jax.default_backend() == "cpu":
        assert len(jax.devices()) == 8, "tests expect the virtual 8-device CPU mesh"


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip(f"no GPU: {e}")

from adhoc_queries_pointclouds_tpu.formats import synth  # noqa: E402


@pytest.fixture(scope="session")
def small_cloud():
    return synth.make_cloud(20_000, seed=7)


@pytest.fixture(scope="session")
def dataset_dir(tmp_path_factory):
    """A 4-file synthetic dataset in las/last/lazer layouts."""
    root = tmp_path_factory.mktemp("dataset")
    synth.write_dataset(root, n_files=4, points_per_file=30_000, seed=3)
    return root


def oracle_bbox_mask(cloud, bounds):
    """NumPy oracle: closed-box f64 containment on world coords."""
    w = cloud.positions_world
    lo = np.asarray(bounds.min)
    hi = np.asarray(bounds.max)
    return np.all((w >= lo) & (w <= hi), axis=1)

