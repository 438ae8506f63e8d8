"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors how the reference tests everything through in-memory fakes
(diskstore.Open("") memstore, single-node cluster stand-in) — here the
"fake backend" is XLA's host platform with 8 forced devices so multi-device
sharding paths compile and execute without accelerator hardware.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX has no GPU; run them on the card with
``JAX_PLATFORMS= python -m pytest tests/ -m gpu -p no:xdist`` (an empty
``JAX_PLATFORMS`` lets JAX pick the GPU; any other run is forced onto the
CPU).
"""

import os
import sys

import pytest

if os.environ.get("JAX_PLATFORMS") != "":
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from semadb_tpu.utils import compilecache  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    # Also through jax.config, in case jax was imported before this file.
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for sharding tests"

# Persistent compilation cache: graph kernels are expensive to compile and
# shapes repeat across tests/runs.
compilecache.configure()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere via the gpu fixture)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; JAX found only " + jax.default_backend())
