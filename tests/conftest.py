"""Test configuration.

The suite runs on the CPU by default: ``JAX_PLATFORMS`` defaults to
``cpu`` with eight virtual host devices, so the sharding tests have a mesh.
Tests marked ``gpu`` take the ``gpu_device`` fixture, which skips them
unless JAX sees a GPU; ``python chip_smoke.py`` runs them on the card.
Nothing here changes which tests are collected.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; JAX sees none")
    return gpus[0]
