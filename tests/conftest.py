"""Test harness: run all tests on a virtual 8-device CPU mesh.

This is the standard way to test pjit/shard_map/psum code without several
accelerators; the card itself is exercised by chip_smoke.py.
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import subprocess

import numpy as np
import pytest

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def native_built():
    """Build the native runtime on demand (only tests that need the .so
    request this), so an unrelated single-test run never pays the native
    build as a collection side effect. Skips when no toolchain exists."""
    from unified_cvo_tpu import native

    if not native.available():
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_repo, "native")],
                capture_output=True, timeout=180, check=False,
            )
        except Exception:
            pass
    if not native.available():
        pytest.skip("libcvo_native.so not built (no toolchain)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
