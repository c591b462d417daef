"""Test configuration: force the CPU with 8 virtual devices, so the sharding
tests run without cards (SURVEY.md §4 test strategy).  The raster kernels
run in the Pallas interpreter on the CPU (raster_pallas.kernel_mode).

Markers: `gpu` tests need a card and skip here; `python -m pytest tests/
-m gpu` runs them on a GPU machine.  `slow` marks tests outside the tier-1
run (`-m 'not slow'`)."""

import os
import sys

# Before JAX is imported: the CPU platform and 8 virtual devices.  The
# subprocess tests inherit JAX_PLATFORMS=cpu for their children.
if os.environ.get("MINI3DGS_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("MINI3DGS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU; skips without one")
    config.addinivalue_line("markers", "slow: outside the tier-1 run")


@pytest.fixture
def gpu():
    """The first GPU, decided when the test runs (never at import or
    collection, so every worker collects the same tests)."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with MINI3DGS_TEST_GPU=1 on a card)")
    return devices[0]
