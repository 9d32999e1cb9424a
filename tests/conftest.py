"""Test configuration: run the tests on a virtual 8-device CPU mesh.

GPU behaviour is exercised by `chip_smoke.py` and by the tests marked
`gpu`, which skip unless JAX can see a GPU; run those on a machine with
one as `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`. The rest
stay deterministic and multi-device-capable on the CPU (the reference
could only test on a physical GPU — SURVEY.md §4).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run with JAX_PLATFORMS=cuda,cpu on a GPU machine)")
