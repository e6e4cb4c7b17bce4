"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on CPU with 8 virtual devices so the multi-device shard_map tier
is exercised without hardware; the GPU path is checked on the card by
chip_smoke.py, and its CUDA lowering here by tests/test_cuda_lowering.py.
This mirrors the reference's use of the *sequential* runtime
libcumultigpu_seq.a as the deterministic stand-in for the threaded
multi-GPU scheduler (reference multigpu/multigpu_seq.c).
"""

import os

# Must be set before jax initializes its backends.
_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full ~40 min suite; the default "
             "fast subset keeps one representative per feature)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy compile/interpret-mode test with cheaper sibling "
        "coverage; excluded by default, enabled with --runslow or "
        "RUN_SLOW=1")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: run with --runslow / RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu"
    return devs
