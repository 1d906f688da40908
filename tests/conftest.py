"""Test configuration.

Tests run on CPU (JAX_PLATFORMS=cpu) with 8 virtual XLA devices so that
multi-device sharding code paths (padne_tpu.parallel) are exercised
without GPUs, and with 64-bit floats enabled (the solver's verification
dtype).  Tests that only a GPU can run carry the `gpu` marker and skip
here; `python chip_smoke.py` runs the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "1")
# Arm the runtime contract checker for the WHOLE suite (the reference
# arms typeguard over the package for every test, pyproject.toml:78-79).
os.environ["PADNE_TPU_CHECKS"] = "1"

import jax  # noqa: E402

# Also set through the config: a plugin may have imported jax before the
# environment variable above was written.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))


@pytest.fixture(scope="session")
def boards_dir(tmp_path_factory):
    """Directory of generated KiCad fixture boards."""
    from tests import boardgen

    out = tmp_path_factory.mktemp("boards")
    boardgen.generate_all(out)
    return out
