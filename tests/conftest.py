"""Test harness configuration.

The platform comes from JAX_PLATFORMS and is the CPU when that variable is
unset. On the CPU the suite runs with 8 virtual devices so the multi-device
sharding paths compile and execute without accelerator hardware (the
deterministic-CPU stand-in for a fake backend, SURVEY.md §4). Tests that
need a CUDA device take the `gpu` fixture and carry the `gpu` marker;
`chip_smoke.py` runs them on the card with JAX_PLATFORMS=cuda.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# set through the config API too: jax may already be imported by a plugin
# before this file runs, and then the env var alone is not read again
import jax  # noqa: E402

_platforms = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _platforms)
if _platforms == "cpu":
    # CPU test runs write no persistent compile cache, so no XLA:CPU entry
    # compiled here ever reaches another machine through the checkout
    jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_ROOT = "/root/reference"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip("reference data not mounted")
    return REFERENCE_ROOT


@pytest.fixture(scope="session")
def calib(reference_root):
    from rgbd360_tpu.io.calib import Calib360

    return Calib360.load(reference_root)


@pytest.fixture(scope="session")
def sample_frames(calib, reference_root):
    from rgbd360_tpu.core.frame360 import Frame360

    f1 = Frame360(calib, 0).build(os.path.join(reference_root, "samples/sphere_images_1.bin"))
    f2 = Frame360(calib, 1).build(os.path.join(reference_root, "samples/sphere_images_10.bin"))
    return f1, f2


@pytest.fixture(scope="session")
def nominal_root(tmp_path_factory):
    """A reference-layout data root for the ideal rig, generated in place
    (tools/make_synthetic_sequence.write_nominal_data_root)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.make_synthetic_sequence import write_nominal_data_root

    root = str(tmp_path_factory.mktemp("nominal_root"))
    write_nominal_data_root(root)
    return root


@pytest.fixture(scope="session")
def gpu():
    """The CUDA device, or a skip: decided here, never at import time."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA device (platform is {dev.platform}); "
                    "run through chip_smoke.py")
    return dev


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    return np.random.default_rng(0)
