"""Test harness: CPU backend with a virtual 8-device mesh, plus
session-scoped fixtures for reference-tool golden testing and small
simulated datasets.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu` fixture, which skips them on the CPU; `python chip_smoke.py`
runs the same checks on the card."""
import os
import subprocess
import sys

# Force CPU with a virtual 8-device mesh: the env var for child
# processes, the config update for this one (before backend init).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU; "
                   "python chip_smoke.py runs these checks on the card)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py "
                    "on the card")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def reference_bins(tmp_path_factory):
    """Compile the reference C tools once per session (into tmp).

    MaxCorrelation/RepeatResolver need GSL; we provide a drop-in shim for
    the three CDFs they use (tests/golden/gsl_shim.c) built from the same
    log-space math as our Python implementation.
    """
    if not os.path.isdir(REFERENCE):
        pytest.skip(f"reference C sources not present at {REFERENCE}")
    build = tmp_path_factory.mktemp("refbins")
    script = os.path.join(REPO, "tests", "golden", "build_reference.sh")
    subprocess.run(["bash", script, str(build)], check=True,
                   capture_output=True, text=True)
    return build


@pytest.fixture(scope="session")
def tiny_dataset(tmp_path_factory):
    """A very small simulated dataset written to disk in reference format."""
    from repeatresolver_tpu.config import SimulatorConfig
    from repeatresolver_tpu.models.simulator import simulate

    cfg = SimulatorConfig(coverage=8, copynumber=4, repeatlength=2000,
                          difference=0.02, flank=1500, seed=7)
    ds = simulate(cfg)
    d = tmp_path_factory.mktemp("tiny")
    paths = ds.write(d)
    return ds, paths


@pytest.fixture(scope="session")
def small_dataset(tmp_path_factory):
    """The BASELINE.json 'small sim' config at reduced coverage (kept
    CPU-fast); used for end-to-end stage parity."""
    from repeatresolver_tpu.config import SimulatorConfig
    from repeatresolver_tpu.models.simulator import simulate

    cfg = SimulatorConfig(coverage=15, copynumber=10, repeatlength=5000,
                          difference=0.01, flank=3000, seed=1)
    ds = simulate(cfg)
    d = tmp_path_factory.mktemp("small")
    paths = ds.write(d)
    return ds, paths


def rng(seed=0):
    return np.random.default_rng(seed)
