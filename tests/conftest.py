import os
import sys
import pathlib
import subprocess
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

# NOTE: no XLA_FLAGS here — tests run single-device; multi-device tests spawn
# subprocesses with their own device-count flag (see run_multidevice).

# hypothesis is optional: property tests skip themselves via importorskip,
# and the whole suite must still COLLECT when it is absent (the seed died at
# collection here). Register the "ci" profile only when it is available.
try:
    from hypothesis import settings
except ImportError:
    settings = None
else:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def run_multidevice(code: str, n_devices: int = 8, timeout: int = 420) -> str:
    """Run `code` in a subprocess with n host devices; returns stdout.
    Raises on nonzero exit (stderr shown in the assertion)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stderr[-4000:]}"
    return proc.stdout


@pytest.fixture
def multidevice():
    return run_multidevice


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")
