"""chip_smoke.py refuses to run anywhere but on a GPU."""

import pathlib
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.check_devices(jax.devices("cpu"))
    with pytest.raises(chip_smoke.SmokeFailure, match="no device"):
        chip_smoke.check_devices([])


def test_script_fails_without_gpu():
    """Run as the driver runs it, on this CPU-only host: non-zero exit and
    no JSON result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
