"""Official-run backend guard: a broken accelerator setup can let jax fall
back to the CPU backend. bench.py must refuse to record CPU frames as an
official accelerator artifact; explicit RPT_PLATFORM pins (the smoke path)
stay exempt."""

import bench


import pytest

pytestmark = pytest.mark.fast  # inner-loop subset


def test_cpu_fallback_policy():
    # official run on cpu -> refuse
    assert bench.cpu_fallback("cpu", None)
    # set-but-empty pin (RPT_PLATFORM="" via an unset wrapper var) does NOT
    # pin the platform, so it must not exempt the guard either
    assert bench.cpu_fallback("cpu", "")
    # explicit smoke pin -> allowed
    assert not bench.cpu_fallback("cpu", "cpu")
    # the card -> allowed
    assert not bench.cpu_fallback("gpu", None)
    assert not bench.cpu_fallback("cuda", None)
