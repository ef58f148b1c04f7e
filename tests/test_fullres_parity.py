"""Full-resolution (1024x768) oracle parity — the README's >99.8% claim.

The low-res suite (test_oracle_parity.py) cannot see resolution-dependent
divergence (early-termination bounds, footprint-region margins grow with
resolution). This test executes the claim itself via
relativitypathtracer_tpu.utils.parity in a fresh subprocess so the real
(GPU) backend is used rather than the conftest's pinned CPU platform.

Gated behind RPT_FULLRES=1 because the jnp fallback path at 1024x768 on a
CPU-only host takes minutes per scene; the SAME check runs unconditionally
on the card inside bench.py (fullres_parity_frac_gt_1e3 in the bench
JSON), and chip_smoke.py checks the flagship frame the same way.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_midres_oracle_parity_always(reference_root):
    """Medium-resolution (448x336) oracle parity on shadows.txt --
    mesh + analytic + shadow rays through the whole frame pipeline at a
    resolution where tile padding, early-termination bounds and footprint
    margins differ from the 192x108 smoke suite. ~80 s on a CPU host; keeps
    a resolution-sensitive check in CI even when the full-res tier below
    is skipped."""
    import shutil

    from relativitypathtracer_tpu.utils.parity import fullres_parity

    if not (REPO / "native" / "cpu_reference").exists() and not shutil.which("g++"):
        pytest.skip("no prebuilt oracle and no g++ to build it")
    res = fullres_parity("shadows", 448, 336)
    assert res["ok"], res
    assert res["frac_bad"] <= 0.0005, res


@pytest.mark.skipif(
    not os.environ.get("RPT_FULLRES"),
    reason="set RPT_FULLRES=1 (needs a fast backend; bench.py enforces this "
    "same check on the real chip every round)",
)
@pytest.mark.parametrize(
    "name",
    ["cube", "soccer", "arch", "cubes", "ladder_paradox", "rulers",
     "shadows", "bunny"],
)
def test_fullres_oracle_parity(name):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run(
        [sys.executable, "-m", "relativitypathtracer_tpu.utils.parity", name],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=1200,
    )
    assert out.returncode == 0, f"parity failed:\n{out.stdout}\n{out.stderr}"
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"], res
