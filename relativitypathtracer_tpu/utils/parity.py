"""Full-resolution differential parity vs the native C++ oracle.

Enforces the README's claim (README.md "Performance"): at 1024x768 every
scene's per-pixel RGB matches the oracle within 1e-3 on >99.8% of pixels
(the rest are contrast-edge fp flips between two float implementations).
The oracle (native/cpu_reference.cpp) independently implements the full
reference algorithm (/root/reference/opencl_kernel.cl:620-660), so this is
an executable end-to-end check of the whole frame pipeline at production
resolution -- the low-res pytest parity suite (tests/test_oracle_parity.py)
cannot see resolution-dependent divergence (early-termination bounds,
footprint-region margins).

Used two ways:
- bench.py folds `fullres_parity()` results into its JSON line each round;
- `python -m relativitypathtracer_tpu.utils.parity [scenes...]` runs it
  standalone (exit 1 on failure), e.g. from tests in a GPU subprocess.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
REF = pathlib.Path(os.environ.get("REF_ASSETS", "/root/reference"))
ORACLE = REPO / "native" / "cpu_reference"
MAX_FRAC_BAD = 0.002  # >99.8% of pixels within 1e-3


def _ensure_oracle() -> str:
    if not ORACLE.exists():
        subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                       capture_output=True)
    return str(ORACLE)


def fullres_parity(name: str, width: int = 1024, height: int = 768,
                   workdir: str = "/tmp", state=None, tag: str | None = None) -> dict:
    """Render `name`.txt at full resolution with both implementations.

    state: optional FrameState (default: FrameState.initial()) -- a boosted /
    advanced-time state exercises the full per-frame boost chain at
    production resolution, where early-termination bounds and footprint
    margins can diverge in ways low-res tests cannot see.
    Returns {"scene", "frac_bad" (pixels with max-channel diff > 1e-3),
    "mean_diff", "ok"}.
    """
    from relativitypathtracer_tpu import build_scene, load_scene_file
    from relativitypathtracer_tpu.render import FrameState, render_frame
    from relativitypathtracer_tpu.utils.scene_blob import write_scene_blob

    host = load_scene_file(str(REF / "Scenes" / f"{name}.txt"))
    scene, meta = build_scene(host)
    if state is None:
        state = FrameState.initial()
    tag = tag or name

    blob = f"{workdir}/parity_{tag}.blob"
    out = f"{workdir}/parity_{tag}.rgb"
    write_scene_blob(blob, scene, meta, state, width, height)
    subprocess.run([_ensure_oracle(), blob, out], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(height, width, 3)

    ours = np.asarray(render_frame(scene, meta, state, width, height))
    diff = np.abs(ref - ours)
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    return {
        "scene": tag,
        "frac_bad": round(frac_bad, 6),
        "mean_diff": round(float(diff.mean()), 7),
        "ok": bool(frac_bad <= MAX_FRAC_BAD),
    }


ALL_SCENES = ("arch", "bunny", "cube", "cubes", "ladder_paradox", "rulers",
              "shadows", "soccer")


def main(argv: list[str]) -> int:
    """`python -m relativitypathtracer_tpu.utils.parity [--out FILE]
    [scenes...|all]` -- renders each scene at 1024x768 with both
    implementations; with --out, writes the per-scene results (plus backend
    and package version) as one JSON artifact."""
    from .jaxcache import enable as _enable_cache

    _enable_cache()
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    names = argv or ["bunny", "shadows"]
    if names == ["all"]:
        names = list(ALL_SCENES)
    rc = 0
    results = []
    for name in names:
        res = fullres_parity(name)
        print(json.dumps(res), flush=True)
        results.append(res)
        if not res["ok"]:
            rc = 1
    if out_path:
        import jax

        from relativitypathtracer_tpu import __version__

        pathlib.Path(out_path).write_text(json.dumps({
            "resolution": "1024x768",
            "max_frac_bad": MAX_FRAC_BAD,
            "platform": jax.default_backend(),
            "version": __version__,
            "scenes": results,
            "ok": rc == 0,
        }, indent=1))
        print(f"wrote {out_path}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
