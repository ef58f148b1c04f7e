"""Large-mesh capability demo: the flagship scene with its mesh subdivided.

Three midpoint subdivisions (utils.subdiv) take the flagship mesh
(utils.demo_scenes) from 5,120 to 327,680 triangles without changing its
surface; the scene goes through the normal loader, octree and Morton
order, and the renderer walks it with the same Triton kernels as the small
mesh (their constants are read from global memory at any size).

The reference reaches this scale through its depth-6 octree
(/root/reference/Octree.cpp:171-248); the oracle (native/cpu_reference)
implements that same algorithm, so the parity check validates the large
mesh end-to-end at production resolution.

    python -m relativitypathtracer_tpu.utils.largedemo [--levels N] [--seed N]
"""

from __future__ import annotations

import subprocess
import tempfile

import numpy as np

LEVELS = 3  # 5,120 * 4^3 = 327,680 triangles


def large_parity_and_time(width: int = 1024, height: int = 768,
                          frames: int = 20, levels: int = LEVELS,
                          seed: int = 0) -> dict:
    """Render the subdivided flagship scene on the live backend: per-frame
    time (p50, block_until_ready) + full-res parity vs the C++ oracle."""
    import time

    import jax

    from relativitypathtracer_tpu.render import FrameState, build_render_fn
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene
    from relativitypathtracer_tpu.utils.parity import MAX_FRAC_BAD, _ensure_oracle
    from relativitypathtracer_tpu.utils.scene_blob import write_scene_blob
    from relativitypathtracer_tpu.utils.timing import frame_times_ms, percentile

    t0 = time.perf_counter()
    _ensure_oracle()  # also builds the native octree builder
    scene, meta = flagship_scene(seed, levels)
    build_s = time.perf_counter() - t0
    state = FrameState.initial()
    render = build_render_fn(meta, width, height, meta.default_interval, 1)
    times, compile_s, img = frame_times_ms(render, scene, state, frames=frames)

    with tempfile.TemporaryDirectory() as tmp:
        blob, out = f"{tmp}/large.blob", f"{tmp}/large.rgb"
        write_scene_blob(blob, scene, meta, state, width, height)
        subprocess.run([_ensure_oracle(), blob, out], check=True,
                       capture_output=True)
        ref = np.fromfile(out, np.float32).reshape(height, width, 3)
    diff = np.abs(ref - np.asarray(img))
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    return {
        "tris": meta.num_tris,
        "device_kind": jax.devices()[0].device_kind,
        "scene_build_s": round(build_s, 1),
        "compile_s": round(compile_s, 1),
        "frame_ms": percentile(times, 50),
        "frame_ms_p95": percentile(times, 95),
        "frac_bad": frac_bad,
        "ok": bool(frac_bad <= MAX_FRAC_BAD),
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description="subdivided flagship mesh")
    ap.add_argument("--levels", type=int, default=LEVELS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from relativitypathtracer_tpu.utils.jaxcache import enable

    enable()
    print(json.dumps(large_parity_and_time(levels=args.levels, seed=args.seed)))
