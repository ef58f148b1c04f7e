"""Minimal full-frame timing: one scene, one compiled renderer, per-frame
wall times ended by block_until_ready (shared protocol: utils/timing.py).
Usage: python tools/frametime.py [scene] [WxH] [frames] [msaa]

scene: "flagship" (default, utils.demo_scenes) or the name of a reference
scene under $REF_ASSETS/Scenes.
"""

from __future__ import annotations

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
REF = pathlib.Path(os.environ.get("REF_ASSETS", "/root/reference"))

if __name__ == "__main__":
    import jax

    if os.environ.get("RPT_PLATFORM"):  # e.g. RPT_PLATFORM=cpu for a smoke run
        jax.config.update("jax_platforms", os.environ["RPT_PLATFORM"])

    from relativitypathtracer_tpu import build_scene, load_scene_file
    from relativitypathtracer_tpu.render import FrameState, build_render_fn
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene
    from relativitypathtracer_tpu.utils.jaxcache import enable as _enable_cache
    from relativitypathtracer_tpu.utils.timing import frame_times_ms, percentile

    _enable_cache()
    name = sys.argv[1] if len(sys.argv) > 1 else "flagship"
    size = sys.argv[2] if len(sys.argv) > 2 else "1024x768"
    frames = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    msaa = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    W, H = (int(x) for x in size.split("x"))
    if name == "flagship":
        scene, meta = flagship_scene()
    else:
        scene, meta = build_scene(load_scene_file(str(REF / "Scenes" / f"{name}.txt")))
    render = build_render_fn(meta, W, H, meta.default_interval, msaa)
    times, compile_s, _ = frame_times_ms(render, scene, FrameState.initial(),
                                         frames=frames)
    print(f"scene={name} {W}x{H} msaa={msaa} device={jax.devices()[0].device_kind} "
          f"compile={compile_s:.1f}s", file=sys.stderr)
    print(f"p50 {percentile(times, 50):.3f} ms/frame, p95 "
          f"{percentile(times, 95):.3f} over {frames} frames")
