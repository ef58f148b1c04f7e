"""Headless renderer CLI.

The reference is GLUT-interactive only; this provides the batch equivalent
(SURVEY.md section 7 step 6): render N frames of a scene to PNG/GIF with
deterministic state, plus FPS/Mrays metrics.

Usage:
  python -m relativitypathtracer_tpu.cli --scene Scenes/bunny.txt \
      --size 1024x768 --frames 10 --out out.png [--gif out.gif] \
      [--time 2.0] [--velocity 0.5,0,0] [--interval -1|0] [--asset-root DIR]

Reads the scene DSL from --scene, or from stdin when --scene is '-'
(mirroring the reference's stdin pipeline, /root/reference/README.md:4-7).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    assert len(parts) == 3
    return np.array(parts, np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="relativitypathtracer_tpu")
    ap.add_argument("--scene", required=True, help="scene DSL file, or '-' for stdin")
    ap.add_argument("--asset-root", default=None, help="base dir for scene asset paths")
    ap.add_argument("--size", default="960x540", help="WxH (default 960x540)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--time", type=float, default=0.0, help="scene start time (s)")
    ap.add_argument("--dt", type=float, default=1.0 / 30.0, help="per-frame time step (s)")
    ap.add_argument("--velocity", default="0,0,0", help="camera 3-velocity (units of c)")
    ap.add_argument("--interval", type=int, default=None, choices=(-1, 0),
                    help="override light-propagation interval")
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--out", default=None, help="output PNG (last frame)")
    ap.add_argument("--gif", default=None, help="output animated GIF (all frames)")
    ap.add_argument("--paused", action="store_true", help="do not advance scene time")
    ap.add_argument("--metrics", action="store_true", help="print per-frame timing JSON")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the frame loop into DIR")
    ap.add_argument("--platform", default=None, help="force a jax platform (cpu/gpu)")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error(f"--frames must be >= 1 (got {args.frames})")
    if args.gif and args.dt <= 0:
        ap.error(f"--gif needs --dt > 0 for its frame rate (got {args.dt})")

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.jaxcache import enable as _enable_cache

    _enable_cache()  # repeat compiles across processes hit disk, not XLA
    import jax.numpy as jnp

    from . import FrameState, build_render_fn, build_scene, load_scene_file, parse_scene
    from .utils.image import write_gif, write_png

    # Tolerant parse, like the reference app: malformed commands warn on
    # stderr and parsing continues (Render.cpp:227-259); asset failures and
    # index checks still abort (with a clean message, not a traceback).
    from .models.dsl import SceneError
    from .models.obj_loader import ObjError
    from .models.texture import TextureError

    try:
        if args.scene == "-":
            host = parse_scene(sys.stdin.read(), args.asset_root or ".", strict=False)
        else:
            host = load_scene_file(args.scene, args.asset_root, strict=False)
    except (SceneError, ObjError, TextureError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    scene, meta = build_scene(host)

    width, height = _parse_size(args.size)
    interval = meta.default_interval if args.interval is None else args.interval
    render = build_render_fn(meta, width, height, int(interval), args.msaa)

    vel = jnp.asarray(_parse_vec3(args.velocity))
    t = args.time
    frames = []
    timings = []
    img = None
    profiler_ctx = None
    if args.profile:
        profiler_ctx = jax.profiler.trace(args.profile)
        profiler_ctx.__enter__()
    for i in range(args.frames):
        state = FrameState(cam_velocity=vel, cam_pos=jnp.array([t, 0, 0, 0], jnp.float32))
        t0 = time.perf_counter()
        img = render(scene, state)
        img.block_until_ready()
        dt_ms = (time.perf_counter() - t0) * 1e3
        timings.append(dt_ms)
        if args.gif:
            frames.append(np.asarray(img))
        if not args.paused:
            t += args.dt

    if profiler_ctx is not None:
        profiler_ctx.__exit__(None, None, None)
    if args.out and img is not None:
        write_png(args.out, np.asarray(img))
    if args.gif and frames:
        write_gif(args.gif, frames, fps=1.0 / args.dt)

    if args.metrics:
        timings_sorted = sorted(timings)
        p50 = timings_sorted[len(timings_sorted) // 2]
        print(json.dumps({
            "width": width, "height": height, "frames": args.frames,
            "first_ms": timings[0], "p50_ms": p50,
            "best_ms": min(timings),
            "primary_rays": width * height * args.msaa * args.msaa,
            "mrays_per_sec_p50": width * height * args.msaa * args.msaa / (p50 * 1e3),
            "platform": jax.default_backend(),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
