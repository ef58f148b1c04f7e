"""Export the frame renderer as a portable AOT artifact (utils/aot.py).

Serving workflow: export once on any host (no GPU needed -- lowering is
cross-platform), ship the artifact, then on the serving host:

    from relativitypathtracer_tpu.utils.aot import load_render
    render = load_render(open("renderer.jaxexport", "rb").read())
    img = render(scene, state)   # scene/state are arguments, not constants

Usage:
  python tools/export_renderer.py [--scene SCENE.txt] \
      --size 1024x768 --platforms cuda --out renderer.jaxexport
      [--msaa N] [--kernels real|jnp] [--selfcheck]

Without --scene the in-repository flagship scene (utils.demo_scenes) is
exported. --kernels real (default) routes the Triton mesh walks (runs only
on a GPU); jnp exports the scan route (runs anywhere, useful for a
cpu-executable artifact). --selfcheck deserializes the artifact and, when
this host can execute it, renders one frame and diffs against the live
renderer.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None)
    ap.add_argument("--size", default="1024x768")
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--platforms", default="cuda",
                    help="comma list, e.g. cuda or cuda,cpu")
    ap.add_argument("--kernels", choices=("real", "jnp"), default="real")
    ap.add_argument("--out", required=True)
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--platform", default=os.environ.get("RPT_PLATFORM"),
                    help="pin THIS process's jax backend (e.g. cpu)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from relativitypathtracer_tpu import FrameState, build_scene, load_scene_file
    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.utils.aot import export_render, load_render

    W, H = (int(x) for x in args.size.lower().split("x"))
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    if args.scene:
        scene, meta = build_scene(load_scene_file(args.scene))
    else:
        from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene

        scene, meta = flagship_scene()

    mesh_intersect.PALLAS_MODE = True if args.kernels == "real" else False
    try:
        data = export_render(scene, meta, W, H, msaa=args.msaa,
                             platforms=platforms)
    finally:
        mesh_intersect.PALLAS_MODE = None
    pathlib.Path(args.out).write_bytes(data)
    print(f"wrote {args.out}: {len(data)} bytes, platforms {platforms}, "
          f"{W}x{H} msaa={args.msaa} kernels={args.kernels}")

    if args.selfcheck:
        import numpy as np

        render = load_render(data)
        backend = jax.default_backend()
        if backend not in platforms:
            print(f"selfcheck: host backend {backend!r} not in {platforms}; "
                  "deserialize-only check passed")
            return 0
        out = np.asarray(render(scene, FrameState.initial()))
        from relativitypathtracer_tpu import render_frame

        mesh_intersect.PALLAS_MODE = True if args.kernels == "real" else False
        try:
            ref = np.asarray(render_frame(scene, meta, FrameState.initial(),
                                          W, H, msaa=args.msaa))
        finally:
            mesh_intersect.PALLAS_MODE = None
        diff = float(np.abs(out - ref).max())
        print(f"selfcheck: max |artifact - live| = {diff:g}")
        if diff != 0.0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
