"""Live-interactivity benchmark: drive the web viewer over real HTTP.

The reference is an interactive application -- fly-the-camera key handling
inside a 15 ms GLUT redisplay loop (/root/reference/Render.cpp:89-209,
/root/reference/gl_interop.cpp:69-72). This tool proves our equivalent works
against the real backend: it starts viewer.run_web() (the production MJPEG
frontend, real HTTP server), then acts as a scripted browser -- POSTing
/key events on a deterministic timeline, polling /stats, and pulling /frame
JPEGs -- and records:

  - sustained fps (idle and while flying with 'w' held),
  - key -> observable-state latency (space pause flip, w velocity change),
  - a GIF of the session (the visual artifact).

Writes INTERACT_r{NN}.json + interact_r{NN}.gif at the repo root.
Usage: python tools/interact_bench.py [--scene bunny] [--size 960x540]
       [--platform cpu] [--round 04] [--frames 400]
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import sys
import threading
import time
import urllib.request

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _post(port, path):
    urllib.request.urlopen(
        urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST"),
        timeout=5).read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return json.loads(r.read())


def _get_frame(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame", timeout=10) as r:
        return r.read()


def _await_stats(port, pred, timeout_s=5.0, poll_s=0.002):
    """Poll /stats until pred(stats) holds; returns elapsed seconds."""
    t0 = time.perf_counter()
    while True:
        if pred(_get_json(port, "/stats")):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError("stats predicate never held")
        time.sleep(poll_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--size", default="960x540",
                    help="the reference's default window size")
    ap.add_argument("--frames", type=int, default=None,
                    help="cap render-loop frames (default: until script ends)")
    ap.add_argument("--window", type=float, default=3.0,
                    help="seconds per fps measurement segment")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--round", dest="round_tag", default="04")
    ap.add_argument("--stream-scale", type=int, default=1, choices=(1, 2, 4),
                    help="device-side downsample of the fetched frame "
                         "(bytes / scale^2)")
    ap.add_argument("--suffix", default="",
                    help="artifact name suffix (e.g. _s2 for a stream-scale "
                         "variant, so two protocol runs don't overwrite)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from relativitypathtracer_tpu.utils.jaxcache import enable as _enable_cache

    _enable_cache()

    from relativitypathtracer_tpu.models.dsl import load_scene_file
    from relativitypathtracer_tpu.viewer import ViewerCore, run_web

    ref = pathlib.Path("/root/reference/Scenes") / f"{args.scene}.txt"
    w, h = (int(x) for x in args.size.lower().split("x"))
    print(f"compiling viewer core {w}x{h} ({args.scene}) ...", flush=True)
    core = ViewerCore(load_scene_file(str(ref)), w, h,
                      stream_scale=args.stream_scale)

    # Device-side sustained fps: the renderer alone (utils.timing),
    # decoupled from the HTTP image fetch: what cadence the RENDERER
    # sustains at the reference's window size.
    from relativitypathtracer_tpu.utils.timing import frame_times_ms, percentile

    rd = core._get_render(core.sim.interval)
    if core._poly:
        dev_fn = (lambda sc, st: rd(sc, st, core._dirs))
    else:
        dev_fn = rd
    device_ms = percentile(frame_times_ms(dev_fn, core.scene, core.sim.frame,
                                          frames=36)[0], 50)

    ready = threading.Event()
    port_box = {}
    stop = threading.Event()

    def on_ready(p):
        port_box["port"] = p
        ready.set()

    server = threading.Thread(
        target=run_web,
        args=(core,), kwargs=dict(port=0, max_frames=args.frames,
                                  on_ready=on_ready, stop_event=stop),
        daemon=True)
    server.start()
    assert ready.wait(60), "web viewer never came up"
    port = port_box["port"]
    print(f"viewer live on :{port}", flush=True)

    gif_frames = []
    result = {"scene": args.scene, "size": [w, h],
              "platform": jax.default_backend()}
    try:
        # -- settle: a few frames so the fps EMA reflects steady state
        time.sleep(1.0)

        # -- sustained idle fps over ~3 s (count real frames via the viewer's
        # monotone frame counter, not the EMA)
        t0 = time.perf_counter()
        n0 = _count_frames(port, args.window, gif_frames)
        idle_fps = n0 / (time.perf_counter() - t0)

        # -- key->state latency: space pauses the sim (stats.paused flips)
        lat_space = []
        for _ in range(5):
            paused = _get_json(port, "/stats")["paused"]
            _post(port, "/key?c=%20&d=1")
            dt = _await_stats(port, lambda s: s["paused"] != paused)
            _post(port, "/key?c=%20&d=0")
            lat_space.append(dt * 1e3)
            time.sleep(0.15)
        # leave unpaused for the flight segment
        if _get_json(port, "/stats")["paused"]:
            _post(port, "/key?c=%20&d=1")
            _await_stats(port, lambda s: not s["paused"])
            _post(port, "/key?c=%20&d=0")

        # -- key->state latency: 'w' accelerates (stats.speed_c leaves 0)
        _post(port, "/key?c=r&d=1")  # reset velocity first
        _await_stats(port, lambda s: s["speed_c"] == 0.0)
        _post(port, "/key?c=r&d=0")
        _post(port, "/key?c=w&d=1")
        lat_w = _await_stats(port, lambda s: s["speed_c"] > 0.0) * 1e3

        # -- flying fps: hold w while grabbing GIF frames
        t0 = time.perf_counter()
        n1 = _count_frames(port, args.window, gif_frames)
        fly_fps = n1 / (time.perf_counter() - t0)
        _post(port, "/key?c=w&d=0")
        _post(port, "/key?c=r&d=1"); _post(port, "/key?c=r&d=0")

        # -- live resize latency (the reference's VBO re-alloc analog,
        # Render.cpp:100-119): request a smaller surface over HTTP, time
        # until /stats reports it. With the polymorphic renderer a
        # shrink is compile-free (host dirs recompute, ~ms); growing past
        # the padded grid is the one remaining compile and is recorded
        # separately as the honest worst case.
        w2, h2 = max(w // 2, 64), max(h // 2, 64)
        _post(port, f"/resize?w={w2}&h={h2}")
        lat_resize = _await_stats(
            port, lambda s: s["size"] == [w2, h2], timeout_s=240) * 1e3
        _post(port, f"/resize?w={w}&h={h}")
        _await_stats(port, lambda s: s["size"] == [w, h], timeout_s=240)
        w3, h3 = w + 64, h + 64  # past the pad: compiles a grown grid
        _post(port, f"/resize?w={w3}&h={h3}")
        lat_grow = _await_stats(
            port, lambda s: s["size"] == [w3, h3], timeout_s=240) * 1e3
        _post(port, f"/resize?w={w}&h={h}")  # back: within pad, instant
        _await_stats(port, lambda s: s["size"] == [w, h], timeout_s=240)

        result.update({
            "idle_fps": round(idle_fps, 2),
            "flying_fps": round(fly_fps, 2),
            "device_frame_ms": round(device_ms, 3),
            "device_fps": round(1e3 / device_ms, 1),
            "stream_scale": args.stream_scale,
            "key_latency_ms_space_p50": round(sorted(lat_space)[2], 2),
            "key_latency_ms_space_all": [round(x, 2) for x in lat_space],
            "key_latency_ms_w": round(lat_w, 2),
            "resize_latency_ms_first": round(lat_resize, 2),
            "resize_latency_ms_grow_pad": round(lat_grow, 2),
            "frames_counted": n0 + n1,
            "cadence_cap_fps": round(1.0 / 0.015, 1),
        })
    finally:
        stop.set()
        server.join(timeout=30)

    tag = args.round_tag + args.suffix
    out_json = REPO / f"INTERACT_r{tag}.json"
    out_json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)

    if gif_frames:
        from PIL import Image

        imgs = [Image.open(io.BytesIO(b)).convert("P") for b in gif_frames]
        gif = REPO / f"interact_r{tag}.gif"
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=120, loop=0)
        print(f"wrote {gif} ({len(imgs)} frames)", flush=True)
    print(f"wrote {out_json}", flush=True)
    return 0


def _count_frames(port, seconds, gif_frames, gif_samples=12):
    """Count frames rendered over a window via the viewer's monotone frame
    counter (stats["frame"]), sampling a few JPEGs for the session GIF."""
    start = _get_json(port, "/stats")["frame"]
    deadline = time.perf_counter() + seconds
    next_gif = 0.0
    while time.perf_counter() < deadline:
        now = time.perf_counter()
        if now >= next_gif:
            gif_frames.append(_get_frame(port))
            next_gif = now + seconds / gif_samples
        time.sleep(0.02)
    return _get_json(port, "/stats")["frame"] - start


if __name__ == "__main__":
    sys.exit(main())
