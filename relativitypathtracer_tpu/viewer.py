"""Interactive live viewer: the equivalent here of the reference's
GLUT presentation layer (/root/reference/gl_interop.cpp:10-72,
/root/reference/Render.cpp:25-87,100-119).

The reference opens a 960x540 GLUT window, redraws on a 15 ms timer, and
mutates camera state from key callbacks (wasdqe move, r reset, space pause,
i interval toggle). Here the same interaction surface is split device-first:

- ViewerCore: frontend-agnostic loop state. Owns the compiled renderer(s)
  and the pure SimState; `frame(keys, now_s)` steps the state exactly like
  the reference's render() callback (frame_ms from a wall clock,
  Render.cpp:89-98) and returns a display-ready top-down uint8 frame.
  The live renderer is resolution-POLYMORPHIC (render.build_viewer_render_fn:
  camera dirs are a traced argument over a static padded grid), so a resize
  is a host-side dirs recompute (~ms) instead of a fresh compile -- the
  answer here to the reference's instant VBO re-allocation
  (Render.cpp:100-119). The 'i' interval toggle swaps between renderers
  preloaded at startup. stream_scale > 1 fetches a device-downsampled frame
  (bytes / scale^2), the wall-fps lever when the image fetch dominates the
  loop.
- run_window(): a pygame window frontend (needs a display).
- run_web(): a zero-dependency localhost MJPEG streamer (stdlib http.server
  + PIL JPEG) with browser key capture -- the headless fallback, so the
  viewer degrades gracefully where no display exists.

Usage:
  python -m relativitypathtracer_tpu.viewer --scene Scenes/cube.txt
      [--size 960x540] [--frontend auto|window|web] [--port 8734]
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time

import numpy as np

# Key order matches utils.framestate.KEY_* (w a s d q e r space i), which in
# turn matches the reference's downKeys[9] (Render.cpp:9,25-86).
KEY_CHARS = "wasdqer i"

MIN_FRAME_S = 0.015  # the reference's 15 ms redisplay timer (gl_interop.cpp:69-72)


class ViewerCore:
    """Frontend-agnostic interactive loop: compiled renderer + SimState.

    Pure with respect to inputs: the frame produced depends only on the
    scene file and the (keys, timestamp) sequence fed to frame(), which is
    what makes viewer sessions reproducible (SURVEY.md section 5 checkpoint
    story). All times are seconds.
    """

    def __init__(self, host_scene, width: int, height: int, msaa: int = 1,
                 stream_scale: int = 1):
        from .models.scene import build_scene
        from .utils.framestate import SimState

        self.scene, self.meta = build_scene(host_scene)
        self.msaa = int(msaa)
        self.stream_scale = int(stream_scale)
        # msaa=1 (the interactive default) uses the resolution-POLYMORPHIC
        # renderer: camera dirs are a traced argument over a static padded
        # grid, so a resize recomputes dirs on the host (~ms) instead of
        # recompiling.
        # msaa>1 keeps the per-size compiled path.
        self._poly = self.msaa == 1
        if self.stream_scale > 1 and not self._poly:
            # Device-side stream pooling only exists on the polymorphic
            # path; silently serving full-size frames while /stats reports
            # a stream_scale would lie about the fetch size.
            raise ValueError("stream_scale > 1 requires msaa == 1")
        self.width, self.height = self._snap(width), self._snap(height)
        self.sim = SimState.initial(self.meta.default_interval)
        self._prev_t: float | None = None
        self.compiling = False  # surfaced in stats while a renderer builds
        self.fps = 0.0  # EMA, like the reference's commented-out readout
        self.frame_count = 0  # monotone; lets clients count real frames
        self._pending = None  # one-frame device pipeline (see frame())
        self._pending_resize = None  # set by request_resize, applied in frame()
        self._warmed: set = set()
        if self._poly:
            from .render import TILE, _round_up, viewer_dirs

            self._pad = (_round_up(self.height, TILE),
                         _round_up(self.width, TILE))
            self._dirs = viewer_dirs(self.width, self.height, *self._pad)
        # Warm the whole interactive path now, not on first use: jit compiles
        # on first CALL. Un-warmed, the first keypress stalls the loop for
        # seconds while stats keep serving
        # pre-stall values -- confusing in a live viewer. step() itself is
        # host-side numpy and needs no warming; exercising its branches here
        # just produces a realistic moved state for the warm render below.
        # Keys order: w a s d q e r space i.
        self._get_render(self.sim.interval)
        if self._poly:
            # Preload the 'i' toggle's interval cycle (default -> 0 -> -1 ->
            # 0 ...; utils.framestate.step) so the toggle never stalls the
            # loop either: with resize already compile-free, the interval
            # pair is the whole remaining (size, interval) preload matrix.
            for iv in (0, -1):
                if iv != int(self.sim.interval):
                    self._get_render(iv)
        from .utils.framestate import step

        warm = step(self.sim, [False] * 7 + [True, False], 16.0)
        warm = step(warm, [True] + [False] * 8, 16.0)  # single key: real dv
        step(warm, [False] * 6 + [True, False, False], 16.0)
        # ...and render once with a stepped state: its fields are eager jax
        # arrays (vs the initial numpy ones), so this absorbs any avals-
        # difference recompile that would otherwise hit the first keypress.
        self._render_dev(self._get_render(self.sim.interval),
                         warm.frame).block_until_ready()

    def _snap(self, v: int) -> int:
        """Round a logical dimension DOWN to a stream_scale multiple: a
        ragged final pooled row/column would box-filter off-sensor padding
        pixels into the displayed frame."""
        s = self.stream_scale
        return max((int(v) // s) * s, s)

    def _render_dev(self, render, frame_state):
        """Dispatch one device frame with the current camera dirs."""
        if self._poly:
            return render(self.scene, frame_state, self._dirs)
        return render(self.scene, frame_state)

    def _get_render(self, interval: int):
        if self._poly:
            from .render import build_viewer_render_fn

            render = build_viewer_render_fn(self.meta, *self._pad,
                                            int(interval), self.stream_scale)
            key = (self._pad, int(interval), self.stream_scale)
        else:
            from .render import build_render_fn

            # lru-cached by (meta, w, h, interval, msaa): each configuration
            # compiles once; toggling 'i' or resizing swaps cached fns.
            # out_uint8: pack on device -- the per-frame fetch is 1.5 MB
            # instead of 6 MB of f32.
            render = build_render_fn(self.meta, self.width, self.height,
                                     int(interval), self.msaa, out_uint8=True)
            key = (self.width, self.height, int(interval), self.msaa)
        if key not in self._warmed:
            # jit compiles on first call, not at build: force it here so the
            # `compiling` flag around resize/'i' toggles tells the truth and
            # the live loop never hides a multi-second stall.
            self.compiling = True
            try:
                self._render_dev(render, self.sim.frame).block_until_ready()
                self._warmed.add(key)
            finally:
                self.compiling = False
        return render

    def resize(self, width: int, height: int) -> None:
        """Swap the render resolution (the live analog of the reference's
        VBO re-alloc, Render.cpp:100-119). On the polymorphic path this is
        compile-free for any size fitting the padded grid: recompute the
        camera dirs on the host and device_put (~ms). Growing past the pad
        (or the msaa>1 path) compiles once for the new configuration.
        Call ONLY from the render-loop thread (it touches the device);
        frontend threads use request_resize instead."""
        width, height = self._snap(width), self._snap(height)
        if (width, height) == (self.width, self.height) or width < 32 or height < 32:
            return
        self.width, self.height = width, height
        if self._poly:
            from .render import TILE, _round_up, viewer_dirs

            ph, pw = _round_up(height, TILE), _round_up(width, TILE)
            if ph > self._pad[0] or pw > self._pad[1]:
                # grow the pad (never shrink: keep smaller sizes compile-free)
                self._pad = (max(ph, self._pad[0]), max(pw, self._pad[1]))
            self._dirs = viewer_dirs(width, height, *self._pad)
        self._get_render(self.sim.interval)

    def request_resize(self, width: int, height: int) -> None:
        """Thread-safe resize request: stores the target size (one atomic
        tuple write); frame() applies it on the render-loop thread. A
        frontend thread calling resize() directly would issue a compile +
        device render concurrently with the frame loop -- the concurrent
        device access documented below as unsafe."""
        self._pending_resize = (int(width), int(height))

    def frame(self, keys_down, now_s: float | None = None) -> np.ndarray:
        """Advance one frame and render it.

        keys_down: iterable of chars from KEY_CHARS currently held.
        Returns (H, W, 3) uint8, top-down (display order).

        The device pipeline is one frame deep: jax dispatch is async, so the
        NEW frame's kernels run while the PREVIOUS frame's bytes stream back
        to the host, overlapping the fetch with compute. The
        displayed image therefore lags the sim state by one frame (~15 ms at
        the reference cadence); sim state itself (and /stats) is always
        current.
        """
        from .utils.framestate import step

        if now_s is None:
            now_s = time.perf_counter()
        frame_ms = 0.0 if self._prev_t is None else max(0.0, (now_s - self._prev_t) * 1e3)
        self._prev_t = now_s

        keys = [c in keys_down for c in KEY_CHARS]
        self.sim = step(self.sim, keys, frame_ms)
        pr = self._pending_resize
        if pr is not None:
            self._pending_resize = None
            self.resize(*pr)
        render = self._get_render(self.sim.interval)  # compiles once per config
        t0 = time.perf_counter()
        img_dev = self._render_dev(render, self.sim.frame)  # async dispatch
        pending = self._pending
        if pending is None or pending.shape != img_dev.shape:
            pending = img_dev  # first frame / pad growth or 'i' swap: no overlap
        self._pending = img_dev
        img = pending
        img.block_until_ready()
        dt = time.perf_counter() - t0
        inst = 1.0 / max(dt, 1e-6)
        self.fps = inst if self.fps == 0.0 else 0.9 * self.fps + 0.1 * inst
        # Snapshot stats HERE, in the render thread: device-array fetches are
        # not safe to issue concurrently from frontend threads (they can
        # deadlock the frame loop), so stats() serves this host-side cache
        # instead of touching self.sim.
        vel = np.asarray(self.sim.frame.cam_velocity)
        self.frame_count += 1
        self._stats = {
            "fps": round(self.fps, 1),
            "frame": self.frame_count,
            "paused": bool(self.sim.paused),
            "interval": int(self.sim.interval),
            "speed_c": round(float(np.linalg.norm(vel)), 4),
            "time_s": round(float(np.asarray(self.sim.frame.cam_pos)[0]), 3),
            "size": [self.width, self.height],
            "stream_scale": self.stream_scale,
        }
        # renderer output is bottom-up (GL order) uint8; displays want
        # top-down. The polymorphic frame is padded (and pool-downsampled):
        # crop to the logical size before the flip.
        out = np.asarray(img)
        if self._poly:
            s = self.stream_scale
            out = out[:-(-self.height // s), :-(-self.width // s)]
        return out[::-1]

    def stats(self) -> dict:
        s = dict(getattr(self, "_stats", None) or {
            "fps": 0.0, "frame": 0, "paused": bool(self.sim.paused),
            "interval": int(self.sim.interval), "speed_c": 0.0,
            "time_s": 0.0, "size": [self.width, self.height],
            "stream_scale": self.stream_scale,
        })
        s["compiling"] = bool(self.compiling)
        return s


# ---------------------------------------------------------------------------
# pygame window frontend


def run_window(core: ViewerCore, max_frames: int | None = None) -> int:
    """Live window via pygame. Mirrors the reference's GLUT loop: continuous
    redisplay at >= 15 ms cadence, key-down/up tracking without auto-repeat
    (glutSetKeyRepeat(GLUT_KEY_REPEAT_OFF), gl_interop.cpp:27)."""
    import pygame

    pygame.display.init()
    pygame.display.set_caption("Relativistic Ray Tracer")
    screen = pygame.display.set_mode((core.width, core.height), pygame.RESIZABLE)
    pygame.key.set_repeat()  # no repeat: we track held state ourselves

    keymap = {
        pygame.K_w: "w", pygame.K_a: "a", pygame.K_s: "s", pygame.K_d: "d",
        pygame.K_q: "q", pygame.K_e: "e", pygame.K_r: "r",
        pygame.K_SPACE: " ", pygame.K_i: "i",
    }
    held: set[str] = set()
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            t0 = time.perf_counter()
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    return 0
                if ev.type == pygame.KEYDOWN and ev.key == pygame.K_ESCAPE:
                    return 0
                if ev.type == pygame.KEYDOWN and ev.key in keymap:
                    held.add(keymap[ev.key])
                elif ev.type == pygame.KEYUP and ev.key in keymap:
                    held.discard(keymap[ev.key])
                elif ev.type == pygame.VIDEORESIZE:
                    core.resize(ev.w, ev.h)
                    screen = pygame.display.set_mode((core.width, core.height),
                                                     pygame.RESIZABLE)
            img = core.frame(held)
            # pygame surfaces are (W, H) indexed; transpose the (H, W, 3) frame
            surf = pygame.surfarray.make_surface(img.transpose(1, 0, 2))
            if img.shape[:2] != (core.height, core.width):
                # stream_scale>1: the fetched frame is device-downsampled;
                # upscale for display (the fetch savings are the point)
                surf = pygame.transform.scale(surf, (core.width, core.height))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            s = core.stats()
            pygame.display.set_caption(
                f"Relativistic Ray Tracer — {s['fps']:.1f} fps, "
                f"v={s['speed_c']}c{' [PAUSED]' if s['paused'] else ''}")
            frames += 1
            leftover = MIN_FRAME_S - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    finally:
        pygame.display.quit()
    return 0


# ---------------------------------------------------------------------------
# web (MJPEG) frontend — headless-friendly, stdlib only

_PAGE = """<!doctype html>
<html><head><title>Relativistic Ray Tracer</title><style>
 body { background:#111; color:#ddd; font:14px monospace; margin:0; text-align:center }
 #hud { padding:6px }
 img { image-rendering:pixelated; outline:none }
</style></head><body>
<div id="hud">connecting…</div>
<img id="view" src="/stream" tabindex="0">
<div id="hud2">keys: w/a/s/d/q/e move &nbsp; r reset velocity &nbsp; space pause &nbsp; i interval toggle</div>
<script>
const KEYS = new Set(['w','a','s','d','q','e','r',' ','i']);
function send(c, d) {
  fetch('/key?c=' + encodeURIComponent(c) + '&d=' + d, {method:'POST'});
}
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (KEYS.has(k)) { e.preventDefault(); if (!e.repeat) send(k, 1); }
});
window.addEventListener('keyup', e => {
  const k = e.key.toLowerCase();
  if (KEYS.has(k)) { e.preventDefault(); send(k, 0); }
});
window.addEventListener('blur', () => send('*', 0));  // drop all held keys
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('hud').textContent =
      s.fps.toFixed(1) + ' fps | v = ' + s.speed_c + 'c | t = ' + s.time_s +
      's | interval ' + s.interval + (s.paused ? ' | PAUSED' : '') +
      (s.compiling ? ' | COMPILING…' : '');
    // stream_scale>1 sends device-downsampled frames: display at logical size
    const v = document.getElementById('view');
    v.style.width = s.size[0] + 'px'; v.style.height = s.size[1] + 'px';
  } catch (e) {}
}, 500);
</script></body></html>
"""


class _WebViewer:
    """Render loop + shared state behind the HTTP handlers."""

    def __init__(self, core: ViewerCore, jpeg_quality: int = 85):
        self.core = core
        self.quality = int(jpeg_quality)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.held: set[str] = set()
        self.jpeg: bytes | None = None
        self.seq = 0
        self.stop = threading.Event()

    def set_key(self, c: str, down: bool) -> None:
        with self.lock:
            if c == "*":
                self.held.clear()
            elif down:
                self.held.add(c)
            else:
                self.held.discard(c)

    def render_loop(self, max_frames: int | None = None) -> None:
        from PIL import Image

        frames = 0
        while not self.stop.is_set() and (max_frames is None or frames < max_frames):
            t0 = time.perf_counter()
            with self.lock:
                held = set(self.held)
            img = self.core.frame(held)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=self.quality)
            with self.cond:
                self.jpeg = buf.getvalue()
                self.seq += 1
                self.cond.notify_all()
            frames += 1
            leftover = MIN_FRAME_S - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
        with self.cond:  # release any stream readers blocked on a new frame
            self.cond.notify_all()

    def wait_frame(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists; returns (jpeg, seq)."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.jpeg is None or self.seq == last_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self.stop.is_set():
                    break
                self.cond.wait(remaining)
            return self.jpeg, self.seq


def _make_handler(wv: _WebViewer):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html; charset=utf-8", _PAGE.encode())
            elif url.path == "/stats":
                self._send(200, "application/json", json.dumps(wv.core.stats()).encode())
            elif url.path == "/frame":
                jpeg, _ = wv.wait_frame(-1)
                if jpeg is None:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/jpeg", jpeg)
            elif url.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seq = -1
                try:
                    while not wv.stop.is_set():
                        jpeg, seq = wv.wait_frame(seq)
                        if jpeg is None:
                            continue
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                         b"Content-Length: " + str(len(jpeg)).encode()
                                         + b"\r\n\r\n" + jpeg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/key":
                q = parse_qs(url.query)
                c = q.get("c", [""])[0]
                down = q.get("d", ["0"])[0] == "1"
                if c == "*" or c in KEY_CHARS:
                    wv.set_key(c, down)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/resize":
                q = parse_qs(url.query)
                try:
                    w = int(q.get("w", ["0"])[0])
                    h = int(q.get("h", ["0"])[0])
                    wv.core.request_resize(w, h)
                    self._send(200, "text/plain", b"ok")
                except ValueError:
                    self._send(400, "text/plain", b"bad size")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def run_web(core: ViewerCore, port: int = 8734, max_frames: int | None = None,
            on_ready=None, stop_event: threading.Event | None = None) -> int:
    """Serve the viewer at http://localhost:<port>/ (MJPEG stream + key
    capture). Blocks until the render loop ends (max_frames / stop_event)
    or Ctrl-C. on_ready, if given, is called with the bound port (which
    matters for port=0)."""
    from http.server import ThreadingHTTPServer

    wv = _WebViewer(core)
    if stop_event is not None:
        wv.stop = stop_event
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(wv))
    httpd.daemon_threads = True
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    bound = httpd.server_address[1]
    print(f"viewer: http://127.0.0.1:{bound}/  "
          "(w/a/s/d/q/e move, r reset, space pause, i interval, Ctrl-C quit)",
          flush=True)
    if on_ready is not None:
        on_ready(bound)
    try:
        wv.render_loop(max_frames)
    except KeyboardInterrupt:
        pass
    finally:
        wv.stop.set()
        httpd.shutdown()
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="relativitypathtracer_tpu.viewer")
    ap.add_argument("--scene", required=True, help="scene DSL file, or '-' for stdin")
    ap.add_argument("--asset-root", default=None)
    ap.add_argument("--size", default="960x540",
                    help="WxH (default 960x540, the reference's window size)")
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--stream-scale", type=int, default=1, choices=(1, 2, 4),
                    help="device-side downsample of the fetched frame: the "
                         "per-frame device->host bytes shrink by scale^2 "
                         "(the wall-fps lever when the fetch dominates); the display "
                         "upscales to the logical size")
    ap.add_argument("--frontend", default="auto", choices=("auto", "window", "web"))
    ap.add_argument("--port", type=int, default=8734, help="web frontend port")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="stop after N frames (smoke testing)")
    ap.add_argument("--platform", default=None, help="force a jax platform (cpu/gpu)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.jaxcache import enable as _enable_cache

    _enable_cache()  # repeat compiles across processes hit disk, not XLA

    from .models.dsl import SceneError, load_scene_file, parse_scene
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

    from .cli import _parse_size

    try:
        w, h = _parse_size(args.size)
    except ValueError:
        print(f"Error: bad --size {args.size!r} (expected WxH)", file=sys.stderr)
        return 1
    print(f"compiling renderer ({w}x{h})…", flush=True)
    core = ViewerCore(host, w, h, args.msaa, stream_scale=args.stream_scale)

    if args.frontend in ("auto", "window"):
        # Fall back to the web frontend ONLY when the display itself cannot
        # initialize; a mid-session render error must surface as the real
        # failure, not be masked as "no display" and silently re-run on the
        # same failing path in the web server.
        try:
            import pygame

            pygame.display.init()
        except Exception as e:  # noqa: BLE001 - headless envs raise varied types
            if args.frontend == "window":
                print(f"Error: window frontend failed: {e}", file=sys.stderr)
                return 1
            print(f"no display ({e.__class__.__name__}); falling back to web viewer",
                  flush=True)
        else:
            return run_window(core, args.max_frames)
    return run_web(core, args.port, args.max_frames)


if __name__ == "__main__":
    sys.exit(main())
