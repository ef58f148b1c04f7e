"""Interactive viewer tests: ViewerCore semantics (matching the reference's
key behavior, /root/reference/Render.cpp:120-209) and the headless web
frontend end-to-end over HTTP."""

import json
import time
import threading
import urllib.request

import numpy as np
import pytest

# Tiny asset-free scene: a sphere light plus a colored cube.
SCENE = """
Os
 p0,3,6,0,0,1,0,0.3,0.3,0.3
 c1,1,1
 l1
Oc
 p0,-1,5,0,0,1,0,1,1,1
 c0.8,0.2,0.2
A0.3
W2,2,2
R
"""


@pytest.fixture(scope="module")
def core():
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore

    return ViewerCore(parse_scene(SCENE), 64, 48)


def _speed(core):
    return float(np.linalg.norm(np.asarray(core.sim.frame.cam_velocity)))


def test_frame_shape_and_paused_start(core):
    img = core.frame(set(), now_s=0.0)
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    assert img.max() > 0  # the lit cube is visible
    assert core.sim.paused  # scenes start paused (Render.cpp:12)


def test_space_edge_toggles_pause(core):
    core.frame(set(), now_s=1.000)
    core.frame({" "}, now_s=1.016)
    assert not core.sim.paused
    core.frame({" "}, now_s=1.032)  # still held: no re-toggle (edge-detected)
    assert not core.sim.paused
    core.frame(set(), now_s=1.048)
    core.frame({" "}, now_s=1.064)
    assert core.sim.paused
    core.frame(set(), now_s=1.080)


def test_time_advances_only_unpaused(core):
    core.frame(set(), now_s=2.000)
    t0 = float(np.asarray(core.sim.frame.cam_pos)[0])
    core.frame(set(), now_s=2.100)
    assert float(np.asarray(core.sim.frame.cam_pos)[0]) == t0  # paused
    core.frame({" "}, now_s=2.116)  # unpause
    core.frame(set(), now_s=2.132)
    core.frame(set(), now_s=2.232)
    assert float(np.asarray(core.sim.frame.cam_pos)[0]) > t0
    core.frame({" "}, now_s=2.248)  # re-pause for later tests
    core.frame(set(), now_s=2.264)
    assert core.sim.paused


def test_wasd_accelerates_and_r_resets(core):
    core.frame(set(), now_s=3.000)
    v0 = _speed(core)
    core.frame({"w"}, now_s=3.016)
    assert _speed(core) > v0
    core.frame({"r"}, now_s=3.032)
    assert _speed(core) == 0.0


def test_resize_swaps_renderer(core):
    core.resize(96, 64)
    img = core.frame(set(), now_s=4.0)
    assert img.shape == (64, 96, 3)
    core.resize(64, 48)  # back (lru-cached: no recompile)
    assert core.frame(set(), now_s=4.1).shape == (48, 64, 3)


def test_stats_keys(core):
    s = core.stats()
    assert set(s) >= {"fps", "paused", "interval", "speed_c", "time_s", "size"}


def test_window_frontend_smoke(monkeypatch):
    """run_window under SDL's dummy video driver: real pygame loop, synthetic
    key/resize events consumed on the first frame, bounded by max_frames.
    Covers the window frontend path (viewer.run_window) with no display."""
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore, run_window

    core = ViewerCore(parse_scene(SCENE), 64, 48)
    # The event queue needs an initialized display; run_window's own init is
    # idempotent. Post held-'w' (accelerate), space (unpause) and a resize --
    # all consumed in the first frame's event.get().
    pygame.display.init()
    pygame.display.set_mode((64, 48))
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_w))
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_SPACE))
    pygame.event.post(pygame.event.Event(pygame.VIDEORESIZE, w=96, h=64))
    try:
        assert run_window(core, max_frames=3) == 0
        assert (core.width, core.height) == (96, 64)
        assert _speed(core) > 0.0  # held 'w' accelerated the camera
        assert not core.sim.paused  # space unpaused
        # QUIT exits the loop before max_frames
        pygame.display.init()
        pygame.display.set_mode((96, 64))
        pygame.event.post(pygame.event.Event(pygame.QUIT))
        assert run_window(core, max_frames=100) == 0
    finally:
        pygame.quit()


def test_web_frontend_end_to_end():
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore, run_web

    # Fresh core: the module fixture's synthetic timestamps must not leak
    # into the wall-clock-driven web loop (render fn is lru-cached anyway).
    core = ViewerCore(parse_scene(SCENE), 64, 48)

    stop = threading.Event()
    port_holder = {}
    ready = threading.Event()

    def on_ready(port):
        port_holder["port"] = port
        ready.set()

    t = threading.Thread(
        target=run_web,
        kwargs=dict(core=core, port=0, on_ready=on_ready, stop_event=stop),
        daemon=True,
    )
    t.start()
    assert ready.wait(30)
    base = f"http://127.0.0.1:{port_holder['port']}"
    try:
        html = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"Relativistic Ray Tracer" in html
        jpeg = urllib.request.urlopen(f"{base}/frame", timeout=30).read()
        assert jpeg[:2] == b"\xff\xd8"  # JPEG SOI
        # hold 'w' over HTTP until the loop has sampled it, then release
        urllib.request.urlopen(
            urllib.request.Request(f"{base}/key?c=w&d=1", method="POST"), timeout=10)
        deadline = time.monotonic() + 20
        stats = {}
        while time.monotonic() < deadline:
            stats = json.loads(
                urllib.request.urlopen(f"{base}/stats", timeout=10).read())
            if stats["speed_c"] > 0:
                break
            time.sleep(0.05)
        urllib.request.urlopen(
            urllib.request.Request(f"{base}/key?c=*&d=0", method="POST"), timeout=10)
        assert stats["size"] == [64, 48]
        assert stats["speed_c"] > 0  # the held 'w' accelerated the camera
        # POST /resize is applied on the RENDER-LOOP thread (request_resize:
        # a handler-thread resize would compile + render concurrently with
        # the frame loop -- the concurrent-fetch deadlock pattern): the next
        # frames must pick up the new size.
        urllib.request.urlopen(
            urllib.request.Request(f"{base}/resize?w=96&h=64", method="POST"),
            timeout=10)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            stats = json.loads(
                urllib.request.urlopen(f"{base}/stats", timeout=10).read())
            if stats["size"] == [96, 64]:
                break
            time.sleep(0.05)
        assert stats["size"] == [96, 64]
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


def test_polymorphic_matches_static_renderer():
    """The resolution-polymorphic viewer renderer (dirs as a traced
    argument, host-side crop) must reproduce the static per-size renderer
    byte-for-byte -- it is the same pipeline with the camera constant
    turned into an input."""
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.models.scene import build_scene
    from relativitypathtracer_tpu.render import (
        FrameState, TILE, _round_up, build_render_fn, build_viewer_render_fn,
        viewer_dirs)

    scene, meta = build_scene(parse_scene(SCENE))
    state = FrameState.initial()
    for w, h in ((64, 48), (96, 64)):
        ph, pw = _round_up(h, TILE), _round_up(w, TILE)
        build_render_fn.cache_clear()
        ref = np.asarray(build_render_fn(
            meta, w, h, meta.default_interval, 1, out_uint8=True)(scene, state))
        out = np.asarray(build_viewer_render_fn(
            meta, ph, pw, meta.default_interval)(
                scene, state, viewer_dirs(w, h, ph, pw)))[:h, :w]
        np.testing.assert_array_equal(out, ref, err_msg=f"{w}x{h}")


def test_polymorphic_resize_is_compile_free():
    """Shrinking within the padded grid must reuse the warmed executable:
    no new (pad, interval, pool) key is warmed, and the frame matches a
    fresh static renderer at the new logical size."""
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.render import build_render_fn
    from relativitypathtracer_tpu.viewer import ViewerCore

    core = ViewerCore(parse_scene(SCENE), 96, 64)
    core.frame(set(), now_s=100.0)
    warmed_before = set(core._warmed)
    core.resize(64, 48)
    assert set(core._warmed) == warmed_before  # no new compile key
    img = core.frame(set(), now_s=100.016)
    assert img.shape == (48, 64, 3)
    ref = np.asarray(build_render_fn(
        core.meta, 64, 48, core.sim.interval, 1, out_uint8=True)(
            core.scene, core.sim.frame))[::-1]
    # the one-frame device pipeline lags by a frame; compare the NEXT one
    img = core.frame(set(), now_s=100.032)
    np.testing.assert_array_equal(img, np.asarray(build_render_fn(
        core.meta, 64, 48, core.sim.interval, 1, out_uint8=True)(
            core.scene, core.sim.frame))[::-1])


def test_stream_scale_pools_on_device():
    """stream_scale=2 returns a device box-filtered half-size frame whose
    content matches host-side pooling of the full-size tonemapped frame."""
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore

    full = ViewerCore(parse_scene(SCENE), 64, 64)
    pooled = ViewerCore(parse_scene(SCENE), 64, 64, stream_scale=2)
    a = full.frame(set(), now_s=1.0)
    b = pooled.frame(set(), now_s=1.0)
    assert b.shape == (32, 32, 3)
    host_pool = np.asarray(a, np.float32).reshape(32, 2, 32, 2, 3).mean((1, 3))
    # device pooling averages BEFORE the uint8 truncation; allow 1.5 lsb
    assert np.abs(host_pool - b.astype(np.float32)).max() <= 1.5


def test_stream_scale_requires_msaa1():
    """Device-side stream pooling only exists on the polymorphic (msaa=1)
    path; requesting it with msaa>1 must fail loudly instead of serving
    full-size frames while /stats reports a stream_scale."""
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore

    with pytest.raises(ValueError, match="stream_scale"):
        ViewerCore(parse_scene(SCENE), 64, 64, msaa=2, stream_scale=2)


def test_resize_snaps_to_stream_scale():
    """Odd logical sizes snap DOWN to stream_scale multiples: a ragged
    final pooled row would box-filter off-sensor padding into the frame."""
    from relativitypathtracer_tpu.models.dsl import parse_scene
    from relativitypathtracer_tpu.viewer import ViewerCore

    core = ViewerCore(parse_scene(SCENE), 65, 49, stream_scale=2)
    assert (core.width, core.height) == (64, 48)
    core.frame(set(), now_s=1.0)
    core.resize(97, 65)
    assert (core.width, core.height) == (96, 64)
    img = core.frame(set(), now_s=1.016)
    img = core.frame(set(), now_s=1.032)  # past the one-frame pipeline lag
    assert img.shape == (32, 48, 3)
