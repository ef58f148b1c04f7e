"""Renderer feature tests: MSAA, interval override, FrameState stepping."""

import jax.numpy as jnp
import numpy as np

from relativitypathtracer_tpu import FrameState, build_scene, load_scene_file, render_frame
from relativitypathtracer_tpu.utils import framestate


def test_msaa_supersampling(reference_root):
    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    img1 = np.asarray(render_frame(scene, meta, FrameState.initial(), 96, 64, msaa=1))
    img2 = np.asarray(render_frame(scene, meta, FrameState.initial(), 96, 64, msaa=2))
    assert img1.shape == img2.shape
    # supersampling smooths edges: fewer extreme-gradient pixels
    g1 = np.abs(np.diff(img1, axis=1)).max(-1)
    g2 = np.abs(np.diff(img2, axis=1)).max(-1)
    assert (g2 > 0.5).sum() <= (g1 > 0.5).sum()


def test_interval_override_changes_lighting(reference_root):
    host = load_scene_file(str(reference_root / "Scenes" / "arch.txt"))
    scene, meta = build_scene(host)
    with_prop = np.asarray(render_frame(scene, meta, FrameState.initial(), 96, 64, interval=-1))
    without = np.asarray(render_frame(scene, meta, FrameState.initial(), 96, 64, interval=0))
    # interval=0 forces ambient to 1.0 and disables lights: images must differ
    assert np.abs(with_prop - without).max() > 0.05


def test_framestate_step_velocity_and_time():
    sim = framestate.SimState.initial(default_interval=-1)
    keys = [False] * 9
    keys[framestate.KEY_W] = True
    sim = framestate.step(sim, keys, 500.0)
    v = np.asarray(sim.frame.cam_velocity)
    assert v[2] > 0 and abs(v[0]) < 1e-6  # forward motion
    assert sim.paused and float(sim.frame.cam_pos[0]) == 0.0

    # unpause (space edge), advance time
    keys = [False] * 9
    keys[framestate.KEY_SPACE] = True
    sim = framestate.step(sim, keys, 16.0)
    assert not sim.paused
    keys = [False] * 9
    sim = framestate.step(sim, keys, 1000.0)
    assert float(sim.frame.cam_pos[0]) > 0.9

    # reset velocity
    keys = [False] * 9
    keys[framestate.KEY_R] = True
    sim = framestate.step(sim, keys, 16.0)
    np.testing.assert_allclose(np.asarray(sim.frame.cam_velocity), 0.0)


def test_framestate_interval_toggle_edges():
    sim = framestate.SimState.initial(default_interval=-1)
    keys = [False] * 9
    keys[framestate.KEY_I] = True
    sim = framestate.step(sim, keys, 16.0)
    assert sim.interval == 0
    # held key: no second toggle
    sim = framestate.step(sim, keys, 16.0)
    assert sim.interval == 0
    # release + press again toggles back
    sim = framestate.step(sim, [False] * 9, 16.0)
    keys = [False] * 9
    keys[framestate.KEY_I] = True
    sim = framestate.step(sim, keys, 16.0)
    assert sim.interval == -1


def test_velocity_composition_stays_subluminal():
    sim = framestate.SimState.initial()
    keys = [False] * 9
    keys[framestate.KEY_W] = True
    for _ in range(100):
        sim = framestate.step(sim, keys, 2000.0)
    assert float(jnp.linalg.norm(sim.frame.cam_velocity)) < 1.0


def test_render_uint8_matches_host_packing(reference_root):
    """out_uint8 packs on device with exactly utils.image.to_uint8 semantics
    (the viewer fetches uint8 frames -- 4x fewer bytes per frame)."""
    from relativitypathtracer_tpu import FrameState, build_scene, load_scene_file
    from relativitypathtracer_tpu.render import build_render_fn
    from relativitypathtracer_tpu.utils.image import to_uint8

    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()
    build_render_fn.cache_clear()
    f32 = build_render_fn(meta, 96, 64, meta.default_interval)(scene, state)
    u8 = build_render_fn(meta, 96, 64, meta.default_interval,
                         out_uint8=True)(scene, state)
    assert np.asarray(u8).dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(u8), to_uint8(np.asarray(f32)))


def test_fused_out_is_bit_identical(reference_root, monkeypatch):
    """RPT_FUSED_OUT=1 (tonemap before ONE unswizzle+HWC relayout) must be
    bit-identical to the split unswizzle + .T + tonemap pipeline: the Hable
    curve is elementwise, so it commutes with any pixel permutation."""
    import pytest as _pytest

    from relativitypathtracer_tpu.render import build_render_fn

    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()
    build_render_fn.cache_clear()
    base = np.asarray(
        build_render_fn(meta, 96, 64, meta.default_interval)(scene, state))
    monkeypatch.setenv("RPT_FUSED_OUT", "1")
    build_render_fn.cache_clear()  # knob read at trace time
    try:
        fused = np.asarray(
            build_render_fn(meta, 96, 64, meta.default_interval)(scene, state))
    finally:
        build_render_fn.cache_clear()
    np.testing.assert_array_equal(base, fused)


def test_tile_unswizzle_hwc_identity():
    """tile_unswizzle_hwc == tile_unswizzle(v).T.reshape(ph, pw, k) on an
    arbitrary vector (pure relayout equivalence)."""
    from relativitypathtracer_tpu.render import (
        tile_unswizzle, tile_unswizzle_hwc)

    rng = np.random.default_rng(9)
    ph, pw = 64, 96
    v = jnp.asarray(rng.standard_normal((3, ph * pw)).astype(np.float32))
    a = np.asarray(tile_unswizzle(v, ph, pw)).T.reshape(ph, pw, 3)
    b = np.asarray(tile_unswizzle_hwc(v, ph, pw))
    np.testing.assert_array_equal(a, b)
