"""MSAA folding (render.msaa_swizzle / msaa_mean_unswizzle).

msaa^2 sample sets fold into the ray axis (patch-major, sample minor) and
run as ONE shade pass; these tests pin the layout algebra and the end-to-end
equivalence with the single-sample path.
"""

import numpy as np
import pytest

import relativitypathtracer_tpu.render as render_mod
from relativitypathtracer_tpu import build_scene, load_scene_file
from relativitypathtracer_tpu.render import (
    FrameState, build_render_fn, msaa_mean_unswizzle, msaa_swizzle,
)


def test_swizzle_mean_roundtrip():
    """msaa_mean_unswizzle(msaa_swizzle(x)) == per-pixel sample mean in
    row-major order, for every supported msaa."""
    rng = np.random.default_rng(0)
    ph = pw = 64
    for m in (2, 4, 8, 16):
        x = rng.normal(size=(m * m, ph, pw, 3)).astype(np.float32)
        folded = msaa_swizzle(x, ph, pw, m)  # (3, ph*pw*S)
        out = msaa_mean_unswizzle(folded, ph, pw, m)
        ref = x.mean(axis=0).transpose(2, 0, 1).reshape(3, ph * pw)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_folded_msaa_equals_single_sample(reference_root, monkeypatch):
    """With every sample set forced EQUAL to the pinhole-center rays, the
    folded msaa=2 render must reproduce the msaa=1 render exactly -- the
    fold changes only ray-block composition, which the wavefront kernels'
    results are independent of."""
    from relativitypathtracer_tpu.ops.camera import camera_ray_dirs as real_dirs

    def fake_dirs(width, height, msaa=1, pad_width=None, pad_height=None):
        base = real_dirs(width, height, 1, pad_width=pad_width,
                         pad_height=pad_height)
        if msaa == 1:
            return base
        return np.broadcast_to(np.asarray(base)[None],
                               (msaa * msaa, *base.shape)).copy()

    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()
    W, H = 96, 64
    monkeypatch.setenv("RPT_MSAA_FOLD", "1")  # pin the FOLD path (the
    build_render_fn.cache_clear()             # default is the per-sample loop)
    ref = np.asarray(build_render_fn(meta, W, H, meta.default_interval, 1)(scene, state))
    monkeypatch.setattr(render_mod, "camera_ray_dirs", fake_dirs)
    build_render_fn.cache_clear()
    try:
        out = np.asarray(
            build_render_fn(meta, W, H, meta.default_interval, 2)(scene, state))
    finally:
        # monkeypatch restores camera_ray_dirs, but the lru cache would
        # otherwise keep a fake-dirs renderer under this (meta, W, H, 2)
        # key and poison later tests that build the same configuration.
        build_render_fn.cache_clear()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_real_msaa_close_to_single(reference_root):
    """Real subpixel offsets: msaa=2 should differ from msaa=1 only by
    antialiasing (bounded mean difference, same shape/range)."""
    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()
    W, H = 96, 64
    build_render_fn.cache_clear()
    one = np.asarray(build_render_fn(meta, W, H, meta.default_interval, 1)(scene, state))
    four = np.asarray(build_render_fn(meta, W, H, meta.default_interval, 2)(scene, state))
    assert four.shape == one.shape
    assert np.abs(four - one).mean() < 0.02  # only edge pixels differ
    assert (np.abs(four - one).max(axis=-1) > 1e-3).mean() < 0.2


def test_loop_mode_matches_folded(reference_root, monkeypatch):
    """The default sequential per-sample loop (the reference's structure,
    opencl_kernel.cl:642-648) must produce the same image as the folded path
    (RPT_MSAA_FOLD=1): the fold is a layout/scheduling choice only."""
    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()
    W, H = 96, 64
    monkeypatch.setenv("RPT_MSAA_FOLD", "1")
    build_render_fn.cache_clear()
    folded = np.asarray(
        build_render_fn(meta, W, H, meta.default_interval, 2)(scene, state))
    monkeypatch.setenv("RPT_MSAA_FOLD", "0")
    build_render_fn.cache_clear()
    try:
        loop = np.asarray(
            build_render_fn(meta, W, H, meta.default_interval, 2)(scene, state))
    finally:
        # the lru cache would otherwise keep a loop-mode renderer under the
        # (meta, W, H, 2) key after the env restore and poison later tests
        build_render_fn.cache_clear()
    np.testing.assert_allclose(loop, folded, atol=2e-6)
