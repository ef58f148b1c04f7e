"""Multi-device sharded rendering tests (8 virtual CPU devices, conftest)."""

import jax
import numpy as np
import pytest

from relativitypathtracer_tpu import FrameState, build_scene, load_scene_file, render_frame
from relativitypathtracer_tpu.parallel.tiles import build_sharded_render_fn, default_mesh


@pytest.fixture(scope="module")
def cube_scene(reference_root):
    host = load_scene_file(str(reference_root / "Scenes" / "cube.txt"))
    return build_scene(host)


def test_virtual_device_count():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("assign", ["strided", "contiguous"])
@pytest.mark.fast  # the subset's one sharded case
def test_sharded_matches_single_device(cube_scene, reference_root, assign):
    scene, meta = cube_scene
    W, H = 192, 96
    state = FrameState.initial()
    single = np.asarray(render_frame(scene, meta, state, W, H))
    mesh = default_mesh(8)
    render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh,
                                     band_assign=assign)
    sharded = np.asarray(render(scene, state))
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_band_skew_bunny(reference_root):
    """Load balance: on bunny (mesh work concentrated in the frame center)
    the default diagonal block dealing must keep per-device mesh-work skew
    well under 2x, and strictly improve on contiguous bands. 192x512 gives a representative 6x16 block grid; tiny grids (a
    handful of blocks per device) stay granularity-bound by nature."""
    from relativitypathtracer_tpu.parallel.tiles import (
        partition_work, per_block_mesh_work)

    host = load_scene_file(str(reference_root / "Scenes" / "bunny.txt"))
    scene, meta = build_scene(host)
    W, H = 192, 512
    # the intersect is assignment-independent: trace once, partition twice
    per_block, rows, cols = per_block_mesh_work(scene, meta, W, H, 8)
    cont, skew_cont = partition_work(per_block, rows, cols, 8, "contiguous")
    stri, skew_stri = partition_work(per_block, rows, cols, 8, "strided")
    assert cont.sum() == stri.sum() > 0  # same total work, just repartitioned
    assert skew_cont > 2.0  # the problem exists (bunny fills center bands)
    assert skew_stri <= 1.6, f"strided skew {skew_stri} (counts {stri})"
    assert skew_stri < skew_cont


def test_sharded_mesh_scene(reference_root):
    host = load_scene_file(str(reference_root / "Scenes" / "shadows.txt"))
    scene, meta = build_scene(host)
    W, H = 128, 64
    state = FrameState.initial()
    single = np.asarray(render_frame(scene, meta, state, W, H))
    mesh = default_mesh(4)
    render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh)
    sharded = np.asarray(render(scene, state))
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_sharded_interpret_production_kernels(reference_root):
    """The composition real devices run: the production Triton kernel
    bodies (interpret mode) under shard_map. shadows.txt exercises the
    shared mesh walk and the general (shadow) walk with tmax bounding inside
    the sharded band renderer. Without this, every multi-device test would
    only ever cover the jnp scan (ops/mesh_intersect.resolve_kernels picks
    it on the CPU)."""
    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.render import build_render_fn

    host = load_scene_file(str(reference_root / "Scenes" / "shadows.txt"))
    scene, meta = build_scene(host)
    W, H = 128, 64
    state = FrameState.initial()
    mesh_intersect.PALLAS_MODE = "interpret"
    build_render_fn.cache_clear()  # cached renderers close over the mode
    try:
        single = np.asarray(render_frame(scene, meta, state, W, H))
        mesh = default_mesh(4)
        render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh)
        sharded = np.asarray(render(scene, state))
    finally:
        mesh_intersect.PALLAS_MODE = None
        build_render_fn.cache_clear()
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_sharded_uneven_height(cube_scene):
    # height not divisible by n_dev * 32: padding + crop must still line up
    scene, meta = cube_scene
    W, H = 96, 100
    state = FrameState.initial()
    single = np.asarray(render_frame(scene, meta, state, W, H))
    mesh = default_mesh(8)
    render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh)
    sharded = np.asarray(render(scene, state))
    assert sharded.shape == (100, 96, 3)
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_sharded_msaa_and_aux(cube_scene):
    """Folded-msaa + psum'd aux through shard_map: image matches the
    single-device msaa render; aux totals are frame-wide on every device."""
    scene, meta = cube_scene
    W, H = 96, 64
    state = FrameState.initial()
    single = np.asarray(render_frame(scene, meta, state, W, H, msaa=2))
    mesh = default_mesh(4)
    render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh,
                                     msaa=2, with_aux=True)
    img, aux = render(scene, state)
    np.testing.assert_allclose(np.asarray(img), single, atol=2e-5)
    assert int(aux["hits"]) > 0
    # totals equal the single-device aux (psum makes them frame-wide)
    from relativitypathtracer_tpu.render import build_render_fn
    build_render_fn.cache_clear()
    _, aux_ref = build_render_fn(meta, W, H, meta.default_interval, 2,
                                 with_aux=True)(scene, state)
    assert int(aux["hits"]) == int(aux_ref["hits"])
    assert int(aux["shadow_rays"]) == int(aux_ref["shadow_rays"])


def test_sharded_flagship_interpret_kernels():
    """The in-repository flagship scene over 4 devices with the Triton walks
    in interpret mode, against the single-device jnp-scan frame."""
    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene

    scene, meta = flagship_scene(0)
    W, H = 128, 64
    state = FrameState.initial()
    single = np.asarray(render_frame(scene, meta, state, W, H))
    mesh_intersect.PALLAS_MODE = "interpret"
    try:
        render = build_sharded_render_fn(meta, W, H, meta.default_interval,
                                         default_mesh(4))
        sharded = np.asarray(render(scene, state))
    finally:
        mesh_intersect.PALLAS_MODE = None
    diff = np.abs(sharded - single)
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.002
    assert diff.mean() < 1e-4
