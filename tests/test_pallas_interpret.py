"""CPU coverage of the PRODUCTION Triton mesh walks via interpret mode.

The golden / oracle-parity suites pin jax to CPU where the jnp scan runs, so
without these tests the GPU path (live-chunk cone culling, the bucket order,
early termination, tmax search bounding in ops/pallas/mesh_kernels.py)
would have zero automated coverage. Interpret mode executes the real kernel
bodies (same while_loop, same list loads) with emulated refs, so any
semantic divergence from the jnp scan shows up here.
"""

import numpy as np
import pytest
from conftest import MULTI_SCENE, render_with_mode as _render

from relativitypathtracer_tpu import build_scene, load_scene_file
from relativitypathtracer_tpu.models.scene import MeshArrays
from relativitypathtracer_tpu.ops import mesh_intersect


@pytest.mark.parametrize("name", ["shadows", "bunny", "cubes", "cube", "soccer"])
def test_interpret_kernels_match_jnp_render(name, reference_root):
    """Full-frame equality between the Triton walks and the jnp scan.

    shadows.txt exercises BOTH kernels (primary mesh hits + per-light shadow
    rays with the tmax bound); bunny.txt is the largest mesh (most chunks,
    deepest live lists -> real early-termination traffic).
    """
    host = load_scene_file(str(reference_root / "Scenes" / f"{name}.txt"))
    scene, meta = build_scene(host)
    ref = _render(scene, meta, False)
    got = _render(scene, meta, "interpret")
    diff = np.abs(ref - got)
    # Same fp32 math modulo reduce grouping; only hit/miss ties may flip.
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    assert diff.mean() < 1e-4, f"mean diff {diff.mean()}"
    assert frac_bad <= 0.002, f"{frac_bad * 100:.2f}% pixels differ > 1e-3"


def _soup_mesh(rng, T):
    """Random triangle soup as a MeshArrays (dummy octree/attr pools)."""
    cent = rng.uniform(-2.0, 2.0, (T, 3)).astype(np.float32)
    off = rng.uniform(-0.3, 0.3, (T, 2, 3)).astype(np.float32)
    verts = np.concatenate([cent, cent + off[:, 0], cent + off[:, 1]], axis=0)
    ids = np.arange(T, dtype=np.int32)
    tri_v = np.stack([ids, ids + T, ids + 2 * T], axis=1)
    z1 = np.zeros((1,), np.int32)
    return MeshArrays(
        vertices=verts, tri_v=tri_v,
        tri_uv=np.zeros((T, 3), np.int32), tri_n=np.zeros((T, 3), np.int32),
        uvs=np.zeros((1, 2), np.float32), normals=np.ones((1, 3), np.float32),
        node_min=np.zeros((1, 3), np.float32), node_max=np.zeros((1, 3), np.float32),
        node_tris_index=z1, node_tris_count=z1,
        node_children=-np.ones((1, 8), np.int32),
        node_neighbors=-np.ones((1, 6), np.int32),
        oct_tris=z1,
    )


@pytest.mark.fast  # the subset's one interpret-kernel case
def test_interpret_shared_kernel_random_soup():
    """Kernel-level equality on incoherent geometry: random soup gives wide
    ray cones and heavily-overlapping chunk buckets -- the regime where an
    unsound early-termination order would skip nearer hits."""
    rng = np.random.default_rng(7)
    mesh = _soup_mesh(rng, 300)
    m4 = np.eye(4, dtype=np.float32)
    o3 = np.array([0.0, 0.0, -6.0], np.float32)
    d = rng.normal(size=(3, 2048)).astype(np.float32)
    d[2] = np.abs(d[2]) + 0.5  # aim roughly at the soup
    d /= np.linalg.norm(d, axis=0)

    t0, n0, uv0, v0 = mesh_intersect.mesh_intersect_shared(
        mesh, (0, 300), m4, m4, o3, d, use_pallas=False)
    t1, n1, uv1, v1 = mesh_intersect.mesh_intersect_shared(
        mesh, (0, 300), m4, m4, o3, d, use_pallas="interpret")
    assert np.array_equal(np.asarray(v0), np.asarray(v1))
    hit = np.asarray(v0)
    assert hit.any(), "soup aimed-at rays produced zero hits (vacuous test)"
    assert np.allclose(np.asarray(t0)[hit], np.asarray(t1)[hit], rtol=1e-5, atol=1e-6)


def test_interpret_general_kernel_tmax_semantics():
    """general_min_t with a per-ray search bound: where the true nearest hit
    is inside the bound the kernel must find it exactly; beyond the bound it
    may return anything >= the bound (callers only test t < tmax)."""
    rng = np.random.default_rng(11)
    mesh = _soup_mesh(rng, 200)
    m4 = np.eye(4, dtype=np.float32)
    n = 1536
    o = rng.uniform(-4, 4, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    tmax = rng.uniform(0.5, 8.0, (n,)).astype(np.float32)

    t_true = np.asarray(mesh_intersect.mesh_min_t_general(
        mesh, (0, 200), m4, m4, o, d, use_pallas=False))
    t_k = np.asarray(mesh_intersect.mesh_min_t_general(
        mesh, (0, 200), m4, m4, o, d, use_pallas="interpret", tmax=tmax))

    inside = t_true < tmax
    assert inside.any(), "no hit landed inside its bound (vacuous test)"
    assert np.allclose(t_k[inside], t_true[inside], rtol=1e-5, atol=1e-6)
    assert np.all(t_k[~inside] >= tmax[~inside] * (1 - 1e-6))


@pytest.mark.parametrize("mode", ["none", "tmax", "boxfar"])
def test_general_kernel_segment_cull_modes(mode, monkeypatch):
    """Segment-bounded live-list culling (RPT_SHADOW_CULL) must never change
    an occlusion verdict: a chunk is dropped only when its conservative min
    distance exceeds every lane's search bound, so all its hits land beyond
    tmax for every lane. All three modes must agree with the jnp truth."""
    from relativitypathtracer_tpu.ops.pallas import mesh_kernels

    monkeypatch.setenv("RPT_SHADOW_CULL", mode)
    assert mesh_kernels._shadow_cull_mode() == mode  # knob actually engaged
    mesh_kernels.general_min_t.clear_cache()  # mode is read at trace time
    try:
        rng = np.random.default_rng(17)
        mesh = _soup_mesh(rng, 200)
        m4 = np.eye(4, dtype=np.float32)
        n = 1536
        o = rng.uniform(-4, 4, (3, n)).astype(np.float32)
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
        tmax = rng.uniform(0.2, 6.0, (n,)).astype(np.float32)
        # plus fully-masked lanes (tmax 0), like irrelevant shadow lanes
        tmax[: n // 8] = 0.0

        t_true = np.asarray(mesh_intersect.mesh_min_t_general(
            mesh, (0, 200), m4, m4, o, d, use_pallas=False))
        t_k = np.asarray(mesh_intersect.mesh_min_t_general(
            mesh, (0, 200), m4, m4, o, d, use_pallas="interpret", tmax=tmax))
        inside = t_true < tmax
        assert np.allclose(t_k[inside], t_true[inside], rtol=1e-5, atol=1e-6)
        assert np.all(t_k[~inside] >= tmax[~inside] * (1 - 1e-6))
    finally:
        mesh_kernels.general_min_t.clear_cache()


@pytest.mark.parametrize("T", [600, 513, 1100])
def test_jnp_fallback_covers_tail_chunk(T):
    """Regression: the jnp scan's chunk count floor-divided T_pad by
    tri_chunk, silently dropping the tail triangles whenever T_pad was not
    a multiple of 512 (T in (512,768], (1024,1280], ...) -- rays passed
    through geometry and shadows leaked on CPU backends. A ray aimed at the
    LAST triangle must hit on both paths."""
    import jax.numpy as jnp

    rng = np.random.default_rng(41)
    mesh = _soup_mesh(rng, T)
    m4 = np.eye(4, dtype=np.float32)
    o3 = np.array([0.0, 0.0, -50.0], np.float32)
    # aim one ray at the CENTROID of each of: first tri, a mid tri, the
    # LAST tri (vertices/edges are exact u/v boundaries where the two
    # paths' fp orderings may legitimately disagree)
    verts = np.asarray(mesh.vertices)
    cent = (verts[:T] + verts[T:2 * T] + verts[2 * T:]) / 3.0
    targets = [0, T // 2, T - 1]
    d = np.stack([cent[i] - o3 for i in targets], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)

    t0, _, _, v0 = mesh_intersect.mesh_intersect_shared(
        mesh, (0, T), m4, m4, o3, jnp.asarray(d), use_pallas=False)
    t1, _, _, v1 = mesh_intersect.mesh_intersect_shared(
        mesh, (0, T), m4, m4, o3, jnp.asarray(d), use_pallas="interpret")
    hit = np.asarray(v0)
    assert hit.all(), f"centroid-aimed rays must all hit (got {hit})"
    assert np.array_equal(hit, np.asarray(v1)), (
        f"fallback hit mask {hit} != kernel {np.asarray(v1)}")
    assert np.allclose(np.asarray(t0)[hit], np.asarray(t1)[hit],
                       rtol=1e-5, atol=1e-6)

    o = np.broadcast_to(o3[:, None], (3, 3)).copy()
    tg0 = np.asarray(mesh_intersect.mesh_min_t_general(
        mesh, (0, T), m4, m4, o, d, use_pallas=False))
    tg1 = np.asarray(mesh_intersect.mesh_min_t_general(
        mesh, (0, T), m4, m4, o, d, use_pallas="interpret"))
    fin = tg1 < 1e19
    assert fin.all(), f"centroid-aimed rays must all hit (got {fin})"
    assert np.array_equal(tg0 < 1e19, fin)
    assert np.allclose(tg0[fin], tg1[fin], rtol=1e-5, atol=1e-6)


def test_interpret_multimesh_matches_jnp(reference_root):
    """Two mesh objects with a point light through the per-mesh walk loop
    against the jnp scan: both walks, per-object rest frames, and the light
    excluded from its own occlusion test."""
    from relativitypathtracer_tpu import parse_scene

    host = parse_scene(MULTI_SCENE, str(reference_root))
    scene, meta = build_scene(host)
    assert len(meta.mesh_ids) == 2
    ref = _render(scene, meta, False)
    got = _render(scene, meta, "interpret")
    diff = np.abs(ref - got)
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    assert diff.mean() < 1e-4, f"mean diff {diff.mean()}"
    assert frac_bad <= 0.002, f"{frac_bad * 100:.2f}% pixels differ > 1e-3"


def test_interpret_batched_many_instances(tmp_path):
    """8 disjoint instances of one mesh in one frame, each walked in its own
    rest frame: per-pixel equality with the jnp scan."""
    from relativitypathtracer_tpu import build_scene, parse_scene

    (tmp_path / "tri.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 0 1 0\nf 1 2 3\n")
    lines = ["Mtri.obj"]
    for k in range(8):
        lines += [f"Om0\n p{-7 + 2 * k},0,8,0,0,1,0,1,1,1\n c0.2,{0.1 * (k + 1):.1f},0.5"]
    lines += ["A1", "R", ""]
    host = parse_scene("\n".join(lines), str(tmp_path))
    scene, meta = build_scene(host)
    assert len(meta.mesh_ids) == 8
    ref = _render(scene, meta, False)
    got = _render(scene, meta, "interpret")
    diff = np.abs(ref - got)
    assert diff.mean() < 1e-4
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.002


@pytest.mark.fast
def test_sampler_9row_fp_matches_6row():
    """The renderer passes fp widened with precomputed tile_params rows
    [sm1 ss r16] (the per-object form of the Morton grid constants); the
    footprint gather must produce BIT-identical results to the self-derived
    6-row form."""
    import jax.numpy as jnp

    from relativitypathtracer_tpu.ops.texture_layout import tile_params
    from relativitypathtracer_tpu.ops.texture_sample import (
        bilinear_sample_footprint)

    rng = np.random.default_rng(11)
    n = 2048
    w, h = 48, 224  # non-square: pow2 grid has longer-axis high bits
    wb = w // 16
    rows = (wb * (-(-h // 16)) * 4 // 8) * 256
    quads = jnp.asarray(rng.integers(0, 2 ** 24, (rows, 8), dtype=np.uint32))
    fp6 = np.broadcast_to(np.array([0, 0, 0, wb, w, h], np.int32)[:, None],
                          (6, n))
    sm1, ss, r16 = tile_params(np.int64(wb), np.int64(h))
    fp9 = np.concatenate([fp6, np.broadcast_to(
        np.array([sm1, ss, r16], np.int32)[:, None], (3, n))])
    wa = jnp.full((n,), w, jnp.int32)
    ha = jnp.full((n,), h, jnp.int32)
    uv = jnp.asarray(rng.random((2, n)).astype(np.float32))
    a = np.asarray(bilinear_sample_footprint(quads, jnp.asarray(fp6), wa, ha, uv))
    b = np.asarray(bilinear_sample_footprint(quads, jnp.asarray(fp9), wa, ha, uv))
    np.testing.assert_array_equal(a, b)


def test_interpret_flagship_matches_jnp():
    """The flagship scene (utils.demo_scenes) through the whole renderer with
    the Triton walks in interpret mode against the jnp scan: primary walk,
    per-light shadow walk with tmax bounds and occlusion retirement."""
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene

    scene, meta = flagship_scene(0)
    ref = _render(scene, meta, False, w=96, h=64)
    got = _render(scene, meta, "interpret", w=96, h=64)
    diff = np.abs(ref - got)
    assert (ref.max(-1) > 0.3).mean() > 0.05, "flagship frame mostly empty"
    assert diff.mean() < 1e-4, f"mean diff {diff.mean()}"
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.002
