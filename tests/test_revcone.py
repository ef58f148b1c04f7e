"""Reversed-cone shadow culling (RPT_REVCONE, mesh_kernels._revcone_on).

Shadow segments for one point light all END at the light, so a second cull
cone with its apex AT the light (near-zero apex radius) is tight exactly
where the forward surface-origin cone is fat. The lever is cull-only: live
lists may only SHRINK, and because the general kernels clamp their result at
tmax and every sub-tmax hit lies ON its lane's segment (contained in both
cones), occlusion verdicts are unchanged. Mirrors the reference's
sample_light semantics (/root/reference/opencl_kernel.cl:488-545): only
`t < lightDist` matters.
"""

import numpy as np
import pytest
from conftest import MULTI_SCENE, clear_kernel_caches, render_with_mode as _render

from relativitypathtracer_tpu import build_scene, load_scene_file
from relativitypathtracer_tpu.models.dsl import parse_scene
from relativitypathtracer_tpu.ops import mesh_intersect

from test_pallas_interpret import _soup_mesh


def _converging_rays(rng, n, light, spread=4.0, zplane=-5.0):
    """Shadow-like rays: origins on a plane below the soup, all aimed AT one
    light point; tmax = the light distance. Some lanes masked (tmax 0)."""
    o = np.stack([
        rng.uniform(-spread, spread, n),
        rng.uniform(-spread, spread, n),
        np.full(n, zplane),
    ]).astype(np.float32)
    d = light[:, None] - o
    tmax = np.linalg.norm(d, axis=0).astype(np.float32)
    d = (d / tmax).astype(np.float32)
    tmax[: n // 8] = 0.0  # masked-irrelevant lanes
    return o, d, tmax


def test_revcone_exact(monkeypatch):
    """With RPT_REVCONE=1 the general kernel must keep every verdict: hits
    inside the bound exact vs the jnp truth, no-hit lanes still >= tmax."""
    from relativitypathtracer_tpu.ops.pallas import mesh_kernels

    rng = np.random.default_rng(31)
    mesh = _soup_mesh(rng, 200)
    m4 = np.eye(4, dtype=np.float32)
    light = np.array([0.5, 0.5, 6.0], np.float32)
    o, d, tmax = _converging_rays(rng, 1536, light)

    t_true = np.asarray(mesh_intersect.mesh_min_t_general(
        mesh, (0, 200), m4, m4, o, d, use_pallas=False))

    monkeypatch.setenv("RPT_REVCONE", "1")
    assert mesh_kernels._revcone_on()
    mesh_kernels.general_min_t.clear_cache()  # knob read at trace time
    try:
        t_k = np.asarray(mesh_intersect.mesh_min_t_general(
            mesh, (0, 200), m4, m4, o, d, use_pallas="interpret", tmax=tmax))
    finally:
        mesh_kernels.general_min_t.clear_cache()

    inside = t_true < tmax
    assert inside.any(), "no occluded lane (vacuous test)"
    assert (~inside & (tmax > 0)).any(), "no lit lane (vacuous test)"
    assert np.allclose(t_k[inside], t_true[inside], rtol=1e-5, atol=1e-6)
    assert np.all(t_k[~inside] >= tmax[~inside] * (1 - 1e-6))


@pytest.mark.fast
def test_revcone_shrinks_live_lists():
    """The reversed cone must only SHRINK live sets (ANDed conservative
    test), and on converging shadow geometry it must shrink them
    MATERIALLY -- the whole point of the lever.

    Fixture: 16 spatially-tight triangle clusters (one per chunk, like the
    Morton-ordered production pools) ringed around a surface patch whose
    shadow rays aim at an overhead light. The FORWARD cull inflates every
    chunk radius by the patch radius (~2), so the whole ring stays live;
    the reversed cone's near-zero apex radius culls the off-beam clusters."""
    import jax.numpy as jnp

    from relativitypathtracer_tpu.ops.pallas.mesh_kernels import (
        NB, TC, chunk_spheres, live_chunk_lists)

    rng = np.random.default_rng(37)
    K = 16  # clusters == chunks
    ang = np.arange(K) * 2 * np.pi / K
    centers = np.stack([np.cos(ang) * 2.5, np.sin(ang) * 2.5,
                        rng.uniform(0.5, 2.5, K)], axis=1).astype(np.float32)
    cent = (centers[:, None, :]
            + rng.uniform(-0.25, 0.25, (K, 32, 3))).reshape(-1, 3)
    off = rng.uniform(-0.1, 0.1, (K * 32, 2, 3)).astype(np.float32)
    T = K * 32
    A = jnp.asarray(cent, jnp.float32)
    B = A + jnp.asarray(off[:, 0])
    C = A + jnp.asarray(off[:, 1])
    spheres = chunk_spheres(A, B, C, T, T, tc=TC)

    light = np.array([0.0, 0.0, 8.0], np.float32)
    n = 2 * NB
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  np.full(n, -1.0)]).astype(np.float32)
    d = light[:, None] - o
    tmax = np.linalg.norm(d, axis=0).astype(np.float32)
    d = (d / tmax).astype(np.float32)
    valid = jnp.asarray(tmax > 0)
    endpoints = jnp.asarray(o + d * tmax)
    _, _, counts0 = live_chunk_lists(spheres, jnp.asarray(d), jnp.asarray(o),
                                     valid=valid)
    _, _, counts1 = live_chunk_lists(spheres, jnp.asarray(d), jnp.asarray(o),
                                     valid=valid,
                                     endpoints=endpoints,
                                     seg_len=jnp.asarray(tmax))
    c0 = np.asarray(counts0).ravel()
    c1 = np.asarray(counts1).ravel()
    assert np.all(c1 <= c0), "reversed cone GREW a live list"
    assert c1.sum() < c0.sum(), "reversed cone culled nothing on converging rays"


@pytest.mark.parametrize("name", ["shadows", "bunny"])
def test_revcone_full_frame(name, monkeypatch, reference_root):
    """Full-frame equality vs the jnp path with the knob ON: shadows.txt
    (multi-object) + bunny.txt (the largest shipped mesh)."""
    monkeypatch.setenv("RPT_REVCONE", "1")
    clear_kernel_caches()
    try:
        host = load_scene_file(str(reference_root / "Scenes" / f"{name}.txt"))
        scene, meta = build_scene(host)
        ref = _render(scene, meta, False)
        got = _render(scene, meta, "interpret")
        diff = np.abs(ref - got)
        frac_bad = float(np.mean(diff.max(-1) > 1e-3))
        assert diff.mean() < 1e-4, f"mean diff {diff.mean()}"
        assert frac_bad <= 0.002, f"{frac_bad * 100:.2f}% pixels differ > 1e-3"
    finally:
        clear_kernel_caches()


def test_revcone_multi_mesh_frame(monkeypatch, reference_root):
    """Multi-mesh coverage: the two-mesh scene renders identically with
    the knob on (per-object endpoint conversion)."""
    monkeypatch.setenv("RPT_REVCONE", "1")
    clear_kernel_caches()
    try:
        host = parse_scene(MULTI_SCENE, str(reference_root))
        scene, meta = build_scene(host)
        assert len(meta.mesh_ids) == 2
        ref = _render(scene, meta, False)
        got = _render(scene, meta, "interpret")
        diff = np.abs(ref - got)
        frac_bad = float(np.mean(diff.max(-1) > 1e-3))
        assert diff.mean() < 1e-4
        assert frac_bad <= 0.002
    finally:
        clear_kernel_caches()
