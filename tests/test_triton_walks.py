"""The Triton mesh walks (ops.pallas.mesh_kernels) and their routing.

On the CPU the kernels run in Pallas interpret mode against the jnp scan,
and lower for CUDA (the whole Pallas -> Triton IR pipeline) without a card.
Compiled on the card they run in chip_smoke.py and in the `gpu`-marked test
below (RPT_TEST_PLATFORM=cuda python -m pytest tests -m gpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from relativitypathtracer_tpu.ops import mesh_intersect
from relativitypathtracer_tpu.ops.pallas import mesh_kernels

from test_pallas_interpret import _soup_mesh


def _shared_case(T, n=1500, seed=41):
    """Soup of T triangles and n rays (not a multiple of the culling block
    mesh_kernels.NB, so the last block is ragged)."""
    rng = np.random.default_rng(seed)
    mesh = _soup_mesh(rng, T)
    o3 = np.array([0.0, 0.0, -6.0], np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[2] = np.abs(d[2]) + 0.5
    d /= np.linalg.norm(d, axis=0)
    return mesh, o3, d


def _general_case(T, n=1500, seed=43):
    """Soup, per-ray origins, and a search bound with 1/8 of the lanes
    masked (tmax 0, like irrelevant shadow lanes)."""
    rng = np.random.default_rng(seed)
    mesh = _soup_mesh(rng, T)
    o = rng.uniform(-4, 4, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    tmax = rng.uniform(0.5, 8.0, (n,)).astype(np.float32)
    tmax[: n // 8] = 0.0
    return mesh, o, d, tmax


@pytest.mark.parametrize("walk", ["shared", "general"])
@pytest.mark.parametrize("T", [513, 600, 1100])
def test_walk_matches_scan_ragged(walk, T):
    """Interpret-mode kernel == jnp scan at triangle counts that leave a
    ragged last 256-row pad and a ragged last ray block."""
    m4 = np.eye(4, dtype=np.float32)
    if walk == "shared":
        mesh, o3, d = _shared_case(T)
        t0, n0, uv0, v0 = mesh_intersect.mesh_intersect_shared(
            mesh, (0, T), m4, m4, o3, d, use_pallas=False)
        t1, n1, uv1, v1 = mesh_intersect.mesh_intersect_shared(
            mesh, (0, T), m4, m4, o3, d, use_pallas="interpret")
        hit = np.asarray(v0)
        assert hit.any(), "no ray hit the soup (vacuous test)"
        np.testing.assert_array_equal(hit, np.asarray(v1))
        np.testing.assert_allclose(np.asarray(t1)[hit], np.asarray(t0)[hit],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(n1)[:, hit],
                                   np.asarray(n0)[:, hit], rtol=1e-4, atol=1e-4)
    else:
        mesh, o, d, tmax = _general_case(T)
        t_true = np.asarray(mesh_intersect.mesh_min_t_general(
            mesh, (0, T), m4, m4, o, d, use_pallas=False))
        t_k = np.asarray(mesh_intersect.mesh_min_t_general(
            mesh, (0, T), m4, m4, o, d, use_pallas="interpret", tmax=tmax))
        live = tmax > 0
        inside = live & (t_true < tmax)
        assert inside.any(), "no hit inside its bound (vacuous test)"
        # Occlusion verdicts (the only thing callers read) match exactly.
        np.testing.assert_array_equal(t_k[live] < tmax[live], inside[live])


def _shared_args(T=300, n=2048):
    mesh, o3, d = _shared_case(T, n)
    ro = jnp.asarray(o3)
    consts, _, _, T_pad = mesh_intersect.shared_origin_constants(mesh, (0, T), ro)
    A, B, C = mesh_intersect.mesh_tri_vertices(mesh, (0, T))
    spheres = mesh_kernels.chunk_spheres(A, B, C, T, T_pad)
    return (mesh_kernels.shared_rows(consts, T_pad), spheres, jnp.asarray(d), ro)


def _general_args(T=300, n=2048):
    mesh, o, d, tmax = _general_case(T, n)
    cols, _, T_pad = mesh_intersect.general_ray_constants(mesh, (0, T))
    A, B, C = mesh_intersect.mesh_tri_vertices(mesh, (0, T))
    spheres = mesh_kernels.chunk_spheres(A, B, C, T, T_pad)
    mom = np.cross(o.T, d.T).T
    r10 = jnp.asarray(np.concatenate([d, mom, o, np.ones((1, d.shape[1]))]),
                      jnp.float32)
    return (mesh_kernels.general_rows(cols, T_pad), spheres, r10,
            jnp.asarray(tmax))


@pytest.mark.parametrize("walk", ["shared", "general"])
def test_walk_lowers_for_cuda(walk):
    """Each Triton kernel lowers for CUDA from this CPU host: a primitive the
    Triton route cannot lower, or a non-power-of-two load, fails here."""
    if walk == "shared":
        fn, args = mesh_kernels.shared_nearest_hit, _shared_args()
    else:
        fn, args = mesh_kernels.general_min_t, _general_args()
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


def test_sharded_triton_route_lowers_for_cuda():
    """The four-device sharded frame with the compiled Triton walks lowers
    for CUDA under shard_map's replication check (every pallas_call
    out_shape declares its vma)."""
    import __graft_entry__ as g
    from relativitypathtracer_tpu.parallel.tiles import (
        build_sharded_render_fn, default_mesh)
    from relativitypathtracer_tpu.render import FrameState

    scene, meta = g._demo_scene()
    mesh_intersect.PALLAS_MODE = True
    try:
        render = build_sharded_render_fn(meta, 64, 64, -1, default_mesh(4))
        text = render.trace(scene, FrameState.initial()).lower(
            lowering_platforms=("cuda",)).as_text()
    finally:
        mesh_intersect.PALLAS_MODE = None
    assert "xla.gpu.triton" in text


def test_route_gpu_uses_kernels(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert mesh_intersect.resolve_kernels() == (True, False)


def test_route_cpu_uses_scan(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert mesh_intersect.resolve_kernels() == (False, False)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_route_interpret_only_when_asked(platform, monkeypatch):
    """No platform falls back to interpret mode; only an explicit request
    (argument or PALLAS_MODE) runs it, and an explicit route wins over the
    platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert mesh_intersect.resolve_kernels("interpret") == (True, True)
    assert mesh_intersect.resolve_kernels(False) == (False, False)
    monkeypatch.setattr(mesh_intersect, "PALLAS_MODE", "interpret")
    assert mesh_intersect.resolve_kernels() == (True, True)


def test_bucket_order_front_to_back():
    """bucket_order lists every live chunk first, in non-decreasing bucket
    floor, each floor <= its chunk's true distance, ties in chunk-id order."""
    rng = np.random.default_rng(3)
    mind = jnp.asarray(rng.uniform(0, 10, (6, 70)), jnp.float32)
    overlap = jnp.asarray(rng.random((6, 70)) < 0.6)
    order, key, counts = map(np.asarray, mesh_kernels.bucket_order(mind, overlap))
    mind, overlap = np.asarray(mind), np.asarray(overlap)
    for b in range(6):
        n = counts[b]
        assert n == overlap[b].sum()
        live = order[b, :n]
        assert set(live) == set(np.nonzero(overlap[b])[0])
        floors = key[b, live]
        assert np.all(np.diff(floors) >= 0)
        assert np.all(floors <= mind[b, live] + 1e-6)
        same = np.diff(floors) == 0
        assert np.all(np.diff(live)[same] > 0)


@pytest.mark.gpu
def test_compiled_walks_match_scan(gpu):
    """On the card: the compiled Triton walks against the jnp scan."""
    m4 = np.eye(4, dtype=np.float32)
    mesh, o3, d = _shared_case(1100, n=8192)
    mesh = jax.tree.map(jnp.asarray, mesh)
    with jax.default_matmul_precision("highest"):
        t0, _, _, v0 = mesh_intersect.mesh_intersect_shared(
            mesh, (0, 1100), m4, m4, o3, d, use_pallas=False)
        t1, _, _, v1 = mesh_intersect.mesh_intersect_shared(
            mesh, (0, 1100), m4, m4, o3, d, use_pallas=True)
    hit = np.asarray(v0) & np.asarray(v1)
    assert np.mean(np.asarray(v0) == np.asarray(v1)) >= 0.999
    np.testing.assert_allclose(np.asarray(t1)[hit], np.asarray(t0)[hit],
                               rtol=1e-5)
