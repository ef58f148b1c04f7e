"""Analytic intersector and mesh-intersection tests against closed forms.

Layout convention: rays on the LAST axis -- directions (3, N), origins (3,)
or (3, N).
"""

import jax.numpy as jnp
import numpy as np

from relativitypathtracer_tpu.models.scene import MeshArrays
from relativitypathtracer_tpu.ops.intersect import cube_intersect, sphere_intersect
from relativitypathtracer_tpu.ops.mesh_intersect import (
    mesh_intersect_shared,
    mesh_min_t_general,
)
from relativitypathtracer_tpu.ops.relmath import inverse4, trs

EYE = jnp.eye(4)


import pytest

pytestmark = pytest.mark.fast  # inner-loop subset


def cols(*vecs):
    """Row-vectors -> (3, N) column layout."""
    return jnp.asarray(np.asarray(vecs, np.float32).T)


def _mesh_of_tris(verts, tris, normals=None, uvs=None):
    T = len(tris)
    tri = jnp.asarray(tris, jnp.int32)
    return MeshArrays(
        vertices=jnp.asarray(verts, jnp.float32),
        tri_v=tri,
        tri_uv=jnp.zeros((T, 3), jnp.int32),
        tri_n=jnp.zeros((T, 3), jnp.int32),
        uvs=jnp.asarray(uvs if uvs is not None else [[0.0, 0.0]], jnp.float32),
        normals=jnp.asarray(normals if normals is not None else [[0.0, 0.0, 1.0]], jnp.float32),
        node_min=jnp.zeros((1, 3)), node_max=jnp.zeros((1, 3)),
        node_tris_index=jnp.zeros(1, dtype=jnp.int32), node_tris_count=jnp.zeros(1, dtype=jnp.int32),
        node_children=-jnp.ones((1, 8), jnp.int32), node_neighbors=-jnp.ones((1, 6), jnp.int32),
        oct_tris=jnp.zeros(1, dtype=jnp.int32),
    )


def test_sphere_head_on():
    o3 = jnp.array([0.0, 0.0, -5.0])
    t, n, uv, valid = sphere_intersect(EYE, o3, cols([0.0, 0.0, 1.0]))
    assert bool(valid[0])
    assert float(t[0]) == np.float32(4.0)
    np.testing.assert_allclose(np.asarray(n[:, 0]), [0, 0, -1], atol=1e-6)


def test_sphere_miss():
    o3 = jnp.array([0.0, 0.0, -5.0])
    _, _, _, valid = sphere_intersect(EYE, o3, cols([0.0, 1.0, 0.0]))
    assert not bool(valid[0])


def test_sphere_inside_hits_far_side():
    o3 = jnp.array([0.0, 0.0, 0.0])
    t, n, _, valid = sphere_intersect(EYE, o3, cols([0.0, 0.0, 1.0]))
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-6)


def test_sphere_scaled_translated():
    # Sphere of radius 2 at z=10: hit at z=8 -> t=8 for unit-speed ray.
    m = trs(jnp.array([0.0, 0, 10]), 0.0, jnp.zeros(3), jnp.array([2.0, 2, 2]))
    inv_m = inverse4(m)
    t, n, uv, valid = sphere_intersect(inv_m, jnp.zeros(3), cols([0.0, 0, 1]))
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 8.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(n[:, 0]), [0, 0, -1], atol=1e-6)


def test_sphere_uv_poles_and_seam():
    o3 = jnp.array([0.0, 0.0, -5.0])
    t, n, uv, valid = sphere_intersect(EYE, o3, cols([0.0, 0.0, 1.0]))
    # hit at (0,0,-1): u = 0.5 + atan2(-1, 0)/2pi = 0.25, v = 0.5
    np.testing.assert_allclose(np.asarray(uv[:, 0]), [0.25, 0.5], atol=1e-6)


def test_sphere_batch_layout():
    o3 = jnp.array([0.0, 0.0, -5.0])
    d3 = cols([0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.1, 0.0, 1.0])
    t, n, uv, valid = sphere_intersect(EYE, o3, d3)
    assert t.shape == (3,) and n.shape == (3, 3) and uv.shape == (2, 3)
    assert bool(valid[0]) and not bool(valid[1]) and bool(valid[2])


def test_cube_head_on():
    o3 = jnp.array([0.0, 0.0, -5.0])
    t, n, uv, valid = cube_intersect(EYE, o3, cols([0.0, 0.0, 1.0]))
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 4.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(n[:, 0]), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(uv[:, 0]), [0.5, 0.5], atol=1e-6)


def test_cube_inside_hits_inner_face():
    o3 = jnp.array([0.0, 0.0, 0.0])
    t, n, _, valid = cube_intersect(EYE, o3, cols([1.0, 0.0, 0.0]))
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)


def test_cube_rotated_30deg():
    m = trs(jnp.array([0.0, 0, 5]), jnp.pi / 6, jnp.array([0.0, 1, 0]), jnp.ones(3))
    inv_m = inverse4(m)
    t, n, _, valid = cube_intersect(inv_m, jnp.zeros(3), cols([0.0, 0, 1.0]))
    assert bool(valid[0])
    # Ray through the cube center: surface at 1/cos(30deg) before the center.
    np.testing.assert_allclose(float(t[0]), 5 - 1.0 / np.cos(np.pi / 6), rtol=1e-5)


def test_cube_miss():
    o3 = jnp.array([5.0, 5.0, -5.0])
    _, _, _, valid = cube_intersect(EYE, o3, cols([0.0, 0.0, 1.0]))
    assert not bool(valid[0])


def _grid_mesh(rng, g=5):
    gx, gy = np.meshgrid(np.linspace(-2, 2, g), np.linspace(-2, 2, g))
    gz = rng.uniform(-0.5, 0.5, (g, g))
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    quads = [
        (r * g + c, r * g + c + 1, (r + 1) * g + c + 1, (r + 1) * g + c)
        for r in range(g - 1)
        for c in range(g - 1)
    ]
    tris = np.array(
        [[q[0], q[1], q[2]] for q in quads] + [[q[0], q[2], q[3]] for q in quads],
        np.int32,
    )
    return verts, tris


def _scalar_best(verts, tris, o, d):
    dn = d / np.linalg.norm(d)
    best = 1e20
    for tri in tris:
        A, B, C = verts[tri[0]], verts[tri[1]], verts[tri[2]]
        e1, e2 = B - A, C - A
        p = np.cross(dn, e2)
        det = e1 @ p
        if abs(det) < 1e-7:
            continue
        tv = o - A
        u = tv @ p / det
        if u < 0 or u > 1:
            continue
        q = np.cross(tv, e1)
        v = dn @ q / det
        if v < 0 or u + v > 1:
            continue
        dist = e2 @ q / det
        if 0 <= dist < best:
            best = dist
    return best / np.linalg.norm(d) if best < 1e19 else 1e20


def test_mesh_shared_origin_matches_scalar_mt():
    rng = np.random.default_rng(7)
    verts, tris = _grid_mesh(rng)
    mesh = _mesh_of_tris(verts, tris)
    o = np.array([0.0, 0.0, -6.0], np.float32)
    dirs = rng.uniform(-0.4, 0.4, (128, 3)).astype(np.float32)
    dirs[:, 2] = 1.0
    t, _, _, valid = mesh_intersect_shared(
        mesh, (0, len(tris)), EYE, EYE, jnp.asarray(o), jnp.asarray(dirs.T)
    )
    t = np.asarray(t)
    mismatches = 0
    for i in range(128):
        ref = _scalar_best(verts, tris, o, dirs[i])
        if ref > 1e19:
            mismatches += 0 if t[i] > 1e19 else 1
        else:
            mismatches += 0 if np.isclose(t[i], ref, rtol=2e-3, atol=1e-4) else 1
    assert mismatches <= 2  # epsilon-boundary stragglers at mesh borders


def test_mesh_general_matches_shared_for_common_origin():
    rng = np.random.default_rng(3)
    verts, tris = _grid_mesh(rng, g=4)
    mesh = _mesh_of_tris(verts, tris)
    o = np.array([0.3, -0.2, -5.0], np.float32)
    dirs = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    dirs[:, 2] = 1.0
    t_shared, _, _, _ = mesh_intersect_shared(
        mesh, (0, len(tris)), EYE, EYE, jnp.asarray(o), jnp.asarray(dirs.T)
    )
    origins = jnp.broadcast_to(jnp.asarray(o)[:, None], (3, 64))
    t_general = mesh_min_t_general(
        mesh, (0, len(tris)), EYE, EYE, origins, jnp.asarray(dirs.T)
    )
    hit = np.asarray(t_shared) < 1e19
    np.testing.assert_allclose(
        np.asarray(t_general)[hit], np.asarray(t_shared)[hit], rtol=2e-3, atol=1e-4
    )


def test_mesh_backface_hits_allowed():
    # The reference MT accepts negative determinants (no backface culling).
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    mesh = _mesh_of_tris(verts, [[0, 2, 1]])  # reversed winding
    t, _, _, valid = mesh_intersect_shared(
        mesh, (0, 1), EYE, EYE, jnp.zeros(3), cols([0.0, 0, 1.0])
    )
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 2.0, rtol=1e-6)


def test_mesh_attributes_interpolated():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    normals = [[0, 0, -1], [0, 0, -1], [0, 0, -1]]
    uvs = [[0, 0], [1, 0], [0, 1]]
    mesh = _mesh_of_tris(verts, [[0, 1, 2]], normals=normals, uvs=uvs)
    mesh = mesh._replace(
        tri_n=jnp.array([[0, 1, 2]], jnp.int32), tri_uv=jnp.array([[0, 1, 2]], jnp.int32)
    )
    t, n, uv, valid = mesh_intersect_shared(
        mesh, (0, 1), EYE, EYE, jnp.zeros(3), cols([0.0, 0, 1.0])
    )
    assert bool(valid[0])
    np.testing.assert_allclose(np.asarray(n[:, 0]), [0, 0, -1], atol=1e-6)
    # Ray through the centroid region: hit point (0,0): barycentric of
    # (0,0) in that triangle -> uv = w0*(0,0)+u*(1,0)+v*(0,1) = (u, v)
    hit_uv = np.asarray(uv[:, 0])
    assert 0.0 <= hit_uv[0] <= 1.0 and 0.0 <= hit_uv[1] <= 1.0
