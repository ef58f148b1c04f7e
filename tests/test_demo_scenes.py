"""The in-repository flagship scene (utils.demo_scenes)."""

from collections import Counter

import numpy as np

from relativitypathtracer_tpu.models.scene import CUBE, MESH, SPHERE
from relativitypathtracer_tpu.utils.demo_scenes import (
    displaced_mesh, flagship_host)


def test_flagship_mesh_closed_nonconvex_5k():
    """5,120 triangles; every edge shared by exactly two faces with opposite
    orientation (closed, consistently wound); some vertex lies inside the
    hull of the others' radii (dents), so the mesh shadows itself."""
    verts, faces = displaced_mesh(0)
    assert len(faces) == 5120
    edges = Counter()
    for a, b, c in faces:
        for e in ((a, b), (b, c), (c, a)):
            edges[e] += 1
    assert all(n == 1 for n in edges.values()), "duplicate directed edge"
    assert all(edges[(b, a)] == 1 for (a, b) in edges), "open edge"
    r = np.linalg.norm(verts, axis=1)
    assert r.min() < 0.8 and r.max() > 1.2  # dents and bumps
    # deterministic from the seed, different across seeds
    np.testing.assert_array_equal(verts, displaced_mesh(0)[0])
    assert not np.allclose(verts, displaced_mesh(1)[0])


def test_flagship_host_objects():
    host = flagship_host(0)
    kinds = [o.obj_type for o in host.objects]
    assert kinds == [MESH, SPHERE, CUBE]
    mesh, light, cube = host.objects
    assert len(host.mesh.triangles) // 9 == 5120
    assert light.light and np.linalg.norm(light.velocity) > 0
    assert cube.tex_offset == 0 and cube.tex_w == cube.tex_h == 64
    assert cube.flash_period > 0 and host.default_interval == -1
    assert len(host.textures) == 64 * 64 * 3
