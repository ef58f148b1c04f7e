"""Procedural large-mesh fixture tests (utils.subdiv).

Midpoint subdivision grows the flagship mesh to the 300k-triangle tier that
the Triton walk handles on the card (utils.largedemo); the tier itself runs
there, not here.
"""

import numpy as np


def test_subdivision_watertight():
    """Midpoint subdivision: 4x triangles per level, shared-edge midpoints
    deduplicated (watertight), surface points preserved."""
    from relativitypathtracer_tpu.utils.subdiv import subdivide

    verts = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (1.0, 1.0, 0.0)]
    faces = [(0, 1, 2), (1, 3, 2)]
    v2, f2 = subdivide(list(verts), list(faces), 2)
    assert len(f2) == 2 * 16
    # shared edge (1, 2) midpoints deduplicated: v = 4 + unique edge midpoints
    # level 1: 5 unique edges -> 9 verts; level 2: 9 + 16 edges... just check
    # no duplicate coordinates (watertightness proxy)
    arr = np.asarray(v2)
    assert len(np.unique(arr.round(9), axis=0)) == len(arr)
    # all vertices stay on the z=0 plane (midpoints preserve the surface)
    assert np.abs(arr[:, 2]).max() == 0.0
