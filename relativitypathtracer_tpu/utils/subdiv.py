"""Midpoint subdivision and OBJ writing for procedural meshes.

The reference's capability envelope includes arbitrary-size OBJs through its
depth-6 octree (/root/reference/Octree.cpp:171-248); its shipped corpus tops
out at a 4,968-triangle bunny. Midpoint subdivision quadruples the triangle
count per level while preserving the surface, so the flagship mesh
(utils.demo_scenes) grows to large-mesh sizes (utils.largedemo) without
binary assets in the repository. Meshes are written as plain OBJs and
loaded through the normal loader, so smooth normals, octree build and scene
construction follow the exact reference semantics
(/root/reference/Render.cpp:436-538).
"""

from __future__ import annotations


def subdivide(verts, faces, levels: int):
    """Midpoint (1:4) subdivision: each edge gains its midpoint, each
    triangle splits into 4. Shared-edge midpoints are deduplicated so the
    surface stays watertight (smooth normals then interpolate correctly)."""
    for _ in range(levels):
        mid = {}

        def midpoint(a, b):
            key = (a, b) if a < b else (b, a)
            m = mid.get(key)
            if m is None:
                va, vb = verts[a], verts[b]
                verts.append(((va[0] + vb[0]) / 2.0, (va[1] + vb[1]) / 2.0,
                              (va[2] + vb[2]) / 2.0))
                m = len(verts) - 1
                mid[key] = m
            return m

        out = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = out
    return verts, faces


def write_obj(path: str, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
