"""The flagship scene, built from a seed inside the repository.

It carries the mechanisms of the reference corpus's bunny.txt at its size
(/root/reference/Scenes/bunny.txt; SURVEY.md C22): one closed, NON-CONVEX
mesh of ~5k triangles without uvs or normals (so smooth normals, the
octree and the Morton order take the real loader path, and the mesh
shadows itself), a moving point-light sphere under the retarded-time light
cone (interval -1), and an analytic cube with a small procedural texture
and a proper-time flash.

The mesh is a level-4 icosphere (5,120 triangles) with a seeded radial
displacement, written as an OBJ (utils.subdiv.write_obj) and read back
through models.dsl / models.obj_loader. `levels` > 0 midpoint-subdivides it
further (4x triangles per level; 3 levels = 327,680 triangles) without
changing its surface. Textures go straight into the atlas: no image files.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

ICO_LEVELS = 4  # 20 * 4^4 = 5,120 triangles
TEX = 64  # procedural cube texture edge (texels)


def icosphere(levels: int = ICO_LEVELS):
    """Unit icosphere: (verts list of 3-tuples, faces list of index triples),
    outward-wound, each level splitting every face in four and projecting the
    new vertices onto the sphere."""
    from .subdiv import subdivide

    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(np.asarray(v) / np.linalg.norm(v)) for v in verts]
    for _ in range(levels):
        verts, faces = subdivide(verts, faces, 1)
        verts = [tuple(np.asarray(v) / np.linalg.norm(v)) for v in verts]
    return verts, faces


def displaced_mesh(seed: int, levels: int = 0):
    """The flagship mesh: the unit icosphere pushed in and out along its
    radii by a seeded sum of 24 Gaussian bumps and dents (amplitude up to
    0.45), so they cast shadows on the surface. `levels` extra midpoint
    subdivisions keep the surface. Returns (verts (V, 3) f64, faces list)."""
    from .subdiv import subdivide

    rng = np.random.default_rng(seed)
    verts, faces = icosphere()
    v = np.asarray(verts, np.float64)
    centers = rng.normal(size=(24, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amp = rng.uniform(0.2, 0.45, 24) * rng.choice([-1.0, 1.0], 24)
    width = rng.uniform(0.15, 0.35, 24)
    d2 = np.sum((v[:, None, :] - centers[None]) ** 2, axis=-1)
    r = 1.0 + np.sum(amp * np.exp(-d2 / width ** 2), axis=1)
    v = v * r[:, None]
    if levels:
        verts, faces = subdivide([tuple(p) for p in v], faces, levels)
        v = np.asarray(verts, np.float64)
    return v, faces


def checker_texture(seed: int, size: int = TEX) -> np.ndarray:
    """(size, size, 3) uint8: an 8x8-texel checkerboard with seeded colors
    and per-texel noise, so bilinear footprints see real gradients."""
    rng = np.random.default_rng(seed + 1)
    y, x = np.mgrid[0:size, 0:size]
    check = ((x // 8 + y // 8) % 2).astype(np.float64)
    a, b = rng.uniform(40, 215, (2, 3))
    rgb = a + (b - a) * check[..., None] + rng.uniform(-30, 30, (size, size, 3))
    return np.clip(rgb, 0, 255).astype(np.uint8)


SCENE = """M{obj}
Om0
 p0,-0.2,5.5,0.6,0.3,1,0.2,2,2,2
 c0.8,0.5,0.3
Os
 p1.6,2.2,3.4,0,0,0,0,0.2,0.2,0.2
 c1,1,1
 l1
 v0.5,0,0
Oc
 p-2.3,-1.6,5,0.7,1,1,0,0.8,0.8,0.8
 c0.9,0.9,0.9
 v0,0.3,0
 f2,0.5
A0.2
R
"""


def flagship_host(seed: int = 0, levels: int = 0):
    """Parsed HostScene of the flagship scene (models.dsl semantics): the
    displaced mesh at object 0, the moving light at 1, the textured,
    flashing cube at 2."""
    from ..models.dsl import parse_scene
    from .subdiv import write_obj

    verts, faces = displaced_mesh(seed, levels)
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "flagship.obj")
        write_obj(obj, verts, faces)
        host = parse_scene(SCENE.format(obj="flagship.obj"), tmp)
    tex = checker_texture(seed)
    offset = len(host.textures)
    host.texture_values.extend([offset, TEX, TEX])
    host.textures.extend(tex.tobytes())
    cube = host.objects[2]
    cube.tex_offset, cube.tex_w, cube.tex_h = offset, TEX, TEX
    return host


def flagship_scene(seed: int = 0, levels: int = 0):
    """(Scene, SceneMeta) of the flagship scene, ready for build_render_fn."""
    from ..models.scene import build_scene

    return build_scene(flagship_host(seed, levels))
