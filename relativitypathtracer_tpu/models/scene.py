"""Scene data model: SoA pytrees resident in device HBM + static host metadata.

The reference keeps the scene in host std::vectors mirrored bit-for-bit into
OpenCL buffers (/root/reference/Object.h:6-22, /root/reference/main.cpp:33-55).
The equivalent here is a structure-of-arrays pytree `device_put` once
into device memory; static quantities that shape the compiled program (object count,
types, which objects are meshes) live in `SceneMeta`, a plain-Python object
captured by closure at trace time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

SPHERE = 0
CUBE = 1
MESH = 2


class ObjectsSoA(NamedTuple):
    """Per-object arrays, leading dim = number of objects O.

    Mirrors struct Object (/root/reference/Object.h:6-22) as SoA. The
    frame-dependent fields (lorentz, inv_lorentz, stationary_cam) are NOT
    stored here: they are recomputed inside the jitted frame step from
    `velocity` and the camera state (see render.object_frames), replacing the
    reference's per-frame host recompute + buffer upload
    (/root/reference/Render.cpp:179-203).
    """

    m: jnp.ndarray  # (O, 4, 4) model matrix
    inv_m: jnp.ndarray  # (O, 4, 4)
    velocity: jnp.ndarray  # (O, 3) 3-velocity in units of c
    color: jnp.ndarray  # (O, 3)
    obj_type: jnp.ndarray  # (O,) int32: SPHERE/CUBE/MESH
    mesh_root: jnp.ndarray  # (O,) int32 octree root node index (-1 if not mesh)
    tex_offset: jnp.ndarray  # (O,) int32 byte offset into atlas (-1 if none)
    tex_w: jnp.ndarray  # (O,) int32
    tex_h: jnp.ndarray  # (O,) int32
    light: jnp.ndarray  # (O,) bool
    flash_period: jnp.ndarray  # (O,) f32
    flash_duration: jnp.ndarray  # (O,) f32


class MeshArrays(NamedTuple):
    """All meshes aggregated into shared flat pools, like the reference's
    single global Mesh (/root/reference/Mesh.h:5-16)."""

    vertices: jnp.ndarray  # (V, 3) f32
    tri_v: jnp.ndarray  # (T, 3) int32 vertex indices
    tri_uv: jnp.ndarray  # (T, 3) int32 uv indices
    tri_n: jnp.ndarray  # (T, 3) int32 normal indices
    uvs: jnp.ndarray  # (U, 2) f32
    normals: jnp.ndarray  # (NN, 3) f32
    # Flattened octree SoA (/root/reference/Octree.h:4-12)
    node_min: jnp.ndarray  # (Q, 3) f32
    node_max: jnp.ndarray  # (Q, 3) f32
    node_tris_index: jnp.ndarray  # (Q,) int32 into oct_tris
    node_tris_count: jnp.ndarray  # (Q,) int32
    node_children: jnp.ndarray  # (Q, 8) int32, -1 = leaf
    node_neighbors: jnp.ndarray  # (Q, 6) int32, -1 = outside
    oct_tris: jnp.ndarray  # (P,) int32 triangle-pool indices


class MeshStatic(NamedTuple):
    """Frame-invariant per-mesh-object inputs of the Triton mesh walks
    (ops.pallas.mesh_kernels), precomputed at scene build from the
    Morton-ordered triangles. Only the shared-origin constants depend on
    the per-frame camera event."""

    spheres: jnp.ndarray  # (n_chunks, 4) chunk bounding spheres
    gen_rows: jnp.ndarray  # (GENERAL_ROWS, T_pad) Plucker operators


class Scene(NamedTuple):
    objects: ObjectsSoA
    mesh: MeshArrays
    textures: jnp.ndarray  # (B,) uint8 interleaved-RGB atlas
    textures_packed: jnp.ndarray  # (R, 8) uint32 rows of R|G<<8|B<<16 texels
    tex_quads: jnp.ndarray  # (Rq, 8) uint32 footprint atlas: 4 texels per (x0, y0)
    tex_fp: jnp.ndarray  # (O, 6) int32 per-object footprint region [base rx ry wb rw rh]
    mesh_static: tuple  # MeshStatic per mesh object (meta.mesh_ids order)
    white_point: jnp.ndarray  # (3,) f32
    ambient: jnp.ndarray  # () f32


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (trace-time) facts about the scene. Hashable so renderers can be
    cached per scene shape."""

    num_objects: int
    sphere_ids: tuple  # indices of SPHERE objects
    cube_ids: tuple  # indices of CUBE objects
    mesh_ids: tuple  # indices of MESH objects
    mesh_roots: tuple  # octree root node index per mesh object (same order)
    mesh_tri_ranges: tuple  # (start, end) triangle-pool range per mesh object
    mesh_perms: tuple  # per mesh object: Morton-order triangle permutation
    light_ids: tuple  # indices of objects with light=True
    default_interval: int  # -1 normally, 0 if the scene contains the I command
    num_tris: int
    num_nodes: int
    max_octree_depth: int
    use_footprint_tex: bool = True  # small textures: 1-gather footprint atlas
    any_flash: bool = False  # scene contains proper-time flash objects


def _morton_perm(verts: np.ndarray, tri_v: np.ndarray, tri_ids: np.ndarray) -> tuple:
    """Morton (Z-curve) ordering of the given ABSOLUTE triangle ids by
    quantized centroid, so that fixed-size triangle chunks in the mesh walks
    are spatially tight and the chunk-vs-ray-cone culling actually
    skips work. Returns a tuple of python ints (hashable, lives in
    SceneMeta)."""
    if len(tri_ids) == 0:
        return ()
    tv = tri_v[tri_ids]
    cent = (verts[tv[:, 0]] + verts[tv[:, 1]] + verts[tv[:, 2]]) / 3.0
    lo_c = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo_c, 1e-12)
    q = np.minimum((1023.0 * (cent - lo_c) / span).astype(np.uint64), 1023)

    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return tuple(int(tri_ids[i]) for i in np.argsort(code, kind="stable"))


def _footprint_atlas(packed_texels: np.ndarray, texture_values: list, regions: list):
    """Precompute the reference's exact 4-tap bilinear footprint per integer
    (x0, y0): taps [(x0,y0), (x1,y0), (x1,y1), (x2,y1)] with x1=clip(x0+1),
    y1=clip(y0+1), x2=clip(x1-1) (the reference's border quirk,
    opencl_kernel.cl:427-470) stored as 4 consecutive u32 texels. One 32-byte
    row gather then fetches a pixel's whole footprint instead of four
    scattered taps, and each region covers only the texel
    rectangle its object can actually address (full texture for analytic-UV
    objects; the static uv-hull for meshes -- mesh uvs are barycentric convex
    combinations of the uv pool).

    regions: list of (byte_offset, x_lo, x_hi, y_lo, y_hi) texel rects.
    Returns ((Rq, 8) u32 atlas, {region: (base, rx, ry, rw)}): slot =
    base + block-tiled offset of (x0-rx, y0-ry) within the rect.
    """
    quads = []
    params = {}
    total = 0
    B = 16  # 16x16-texel blocks: screen-coherent samples hit compact memory
    dims = {int(texture_values[k]): (texture_values[k + 1], texture_values[k + 2])
            for k in range(0, len(texture_values), 3)}
    for region in dict.fromkeys(regions):  # dedupe, keep order
        off, xl, xh, yl, yh = region
        w, h = dims[int(off)]
        tex = packed_texels[off // 3: off // 3 + w * h].reshape(h, w)
        rw = xh - xl + 1
        rh = yh - yl + 1
        x0 = np.broadcast_to(np.arange(xl, xh + 1)[None, :], (rh, rw))
        y0 = np.broadcast_to(np.arange(yl, yh + 1)[:, None], (rh, rw))
        x1 = np.clip(x0 + 1, 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x2 = np.clip(x1 - 1, 0, w - 1)
        foot = np.stack(
            [tex[y0, x0], tex[y0, x1], tex[y1, x1], tex[y1, x2]], axis=-1
        )  # (rh, rw, 4)
        # 16x16-texel tiles in MORTON order over the (pow2-padded) tile grid
        # (ops.texture_layout): a screen block's 2D texel footprint then maps
        # to a compact 1D row range.
        from ..ops.texture_layout import (
            MAX_TILES_PER_AXIS, region_quads, region_tile_grid, tile_slot)

        wb = -(-rw // B)
        hb = -(-rh // B)
        assert max(wb, hb) <= MAX_TILES_PER_AXIS, "texture axis > 4096 texels"
        wb2, hb2 = region_tile_grid(np.int64(wb), np.int64(rh))
        tiled = np.zeros((hb * B, wb * B, 4), np.uint32)
        tiled[:rh, :rw] = foot
        lx = np.broadcast_to(np.arange(wb * B)[None, :], (hb * B, wb * B))
        ly = np.broadcast_to(np.arange(hb * B)[:, None], (hb * B, wb * B))
        slot = tile_slot(lx.astype(np.int64), ly.astype(np.int64),
                         np.int64(wb), np.int64(rh))
        out = np.zeros((int(wb2 * hb2) * B * B, 4), np.uint32)
        out[slot.reshape(-1)] = tiled.reshape(-1, 4)
        params[region] = (total, int(xl), int(yl), int(wb))
        quads.append(out)
        total += int(region_quads(np.int64(wb), np.int64(rh)))
    if not quads:
        quads = [np.zeros((2, 4), np.uint32)]
    flat = np.concatenate(quads, axis=0).reshape(-1)  # 4 u32 per footprint
    rows = -(-len(flat) // 8)
    return np.pad(flat, (0, rows * 8 - len(flat))).reshape(rows, 8), params


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32))


def build_scene(host) -> tuple[Scene, SceneMeta]:
    """Convert a parsed HostScene (models.dsl) into device arrays + meta."""
    o = host.objects
    num = len(o)

    def stack(attr, shape):
        if num == 0:
            return np.zeros((0, *shape), np.float32)
        return np.stack([np.asarray(getattr(ob, attr), np.float32).reshape(shape) for ob in o])

    m = stack("m", (4, 4))
    inv_m = stack("inv_m", (4, 4))
    velocity = stack("velocity", (3,))
    color = stack("color", (3,))
    types = np.array([ob.obj_type for ob in o], np.int32)
    mesh_root = np.array([ob.mesh_root for ob in o], np.int32)
    tex_offset = np.array([ob.tex_offset for ob in o], np.int32)
    tex_w = np.array([ob.tex_w for ob in o], np.int32)
    tex_h = np.array([ob.tex_h for ob in o], np.int32)
    light = np.array([ob.light for ob in o], bool)
    flash_period = np.array([ob.flash_period for ob in o], np.float32)
    flash_duration = np.array([ob.flash_duration for ob in o], np.float32)

    objects = ObjectsSoA(
        m=_f32(m), inv_m=_f32(inv_m), velocity=_f32(velocity), color=_f32(color),
        obj_type=_i32(types), mesh_root=_i32(mesh_root), tex_offset=_i32(tex_offset),
        tex_w=_i32(tex_w), tex_h=_i32(tex_h), light=jnp.asarray(light),
        flash_period=_f32(flash_period), flash_duration=_f32(flash_duration),
    )

    msh = host.mesh
    # Guarantee non-empty gatherable pools (XLA dislikes 0-sized gathers).
    verts = np.asarray(msh.vertices, np.float32).reshape(-1, 3) if len(msh.vertices) else np.zeros((1, 3), np.float32)
    tris = np.asarray(msh.triangles, np.int32).reshape(-1, 9) if len(msh.triangles) else np.zeros((0, 9), np.int32)
    uvs = np.asarray(msh.uvs, np.float32).reshape(-1, 2) if len(msh.uvs) else np.zeros((1, 2), np.float32)
    normals = np.asarray(msh.normals, np.float32).reshape(-1, 3) if len(msh.normals) else np.zeros((1, 3), np.float32)

    oct = msh.octree
    q = len(oct.node_min) if oct is not None and len(oct.node_min) else 0
    if q:
        node_min = np.asarray(oct.node_min, np.float32)
        node_max = np.asarray(oct.node_max, np.float32)
        node_tris_index = np.asarray(oct.node_tris_index, np.int32)
        node_tris_count = np.asarray(oct.node_tris_count, np.int32)
        node_children = np.asarray(oct.node_children, np.int32)
        node_neighbors = np.asarray(oct.node_neighbors, np.int32)
        oct_tris = np.asarray(oct.oct_tris, np.int32) if len(oct.oct_tris) else np.zeros((1,), np.int32)
    else:
        node_min = np.zeros((1, 3), np.float32)
        node_max = np.zeros((1, 3), np.float32)
        node_tris_index = np.zeros((1,), np.int32)
        node_tris_count = np.zeros((1,), np.int32)
        node_children = -np.ones((1, 8), np.int32)
        node_neighbors = -np.ones((1, 6), np.int32)
        oct_tris = np.zeros((1,), np.int32)

    mesh = MeshArrays(
        vertices=_f32(verts),
        tri_v=_i32(tris[:, 0::3]) if len(tris) else _i32(np.zeros((1, 3), np.int32)),
        tri_uv=_i32(tris[:, 1::3]) if len(tris) else _i32(np.zeros((1, 3), np.int32)),
        tri_n=_i32(tris[:, 2::3]) if len(tris) else _i32(np.zeros((1, 3), np.int32)),
        uvs=_f32(uvs), normals=_f32(normals),
        node_min=_f32(node_min), node_max=_f32(node_max),
        node_tris_index=_i32(node_tris_index), node_tris_count=_i32(node_tris_count),
        node_children=_i32(node_children), node_neighbors=_i32(node_neighbors),
        oct_tris=_i32(oct_tris),
    )

    tex_np = np.frombuffer(bytes(host.textures), np.uint8) if len(host.textures) else np.zeros((3,), np.uint8)
    textures = jnp.asarray(tex_np)
    packed = (
        tex_np[0::3].astype(np.uint32)
        | (tex_np[1::3].astype(np.uint32) << 8)
        | (tex_np[2::3].astype(np.uint32) << 16)
    )
    # Per-object addressable texel rect: analytic-UV objects (sphere/cube)
    # cover the full texture; mesh objects only the static uv-pool hull
    # (barycentric interpolation stays inside the hull; +/-2 texel margin
    # absorbs fp slack). An uv-less mesh (pool = {(0,0)}) collapses to a
    # handful of texels, keeping the footprint atlas tiny.
    uv_pool = np.asarray(msh.uvs, np.float32).reshape(-1, 2) if len(msh.uvs) else np.zeros((1, 2), np.float32)
    u_lo, v_lo = uv_pool.min(axis=0)
    u_hi, v_hi = uv_pool.max(axis=0)
    regions = []
    for i in range(num):
        off = int(tex_offset[i])
        if off < 0:
            regions.append(None)
            continue
        w_i, h_i = int(tex_w[i]), int(tex_h[i])
        if types[i] == MESH:
            xl = int(np.clip(np.floor(w_i * u_lo) - 2, 0, w_i - 1))
            xh = int(np.clip(np.floor(w_i * u_hi) + 2, 0, w_i - 1))
            yl = int(np.clip(np.floor(h_i * (1.0 - v_hi)) - 2, 0, h_i - 1))
            yh = int(np.clip(np.floor(h_i * (1.0 - v_lo)) + 2, 0, h_i - 1))
        else:
            xl, xh, yl, yh = 0, w_i - 1, 0, h_i - 1
        regions.append((off, xl, xh, yl, yh))
    quads, region_params = _footprint_atlas(
        packed, host.texture_values, [r for r in regions if r is not None]
    )
    tex_fp = np.zeros((num, 6), np.int32)
    for i, r in enumerate(regions):
        if r is None:
            continue
        base, rx, ry, wb = region_params[r]
        tex_fp[i] = (base, rx, ry, wb, r[2] - r[1] + 1, r[4] - r[3] + 1)
    rows = -(-len(packed) // 8)
    packed = np.pad(packed, (0, rows * 8 - len(packed))).reshape(rows, 8)
    mesh_ids = tuple(int(i) for i in np.nonzero(types == MESH)[0])
    tri_ranges = tuple(
        host.mesh.root_tri_ranges.get(int(mesh_root[i]), (0, len(tris))) for i in mesh_ids
    )
    # Per mesh object: the octree-reachable triangle set (SAT-culled, so
    # foreign tris from other meshes in the shared pool drop out exactly as
    # in the reference's walk), Morton-ordered, as ABSOLUTE triangle ids.
    perms = tuple(
        _morton_perm(
            verts,
            tris[:, 0::3].astype(np.int64),
            np.asarray(
                host.mesh.root_tri_lists.get(
                    int(mesh_root[i]), np.arange(rng[0], rng[1], dtype=np.int64)
                )
            ),
        )
        for i, rng in zip(mesh_ids, tri_ranges)
    )

    # Frame-invariant mesh walk inputs (chunk spheres, Plucker operators),
    # precomputed once per scene.
    from ..ops.mesh_intersect import general_ray_constants, mesh_tri_vertices, tri_count
    from ..ops.pallas.mesh_kernels import chunk_spheres, general_rows

    mesh_static = []
    for k, rng_pair in enumerate(tri_ranges):
        perm_arr = jnp.asarray(perms[k], jnp.int32) if perms[k] else None
        # T_k must be the ACTUAL row count of the kernel inputs: len(perm)
        # when the octree-reachable set is used (it can exclude foreign tris
        # from the shared pool, so it is NOT the seeded range length).
        T_k = tri_count(rng_pair, perm_arr)
        A, B, C = mesh_tri_vertices(mesh, rng_pair, perm_arr)
        cols_k, _, T_pad_k = general_ray_constants(mesh, rng_pair, perm_arr)
        mesh_static.append(MeshStatic(
            spheres=chunk_spheres(A, B, C, T_k, T_pad_k),
            gen_rows=general_rows(cols_k, T_pad_k),
        ))

    scene = Scene(
        objects=objects, mesh=mesh, textures=textures,
        textures_packed=jnp.asarray(packed),
        tex_quads=jnp.asarray(quads), tex_fp=_i32(tex_fp),
        mesh_static=tuple(mesh_static),
        white_point=_f32(host.white_point), ambient=jnp.float32(host.ambient),
    )

    meta = SceneMeta(
        num_objects=num,
        sphere_ids=tuple(int(i) for i in np.nonzero(types == SPHERE)[0]),
        cube_ids=tuple(int(i) for i in np.nonzero(types == CUBE)[0]),
        mesh_ids=mesh_ids,
        mesh_roots=tuple(int(mesh_root[i]) for i in mesh_ids),
        mesh_tri_ranges=tri_ranges,
        mesh_perms=perms,
        light_ids=tuple(int(i) for i in np.nonzero(light)[0]),
        default_interval=int(host.default_interval),
        num_tris=int(len(tris)),
        num_nodes=int(q) if q else 1,
        max_octree_depth=int(getattr(oct, "max_depth", 0) if oct is not None else 0),
        # XLA gather cost grows with table size; beyond ~48MB the 4-tap path
        # on the 4x smaller packed atlas wins over the 1-gather footprint
        # (real accesses are screen-coherent, so small 32-byte rows win).
        use_footprint_tex=bool(quads.size * 4 <= 48 * 1024 * 1024),
        any_flash=bool((flash_period > 0).any()),
    )
    return scene, meta
