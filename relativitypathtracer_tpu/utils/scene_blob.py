"""Binary scene-blob serialization for the native CPU oracle renderer.

The C++ oracle (native/cpu_reference.cpp) renders from a flat binary snapshot
of the device scene + one frame's precomputed matrices. Python owns all scene
construction (parsing, OBJ, octree, textures -- already unit-tested); the C++
side owns only the per-pixel render algorithm, mirroring how the reference
feeds host-built buffers to its kernel (/root/reference/main.cpp:33-55).

Layout (little-endian): see native/cpu_reference.cpp `readBlob` for the
consuming side. Version bumps must change MAGIC_VERSION on both sides.
"""

from __future__ import annotations

import struct

import numpy as np

from ..render import FrameState

MAGIC = b"RPTB"
MAGIC_VERSION = 3


def _lorentz_np(v: np.ndarray) -> np.ndarray:
    """Host float32 boost matrices; numpy mirror of ops.relmath.lorentz.

    The blob's matrices MUST be computed on host: an eager jnp call on an
    accelerator may run the 4x4 matmuls at reduced (TF32 or bf16) default
    precision, feeding the oracle ~1e-3-degraded Lorentz matrices -- which
    shows up as percent-level false parity failures in minified-texture
    regions (root-caused on rulers.txt/cubes.txt at 1024x768).
    """
    v = np.asarray(v, np.float32)
    vsqr = np.sum(v * v, axis=-1)
    gamma = (1.0 / np.sqrt(1.0 - vsqr)).astype(np.float32)
    safe_vsqr = np.where(vsqr == 0.0, np.float32(1.0), vsqr)
    g1 = ((gamma - 1.0) / safe_vsqr).astype(np.float32)
    vg = (-v * gamma[..., None]).astype(np.float32)
    top = np.concatenate([gamma[..., None], vg], axis=-1)
    outer = v[..., :, None] * v[..., None, :]
    spatial = (np.eye(3, dtype=np.float32) + g1[..., None, None] * outer).astype(np.float32)
    rows = np.concatenate([vg[..., :, None], spatial], axis=-1)
    M = np.concatenate([top[..., None, :], rows], axis=-2)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), M.shape)
    return np.where(vsqr[..., None, None] == 0.0, eye, M).astype(np.float32)


def _object_frames_np(objects, state: FrameState):
    """Host mirror of render.object_frames (fp32, exact CPU arithmetic)."""
    vel = np.asarray(objects.velocity, np.float32)
    cam_v = np.asarray(state.cam_velocity, np.float32)
    cam_pos = np.asarray(state.cam_pos, np.float32)
    cam_l = _lorentz_np(cam_v)
    cam_inv_l = _lorentz_np(-cam_v)
    obj_l = _lorentz_np(vel)
    obj_inv_l = _lorentz_np(-vel)
    L = obj_l @ cam_inv_l[None]
    inv_L = cam_l[None] @ obj_inv_l
    stat_cam = np.einsum("oij,j->oi", L, cam_pos).astype(np.float32)
    return L.astype(np.float32), inv_L.astype(np.float32), stat_cam


def scene_blob(scene, meta, state: FrameState, width: int, height: int,
               interval: int | None = None) -> bytes:
    """Serialize scene + frame matrices for one deterministic frame."""
    if interval is None:
        interval = meta.default_interval
    L, inv_L, stat_cam = _object_frames_np(scene.objects, state)
    o = scene.objects

    out = bytearray()
    out += MAGIC
    out += struct.pack("<IIIi", MAGIC_VERSION, width, height, int(interval))
    out += np.asarray(scene.white_point, np.float32).tobytes()
    out += struct.pack("<f", float(scene.ambient))

    n = meta.num_objects
    out += struct.pack("<I", n)
    m = np.asarray(o.m, np.float32)
    inv_m = np.asarray(o.inv_m, np.float32)
    for i in range(n):
        out += m[i].tobytes()
        out += inv_m[i].tobytes()
        out += L[i].tobytes()
        out += inv_L[i].tobytes()
        out += stat_cam[i].tobytes()
        out += np.asarray(o.color[i], np.float32).tobytes()
        out += struct.pack(
            "<iiiiiiff",
            int(o.obj_type[i]), int(o.mesh_root[i]), int(o.tex_offset[i]),
            int(o.tex_w[i]), int(o.tex_h[i]), int(bool(o.light[i])),
            float(o.flash_period[i]), float(o.flash_duration[i]),
        )

    msh = scene.mesh
    verts = np.asarray(msh.vertices, np.float32)
    out += struct.pack("<I", verts.shape[0]) + verts.tobytes()
    tri = np.stack(
        [np.asarray(msh.tri_v, np.int32), np.asarray(msh.tri_uv, np.int32),
         np.asarray(msh.tri_n, np.int32)], axis=-1,
    ).reshape(-1, 9)  # interleaved [v, uv, n] x 3 like the reference stream
    out += struct.pack("<I", tri.shape[0]) + tri.astype(np.int32).tobytes()
    uvs = np.asarray(msh.uvs, np.float32)
    out += struct.pack("<I", uvs.shape[0]) + uvs.tobytes()
    normals = np.asarray(msh.normals, np.float32)
    out += struct.pack("<I", normals.shape[0]) + normals.tobytes()

    q = np.asarray(msh.node_min, np.float32).shape[0]
    out += struct.pack("<I", q)
    node_min = np.asarray(msh.node_min, np.float32)
    node_max = np.asarray(msh.node_max, np.float32)
    tidx = np.asarray(msh.node_tris_index, np.int32)
    tcnt = np.asarray(msh.node_tris_count, np.int32)
    ch = np.asarray(msh.node_children, np.int32)
    nb = np.asarray(msh.node_neighbors, np.int32)
    for i in range(q):
        out += node_min[i].tobytes() + node_max[i].tobytes()
        out += struct.pack("<ii", int(tidx[i]), int(tcnt[i]))
        out += ch[i].tobytes() + nb[i].tobytes()

    oct_tris = np.asarray(msh.oct_tris, np.int32)
    out += struct.pack("<I", oct_tris.shape[0]) + oct_tris.tobytes()

    tex = np.asarray(scene.textures, np.uint8)
    out += struct.pack("<Q", tex.shape[0]) + tex.tobytes()
    return bytes(out)


def write_scene_blob(path: str, scene, meta, state, width, height, interval=None):
    with open(path, "wb") as f:
        f.write(scene_blob(scene, meta, state, width, height, interval))
