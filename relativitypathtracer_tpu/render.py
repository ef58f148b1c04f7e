"""The batched wavefront renderer: one jitted call per frame.

Wavefront re-design of the reference's per-pixel megakernel
(/root/reference/opencl_kernel.cl:620-660) and per-frame host driver
(/root/reference/Render.cpp:89-209):

- All per-frame matrix algebra (camera boost, per-object boost composition,
  stationaryCam) happens INSIDE the jitted step (`object_frames`), so the
  per-frame host->device traffic is a tiny FrameState pytree instead of the
  reference's full object-buffer rewrite (Render.cpp:202).
- Intersection is wavefront-style: dense ray batches against whole object
  groups (spheres/cubes vmapped, meshes through the culled Triton walks of
  ops.pallas.mesh_kernels on a GPU, or the jnp scan of ops.mesh_intersect),
  merged with a running nearest-hit reduce.
- LAYOUT: rays on the LAST axis everywhere ((3, N) vectors, (4, N)
  4-vectors). Per-pixel object attributes and 4x4 matrices are selected
  with (K, O) @ (O, N) one-hot products under HIGHEST precision.
- `interval` (the light-propagation toggle) is a Python-static argument: both
  values compile to their own specialized program, matching how the reference
  branches on it everywhere.

Per-frame semantics (boost composition order, 4D ray construction, shading,
shadow chain, tonemap) mirror trace()/intersect_scene()/sample_light()
(/root/reference/opencl_kernel.cl:361-604).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .models.scene import Scene, SceneMeta
from .ops.camera import camera_ray_dirs
from .ops.intersect import INF, cube_intersect, norm3, normalize3, sphere_intersect
from .ops.mesh_intersect import mesh_intersect_shared, mesh_min_t_general
from .ops.relmath import lorentz, matmul4, transform4
from .ops.texture_sample import bilinear_sample_footprint, bilinear_sample_packed
from .ops.tonemap import tonemap

MISS_COLOR = (0.15, 0.15, 0.25)
_GROUP_CHUNK = 8  # objects per vmapped intersection batch (bounds transients)


def _post_diag() -> str:
    """RPT_POST_DIAG (trace-time, DIAGNOSTIC ONLY -- renders a WRONG image):
    full-frame differential attribution of the post-intersect pipeline.
    Stage-isolated timings force materialization the fused graph never
    pays, so shares are measured as full-frame deltas with one piece
    stubbed out.
      "notex": hit_color = flat object color (texture sampling AND its
               address math dropped from the graph);
      "noswz": tile_unswizzle replaced by identity (image scrambled);
      "notm":  Hable tonemap curve replaced by identity (layout ops kept).
    Never set outside the attribution tools; parity/bench guard against it
    (bench.py aborts official runs with any RPT_POST_DIAG set)."""
    return os.environ.get("RPT_POST_DIAG", "").strip()


class FrameState(NamedTuple):
    """Serializable per-frame camera state; the only traced per-frame input.

    Mirrors the reference globals cameraVelocity/cameraPos
    (/root/reference/Render.cpp:10-11). cam_pos = (t, x, y, z); scene
    coordinate time lives in cam_pos[0].
    """

    cam_velocity: jnp.ndarray  # (3,) f32
    cam_pos: jnp.ndarray  # (4,) f32

    @staticmethod
    def initial():
        return FrameState(jnp.zeros(3, jnp.float32), jnp.zeros(4, jnp.float32))


def object_frames(objects, state: FrameState):
    """Per-object frame matrices, computed in-jit each frame.

    Mirrors /root/reference/Render.cpp:179-200:
      lorentz     = L(v_obj) @ L(-v_cam)   (camera frame -> object rest frame)
      inv_lorentz = L(v_cam) @ L(-v_obj)   (object rest frame -> camera frame)
      stationary_cam = lorentz @ cam_pos   (camera event in the object frame)
    """
    cam_l = lorentz(state.cam_velocity)
    cam_inv_l = lorentz(-state.cam_velocity)
    obj_l = lorentz(objects.velocity)  # (O, 4, 4)
    obj_inv_l = lorentz(-objects.velocity)
    L = matmul4(obj_l, cam_inv_l[None])
    inv_L = matmul4(cam_l[None], obj_inv_l)
    stat_cam = transform4(L, state.cam_pos[None, :])
    return L, inv_L, stat_cam


def _chunks(ids, n):
    ids = list(ids)
    return [tuple(ids[i:i + n]) for i in range(0, len(ids), n)]


def _merge_best(best, cand):
    t_b, n_b, uv_b, o_b = best
    t_c, n_c, uv_c, o_c = cand
    take = t_c < t_b
    return (
        jnp.where(take, t_c, t_b),
        jnp.where(take[None, :], n_c, n_b),
        jnp.where(take[None, :], uv_c, uv_b),
        jnp.where(take, o_c, o_b),
    )


def _group_nearest(intersect_fn, ids, inv_m, o3, d3):
    """Nearest hit within one vmapped object group.

    o3: (G, 3) shared or (G, 3, N) per-ray origins; d3: (G, 3, N).
    Returns per-ray (t (N,), normal (3, N), uv (2, N), global obj id (N,)).
    """
    t, nrm, uv, _ = jax.vmap(intersect_fn)(inv_m, o3, d3)  # (G, ...)
    gi = jnp.argmin(t, axis=0)  # (N,)
    onehot = jax.lax.broadcasted_iota(jnp.int32, t.shape, 0) == gi[None, :]
    t_min = jnp.min(t, axis=0)
    n_min = jnp.sum(jnp.where(onehot[:, None, :], nrm, 0.0), axis=0)
    uv_min = jnp.sum(jnp.where(onehot[:, None, :], uv, 0.0), axis=0)
    ids_col = jnp.asarray(ids, jnp.int32)[:, None]
    obj = jnp.sum(jnp.where(onehot, ids_col, 0), axis=0)
    return t_min, n_min, uv_min, obj


def gather_mats(mats, obj_onehot):
    """Per-pixel 4x4 matrix selection as one one-hot matmul.

    mats: (O, 4, 4); obj_onehot: (O, N) float 0/1. Returns (4, 4, N).
    """
    O = mats.shape[0]
    flat = mats.reshape(O, 16).T  # (16, O)
    return jnp.matmul(flat, obj_onehot).reshape(4, 4, -1)


def apply44_perpixel(m, v):
    """(4, 4, N) per-pixel matrices applied to (4, N) vectors."""
    return jnp.einsum("ijn,jn->in", m, v)


def intersect_scene(scene: Scene, meta: SceneMeta, L, stat_cam, dir4,
                    interval: int):
    """Nearest hit over all objects for rays sharing the camera origin.

    dir4: (4, N) = (interval, unit camera dir) in the camera frame;
    `interval` must match dir4's (static) time row -- the analytic object
    culling needs it as a Python value.
    Returns (t, normal (3, N), uv (2, N), obj_id, did_hit); normals live in
    the hit object's rest frame, t is the shared 4D ray parameter.
    """
    objects = scene.objects
    n_rays = dir4.shape[1]
    best = (
        jnp.full((n_rays,), INF),
        jnp.zeros((3, n_rays)),
        jnp.zeros((2, n_rays)),
        jnp.zeros((n_rays,), jnp.int32),
    )

    for fn, ids_all in ((sphere_intersect, meta.sphere_ids), (cube_intersect, meta.cube_ids)):
        for ids in _chunks(ids_all, _GROUP_CHUNK):
            idx = jnp.asarray(ids, jnp.int32)
            d4 = jnp.einsum("gij,jn->gin", L[idx], dir4)
            cand = _group_nearest(fn, ids, objects.inv_m[idx], stat_cam[idx][:, 1:4], d4[:, 1:4])
            best = _merge_best(best, cand)

    for k, i in enumerate(meta.mesh_ids):
        d4 = L[i] @ dir4  # (4, N)
        perm = jnp.asarray(meta.mesh_perms[k], jnp.int32) if meta.mesh_perms[k] else None
        t, n, uv, valid = mesh_intersect_shared(
            scene.mesh, meta.mesh_tri_ranges[k], objects.m[i], objects.inv_m[i],
            stat_cam[i, 1:4], d4[1:4], perm=perm, static=scene.mesh_static[k],
        )
        cand = (t, n, uv, jnp.full((n_rays,), i, jnp.int32))
        best = _merge_best(best, cand)

    t, normal, uv, obj = best
    return t, normal, uv, obj, t < INF


def scene_min_t(scene: Scene, meta: SceneMeta, L, origins4, dir3, interval: int, exclude_id: int,
                tmax=None):
    """Minimum hit parameter over all objects except `exclude_id`, for shadow
    rays with per-ray origins. Mirrors sample_light
    (/root/reference/opencl_kernel.cl:488-545). `tmax` optionally bounds the
    search (occlusion only matters closer than the light)."""
    objects = scene.objects
    n_rays = origins4.shape[1]
    dir4 = jnp.concatenate(
        [jnp.full((1, n_rays), float(interval)), normalize3(dir3)], axis=0
    )
    best = jnp.full((n_rays,), INF)

    sph = tuple(i for i in meta.sphere_ids if i != exclude_id)
    cub = tuple(i for i in meta.cube_ids if i != exclude_id)
    for fn, ids_all in ((sphere_intersect, sph), (cube_intersect, cub)):
        for ids in _chunks(ids_all, _GROUP_CHUNK):
            idx = jnp.asarray(ids, jnp.int32)
            o4 = jnp.einsum("gij,jn->gin", L[idx], origins4)
            d4 = jnp.einsum("gij,jn->gin", L[idx], dir4)
            t, _, _, _ = jax.vmap(fn)(objects.inv_m[idx], o4[:, 1:4], d4[:, 1:4])
            best = jnp.minimum(best, jnp.min(t, axis=0))

    for k, i in enumerate(meta.mesh_ids):
        if i == exclude_id:
            continue
        o4 = L[i] @ origins4
        d4 = L[i] @ dir4
        perm = jnp.asarray(meta.mesh_perms[k], jnp.int32) if meta.mesh_perms[k] else None
        t = mesh_min_t_general(
            scene.mesh, meta.mesh_tri_ranges[k], objects.m[i], objects.inv_m[i],
            o4[1:4], d4[1:4], perm=perm, tmax=tmax, static=scene.mesh_static[k],
        )
        best = jnp.minimum(best, t)
    return best


def hit_events(inv_L, obj_onehot_f, L_hit, stat_cam_hit, dir4, t, normal,
               did_hit):
    """Hit events reconstructed in the camera frame, normal-biased
    (opencl_kernel.cl:575-580): the origins of the shadow rays, (4, N)."""
    n_rays = dir4.shape[1]
    inv_L_hit = gather_mats(inv_L, obj_onehot_f)
    ray_dir_of = apply44_perpixel(L_hit, dir4)
    # Miss lanes carry t = INF; clamp so the (masked-out) lighting math
    # stays finite -- a NaN would poison block-wide reduces in the shadow
    # walk's early-termination test.
    hits_f = jnp.sum(did_hit.astype(jnp.float32))
    t_mean = jnp.sum(jnp.where(did_hit, t, 0.0)) / jnp.maximum(hits_f, 1.0)
    t_safe = jnp.where(did_hit, t, t_mean)
    normal_safe = jnp.where(did_hit[None, :], normal, 0.0)
    hit_pos_of = stat_cam_hit + ray_dir_of * t_safe
    hit_pos_of = hit_pos_of + jnp.concatenate(
        [jnp.zeros((1, n_rays)), normal_safe * 0.001], axis=0
    )
    return apply44_perpixel(inv_L_hit, hit_pos_of)


def light_rays(objects, L, inv_L, L_hit, hit_pos, normal, interval: int, i: int):
    """Frame-hopping retarded direction to light object i
    (opencl_kernel.cl:581-589). Returns (ld3 (3, N) camera-frame shadow-ray
    direction, ld3_of (3, N) the same in the hit object's frame, ndotl (N,),
    tmax (N,) the light distance in ray-parameter units)."""
    hit_pos_lf = L[i] @ hit_pos
    light_pos3 = objects.m[i][:3, 3]
    ld3_lf = light_pos3[:, None] - hit_pos_lf[1:4]
    ld_lf = jnp.concatenate(
        [float(interval) * norm3(ld3_lf)[None, :], ld3_lf], axis=0
    )
    ld = inv_L[i] @ ld_lf  # camera frame
    ld3_of = apply44_perpixel(L_hit, ld)[1:4]
    ndotl = jnp.sum(normal * normalize3(ld3_of), axis=0)
    return ld[1:4], ld3_of, ndotl, norm3(ld[1:4])


def shade(scene: Scene, meta: SceneMeta, L, inv_L, stat_cam, dirs, interval: int):
    """Full trace: nearest hit + texture/flash + ambient/emissive + per-light
    direct lighting with 4D shadow rays. dirs: (3, N) unit camera-frame dirs.
    Returns (color (3, N), aux dict)."""
    objects = scene.objects
    n_rays = dirs.shape[1]
    dir4 = jnp.concatenate([jnp.full((1, n_rays), float(interval)), dirs], axis=0)

    t, normal, uv, obj, did_hit = intersect_scene(scene, meta, L, stat_cam,
                                                  dir4, interval)

    n_obj = meta.num_objects
    obj_onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (n_obj, n_rays), 0) == obj[None, :]
    )
    obj_onehot_f = obj_onehot.astype(jnp.float32)

    # --- surface color: texture or flat, then proper-time flash (x2) ---
    # Per-pixel object attributes via ONE one-hot (K, O) @ (O, N) product.
    # Every table value is an integer < 2^24, exact in f32 under HIGHEST
    # precision; -1 sentinels round-trip exactly. With the footprint atlas
    # the table also carries each object's region-derived Morton addressing
    # constants [sm1 ss r16] (ops.texture_layout.tile_params, all <= 65536),
    # so the sampler skips the per-ray pow2-grid derivation and integer
    # division (bit-exact vs the 6-row form, test_sampler_9row_fp_matches_6row).
    int_tables = [objects.tex_offset, objects.tex_w, objects.tex_h]
    if meta.use_footprint_tex:
        from .ops.texture_layout import tile_params

        int_tables += [scene.tex_fp[:, k] for k in range(6)]
        int_tables += list(tile_params(scene.tex_fp[:, 3], scene.tex_fp[:, 5]))
    tbl = jnp.stack([jnp.asarray(c, jnp.float32) for c in int_tables])
    # Pin HIGHEST locally (not just via the renderer's ambient context): a
    # TF32 or bf16 pass would silently truncate large indices -- wrong
    # texels, not an error.
    with jax.default_matmul_precision("highest"):
        sel = jnp.matmul(tbl, obj_onehot_f).astype(jnp.int32)  # (K, N)
    tex_off = sel[0]
    textured = tex_off != -1
    tex_w = jnp.maximum(sel[1], 1)
    tex_h = jnp.maximum(sel[2], 1)
    flat_rgb = jnp.matmul(objects.color.T, obj_onehot_f)  # (3, N)
    if _post_diag() == "notex":
        # Diagnostic (wrong image): texture sampling + address math dropped
        # so a full-frame delta attributes their true fused cost.
        tex_rgb = flat_rgb
    elif meta.use_footprint_tex:
        tex_rgb = bilinear_sample_footprint(scene.tex_quads, sel[3:], tex_w,
                                            tex_h, uv)
    else:
        tex_rgb = bilinear_sample_packed(
            scene.textures_packed, jnp.maximum(tex_off, 0) // 3, tex_w, tex_h, uv
        )
    hit_color = jnp.where(textured[None, :], tex_rgb, flat_rgb)

    L_hit = gather_mats(L, obj_onehot_f)  # (4, 4, N)
    stat_cam_hit = jnp.matmul(stat_cam.T, obj_onehot_f)  # (4, N)
    if meta.any_flash:  # static: skip proper-time flash math entirely if unused
        period = jnp.matmul(objects.flash_period[None, :], obj_onehot_f)[0]
        duration = jnp.matmul(objects.flash_duration[None, :], obj_onehot_f)[0]
        event_t = stat_cam_hit[0] + jnp.sum(L_hit[0] * dir4, axis=0) * t
        safe_period = jnp.where(period > 0, period, 1.0)
        flashing = (period > 0) & (
            event_t - safe_period * jnp.floor(event_t / safe_period) < duration
        )
        hit_color = jnp.where(flashing[None, :], hit_color * 2.0, hit_color)

    # --- ambient + emissive (opencl_kernel.cl:567-571) ---
    ambient = scene.ambient if interval != 0 else jnp.float32(1.0)
    color = hit_color * ambient
    is_light = jnp.matmul(objects.light.astype(jnp.float32)[None, :],
                          obj_onehot_f)[0] > 0.5
    color = color + jnp.where(is_light[None, :], hit_color, 0.0)

    shadow_rays = jnp.zeros((), jnp.int32)
    if interval != 0 and meta.light_ids:
        hit_pos = hit_events(inv_L, obj_onehot_f, L_hit, stat_cam_hit, dir4,
                             t, normal, did_hit)
        for i in meta.light_ids:
            ld3, ld3_of, ndotl, tmax = light_rays(objects, L, inv_L, L_hit,
                                                  hit_pos, normal, interval, i)
            # Zero the search bound for lanes whose shadow result is masked
            # out anyway (miss / backfacing / the light itself): blocks with
            # no relevant lanes then terminate after their first chunk.
            relevant = did_hit & (obj != i) & (ndotl > 0)
            occ_t = scene_min_t(scene, meta, L, hit_pos, ld3, interval, i,
                                tmax=jnp.where(relevant, tmax, 0.0))
            lit = occ_t >= tmax

            llen = norm3(ld3_of)
            falloff = 1.0 / (1.0 + 0.1 * llen + 0.01 * (llen * llen))
            contrib = (ndotl * falloff)[None, :] * hit_color * objects.color[i][:, None]
            mask = relevant & objects.light[i] & lit
            color = color + jnp.where(mask[None, :], contrib, 0.0)
            shadow_rays = shadow_rays + jnp.sum(relevant.astype(jnp.int32))

    miss = jnp.asarray(MISS_COLOR, jnp.float32)
    color = jnp.where(did_hit[None, :], color, miss[:, None])
    aux = {"hits": jnp.sum(did_hit.astype(jnp.int32)), "shadow_rays": shadow_rays}
    return color, aux


TILE = 32  # pixel tile edge; tiles become ray blocks with tight bounding cones


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_swizzle(img_vec, ph, pw):
    """(k, PH*PW) row-major pixel axis -> tile-major order: 32x32 tiles,
    QUADRANT-major within each tile (four 16x16 quadrants of 256 lanes each),
    so the mesh kernels' 256-lane culling sub-cones cover compact squares
    instead of 8x32 strips."""
    k = img_vec.shape[0]
    h = TILE // 2
    x = img_vec.reshape(k, ph // TILE, 2, h, pw // TILE, 2, h)
    # -> (k, tile_r, tile_c, quad_r, quad_c, r, c)
    return x.transpose(0, 1, 4, 2, 5, 3, 6).reshape(k, ph * pw)


def tile_unswizzle(img_vec, ph, pw, p=TILE):
    """Inverse of the block-major quadrant-major pixel order: tile_swizzle
    for the default p=TILE; the sharded folded-msaa path passes the patch
    edge p=TILE//m (its per-pixel sample groups already averaged away)."""
    k = img_vec.shape[0]
    h = p // 2
    x = img_vec.reshape(k, ph // p, pw // p, 2, 2, h, h)
    return x.transpose(0, 1, 3, 5, 2, 4, 6).reshape(k, ph * pw)


def tile_unswizzle_hwc(img_vec, ph, pw, p=TILE):
    """(k, ph*pw) block-major -> (ph, pw, k) image: the unswizzle AND the
    channels-last transpose as ONE relayout op. The split pipeline
    (tile_unswizzle then .T before tonemap) pays two XLA transposes, so
    the fused variant (RPT_FUSED_OUT) moves tonemap BEFORE the relayout (elementwise -- commutes exactly) and emits the
    final image layout directly. Values are bit-identical to
    tile_unswizzle(v).T.reshape(ph, pw, k) (test_render_features)."""
    k = img_vec.shape[0]
    h = p // 2
    x = img_vec.reshape(k, ph // p, pw // p, 2, 2, h, h)
    return x.transpose(1, 3, 5, 2, 4, 6, 0).reshape(ph, pw, k)


def _fused_out() -> bool:
    """RPT_FUSED_OUT=1 (trace-time): tonemap on the swizzled (3, N) layout,
    then ONE fused unswizzle+HWC relayout (tile_unswizzle_hwc) instead of
    unswizzle + .T. Exact; default OFF until measured on the card."""
    return os.environ.get("RPT_FUSED_OUT", "").strip() == "1"


def msaa_swizzle(dirs_samples, ph, pw, m):
    """Fold msaa^2 sample sets into the ray axis, patch-major: each
    1024-lane kernel block covers a (32/m)^2-pixel patch WITH ALL ITS
    SAMPLES (sample index minor), split into four 256-lane quadrants. The
    per-pixel samples are near-identical rays, so block/sub-cones stay as
    tight as (or tighter than) the msaa=1 tiles.

    The single-device renderer defaults to the sequential per-sample loop
    (RPT_MSAA_FOLD=1 opts into the fold). The fold is the multi-device msaa
    structure (parallel.tiles): folding keeps every device's shard a whole
    number of culling blocks.

    dirs_samples: (m*m, ph, pw, 3). Returns (3, ph*pw*m*m).
    """
    p = TILE // m  # pixel patch edge
    h = p // 2
    x = dirs_samples.transpose(3, 1, 2, 0)  # (3, ph, pw, S)
    x = x.reshape(3, ph // p, 2, h, pw // p, 2, h, m * m)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7)  # (3, pr, pc, qr, qc, r, c, S)
    return x.reshape(3, ph * pw * m * m)


def msaa_mean_unswizzle(vec, ph, pw, m):
    """Average the folded samples and restore row-major pixel order.
    vec: (k, ph*pw*m*m) in msaa_swizzle order. Returns (k, ph*pw)."""
    k = vec.shape[0]
    p = TILE // m
    h = p // 2
    x = vec.reshape(k, ph // p, pw // p, 2, 2, h, h, m * m).mean(axis=7)
    return x.transpose(0, 1, 3, 5, 2, 4, 6).reshape(k, ph * pw)


@functools.lru_cache(maxsize=64)
def build_render_fn(meta: SceneMeta, width: int, height: int, interval: int,
                    msaa: int = 1, with_aux: bool = False,
                    out_uint8: bool = False):
    """Compile a frame renderer specialized to (scene meta, resolution,
    interval). Returns render(scene, state) -> (H, W, 3) float image
    (bottom-up row order, matching the reference's GL output).

    out_uint8 packs the frame to uint8 ON DEVICE (same truncation semantics
    as utils.image.to_uint8): the interactive viewer fetches 1.5 MB/frame
    instead of 6 MB of f32 -- the reference's analog is the GL buffer never
    leaving the GPU (gl_interop.cpp:51-67).

    Internally the pixel grid is padded to 32x32 tiles and rays are processed
    in tile-major order, so every 1024-ray culling block of the mesh walks
    is a compact screen tile with a tight bounding cone (effective chunk
    culling). The padding is cropped after shading.
    """
    ph = _round_up(height, TILE)
    pw = _round_up(width, TILE)

    # Camera rays are state-independent (the camera sits at the origin of its
    # own frame; boosts happen per object): precompute them once, already
    # swizzled, and close over the device constant.
    dirs = camera_ray_dirs(width, height, msaa, pad_width=pw, pad_height=ph)
    # The sequential per-sample loop (the reference's structure,
    # opencl_kernel.cl:642-648) is the DEFAULT: full 32x32 tiles keep walks
    # shorter than the fold's (32/m)^2 patches, whose blocks intersect more
    # chunks each. RPT_MSAA_FOLD=1 (trace-time) opts into the folded
    # single-pass layout; patch swizzle needs msaa | 32, patch >= 2.
    folded = (msaa in (2, 4, 8, 16)
              and os.environ.get("RPT_MSAA_FOLD", "0").strip() == "1")
    if msaa == 1:
        dirs_const = jax.device_put(
            tile_swizzle(dirs.reshape(-1, 3).T, ph, pw)[None])
    elif folded:
        # ONE shade pass over all msaa^2 samples folded into the ray axis
        # (msaa_swizzle); the sequential per-sample loop re-ran every
        # pipeline stage msaa^2 times.
        dirs_const = jax.device_put(msaa_swizzle(dirs, ph, pw, msaa)[None])
    else:
        dirs_const = jax.device_put(jnp.stack(
            [tile_swizzle(dirs[s].reshape(-1, 3).T, ph, pw)
             for s in range(dirs.shape[0])]))  # (S, 3, N)

    def render(scene: Scene, state: FrameState):
        # f32 matmul semantics: a TF32 or bf16 pass loses ~1e-3 relative
        # precision, visibly off vs the fp32 reference; force exact.
        with jax.default_matmul_precision("highest"):
            return _render_body(scene, state)

    def _render_body(scene: Scene, state: FrameState):
        L, inv_L, stat_cam = object_frames(scene.objects, state)
        if folded:
            c, aux_acc = shade(scene, meta, L, inv_L, stat_cam, dirs_const[0],
                               interval)
            color = msaa_mean_unswizzle(c, ph, pw, msaa)
        else:
            acc = jnp.zeros((3, ph * pw))
            aux_acc = None
            for s in range(dirs_const.shape[0]):
                c, aux = shade(scene, meta, L, inv_L, stat_cam, dirs_const[s],
                               interval)
                acc = acc + c
                aux_acc = (aux if aux_acc is None
                           else jax.tree.map(jnp.add, aux_acc, aux))
            c_mean = acc / float(dirs_const.shape[0])
            color = None
            if _fused_out() and not _post_diag():
                # tonemap first (elementwise, fuses into the shade tail),
                # then ONE relayout straight to the image layout instead of
                # unswizzle + .T (two XLA transposes).
                from .ops.tonemap import hable

                tm = jnp.minimum(
                    hable(c_mean) / hable(scene.white_point)[:, None], 1.0)
                img = tile_unswizzle_hwc(tm, ph, pw)
            else:
                color = (c_mean if _post_diag() == "noswz"  # diag: scrambled
                         else tile_unswizzle(c_mean, ph, pw))
        if color is not None and _post_diag() == "notm":  # diag: no curve
            img = color.T.reshape(ph, pw, 3)
        elif color is not None:
            img = tonemap(color.T, scene.white_point).reshape(ph, pw, 3)
        img = img[:height, :width]
        if out_uint8:
            img = (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
        if with_aux:
            return img, aux_acc
        return img

    return jax.jit(render)


@functools.lru_cache(maxsize=16)
def build_viewer_render_fn(meta: SceneMeta, pad_height: int, pad_width: int,
                           interval: int, pool: int = 1):
    """Resolution-POLYMORPHIC live-viewer renderer (msaa=1).

    Unlike build_render_fn (camera rays closed over as a device constant,
    so every (width, height) is a distinct compile), the swizzled ray
    directions are a TRACED ARGUMENT over a static padded grid: any logical
    size whose 32-aligned pad fits (pad_height, pad_width) renders through
    ONE compiled executable. A live resize then costs a host-side dirs
    recompute + device_put (~ms) instead of a fresh XLA compile -- the
    answer here to the reference's instant VBO re-allocation
    (Render.cpp:100-119): keep the compiled shape static, vary the logical
    content. Off-sensor padding lanes render and are cropped on the host
    after the fetch.

    pool > 1 additionally box-filters the tonemapped frame on DEVICE by
    pool x pool before the uint8 pack: the viewer's per-frame image fetch
    shrinks by pool^2 (960x544: 1.57 -> 0.39 MB at pool=2), which is the
    wall-fps lever when that fetch dominates the loop.

    Returns render(scene, state, dirs_t) -> (pad_h/pool, pad_w/pool, 3)
    uint8, bottom-up; dirs_t from viewer_dirs(). Crop to the logical size
    on the host.
    """
    ph, pw = int(pad_height), int(pad_width)
    if ph % TILE or pw % TILE:
        raise ValueError(f"pad {pw}x{ph} not {TILE}-aligned")
    if pool not in (1, 2, 4):
        raise ValueError(f"pool must be 1/2/4, got {pool}")

    @jax.jit
    def render(scene: Scene, state: FrameState, dirs_t):
        with jax.default_matmul_precision("highest"):
            L, inv_L, stat_cam = object_frames(scene.objects, state)
            c, _aux = shade(scene, meta, L, inv_L, stat_cam, dirs_t, interval)
            img = tonemap(tile_unswizzle(c, ph, pw).T, scene.white_point)
            img = img.reshape(ph, pw, 3)
            if pool > 1:
                img = img.reshape(ph // pool, pool, pw // pool, pool,
                                  3).mean(axis=(1, 3))
            return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    return render


def viewer_dirs(width: int, height: int, pad_height: int, pad_width: int):
    """Swizzled (3, pad_h*pad_w) camera dirs for the polymorphic viewer
    renderer: projection uses the LOGICAL size, the grid is the PAD."""
    dirs = camera_ray_dirs(width, height, 1, pad_width=pad_width,
                           pad_height=pad_height)
    return jax.device_put(
        tile_swizzle(jnp.asarray(dirs).reshape(-1, 3).T, pad_height, pad_width))


def render_frame(scene: Scene, meta: SceneMeta, state: FrameState,
                 width: int, height: int, interval: int | None = None, msaa: int = 1):
    """Convenience single-frame entry point."""
    if interval is None:
        interval = meta.default_interval
    fn = build_render_fn(meta, width, height, int(interval), msaa)
    return fn(scene, state)
