"""Culled ray/triangle mesh walks: XLA live-list builders + Triton kernels.

The jnp mesh path (ops.mesh_intersect) tests every triangle against every
ray and materializes (T_chunk, N) products in device memory. These kernels
walk only the triangle chunks that can matter for each ray group and keep
every intermediate in registers.

This is the wavefront answer to the reference's per-pixel octree walk
(/root/reference/opencl_kernel.cl:200-308): triangles are Morton-ordered so
each fixed-size chunk of TC triangles is spatially tight, and culling
happens OUTSIDE the kernel as a dense cone-vs-sphere test per (ray block,
chunk); each block gets a front-to-back live-chunk list. A Triton program
owns RAYS rays of one block, loads the block's list from global memory and
walks it with a while loop of dynamic trip count, stopping once every
lane's search bound is nearer than the next chunk's bucket floor.

Kernel 1 (shared origin, primary rays): per-triangle constants (det/u/v
rows + t scalar) against unit ray dirs. Returns (t, tri); barycentrics and
surface attributes are recomputed for the winning triangle after the walk
(ops.mesh_intersect.finalize_best_hit).
Kernel 2 (general origin, shadow rays): Plucker-lifted rays against the
per-triangle factor operators, min-t only, search bounded at the light.

Both contract K=3..6 as explicit f32 multiply-adds (no dot, so no TF32).
Acceptance semantics are the reference Moller-Trumbore
(/root/reference/opencl_kernel.cl:106-126): epsilon test on det, backface
hits allowed, u/v in-triangle tests, dist >= 0.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import ray_vma

EPSILON = 1e-7
INF = 1e20
# Culling blocks of NB rays get one live-chunk list each: a 16x16 pixel
# quadrant of a 32x32 screen tile under the renderer's quadrant-major swizzle
# (render.tile_swizzle). Each block's cone is the union of SUB sub-cones of
# NB // SUB rays (16x8 strips). RAYS rays per Triton program, NB // RAYS
# programs per list. Measured on the flagship frame (PERF.md): per-256-ray
# lists beat per-1024-ray tile lists and per-128-ray lists; 64, 128 and 256
# rays per program and 4 or 8 warps tie within noise.
NB = 256
SUB = 2
RAYS = 128
NUM_WARPS = 4
TC = 32  # triangles per chunk (culling and walk granularity)

# Row layout of the per-chunk constants the kernels read (factor-major, one
# row per coefficient, triangles along the minor axis):
SHARED_ROWS = 10  # det c0..2, u c0..2, qvec c0..2, c_t
GENERAL_ROWS = 19  # det r[0:3], u r[0:6], v r[0:6], t r[6:10]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _safe_inv(d):
    """NaN-safe reciprocal for slab tests: a lane whose origin sits exactly on
    a box plane while the direction is parallel to that axis would compute
    0 * inf = NaN, turning hits_box False and the walk bound 0 (real
    occluders skipped). Clamping |d| to 1e-12 keeps t0/t1 finite (huge), so
    degenerate axes fall back to the unbounded behavior."""
    return 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                           jnp.where(d < 0, -1e-12, 1e-12), d)


def box_exit(lo, hi, origins, dirs):
    """Per-lane search bound against the union box [lo, hi] of all chunk
    spheres: the slab far distance (with a 0.1% + 1e-3 margin), or 0 for
    rays that miss the box. Every triangle lies inside the box, so no hit
    exists beyond it. origins: (3,) or (3, N); dirs: (3, N)."""
    n = dirs.shape[1]
    o = jnp.broadcast_to(origins.reshape(3, -1), (3, n))
    far = jnp.full((n,), INF, jnp.float32)
    near = jnp.full((n,), -INF, jnp.float32)
    for ax in range(3):
        inv = _safe_inv(dirs[ax])
        t0 = (lo[ax] - o[ax]) * inv
        t1 = (hi[ax] - o[ax]) * inv
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    hits_box = (near <= far) & (far > 0)
    return jnp.where(hits_box, far * 1.001 + 1e-3, 0.0)


def chunk_spheres(A, B, C, T, T_pad, tc=TC):
    """Bounding sphere per tc-triangle chunk: (n_chunks, 4) cx cy cz r.
    Padding triangles collapse onto the last real vertex (harmless)."""
    def padv(x):
        return jnp.pad(x, ((0, T_pad - T), (0, 0)), mode="edge")

    A, B, C = padv(A), padv(B), padv(C)
    n_chunks = T_pad // tc
    pts = jnp.stack([A, B, C]).reshape(3, n_chunks, tc, 3)
    lo = jnp.min(jnp.min(pts, axis=0), axis=1)  # (n_chunks, 3)
    hi = jnp.max(jnp.max(pts, axis=0), axis=1)
    c = (lo + hi) / 2.0
    r = jnp.sqrt(jnp.sum(((hi - lo) / 2.0) ** 2, axis=1))
    return jnp.concatenate([c, r[:, None]], axis=1)


def _cones_of(dh_blocks, o_blocks):
    """Bounding cone per ray block. dh_blocks: (3, n_blocks, nb) unit dirs;
    o_blocks: (3, n_blocks, nb) origins. Returns (apex (3, B), axis (3, B),
    cos_a (B,), o_rad (B,))."""
    oc = jnp.mean(o_blocks, axis=2)
    o_rad = jnp.sqrt(jnp.max(jnp.sum((o_blocks - oc[:, :, None]) ** 2, axis=0), axis=1))
    mean = jnp.mean(dh_blocks, axis=2)
    axis = mean / jnp.maximum(jnp.sqrt(jnp.sum(mean * mean, axis=0)), 1e-12)
    cos_a = jnp.min(jnp.sum(dh_blocks * axis[:, :, None], axis=0), axis=1)
    return oc, axis, cos_a, o_rad


def _mask_invalid_lanes(d, o, valid):
    """Replace masked lanes' (garbage) rays with the block mean so they
    cannot blow up the block bounding cones. d/o: (3, n_blocks, nb)."""
    v = valid.reshape(1, d.shape[1], d.shape[2])
    nv = jnp.maximum(jnp.sum(v, axis=2, keepdims=True), 1)
    o_mean = jnp.sum(jnp.where(v, o, 0.0), axis=2, keepdims=True) / nv
    d_mean = jnp.sum(jnp.where(v, d, 0.0), axis=2, keepdims=True) / nv
    # non-unit stand-in: only shapes the cone
    return jnp.where(v, d, d_mean), jnp.where(v, o, o_mean)


def _cone_cull(spheres, d, o):
    """Cone-vs-sphere culling for one ray-block set against one chunk pool.

    spheres: (n_chunks, 4); d/o: (3, n_blocks, nb) dirs / origins.
    Returns (mind (n_blocks, n_chunks) conservative min distances,
             overlap (n_blocks, n_chunks) bool).
    """
    apex, axis, cos_a, o_rad = _cones_of(d, o)

    c = spheres[:, :3]  # (n_chunks, 3)
    r = spheres[:, 3][None, :] + o_rad[:, None]  # (n_blocks, n_chunks)
    dc = c[None, :, :] - apex.T[:, None, :]  # (n_blocks, n_chunks, 3)
    dlen = jnp.sqrt(jnp.sum(dc * dc, axis=-1))
    mind = jnp.maximum(dlen - r, 0.0)
    cos_d = jnp.sum(dc * axis.T[:, None, :], axis=-1) / jnp.maximum(dlen, 1e-12)
    sin_b = jnp.minimum(r / jnp.maximum(dlen, 1e-12), 1.0)
    cos_b = jnp.sqrt(jnp.maximum(1.0 - sin_b * sin_b, 0.0))
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    # Cone half-angle a plus sphere angle b can exceed pi (shadow-ray blocks
    # whose hit points surround a light give a > pi/2): cos(a+b) then wraps
    # and the test below would falsely cull a chunk that must overlap. Since
    # b in [0, pi/2] (cos_b >= 0), a+b >= pi iff cos_b <= -cos_a: treat those
    # as always-overlapping.
    overlap = (dlen <= r) | (cos_b <= -cos_a[:, None]) | (
        cos_d >= cos_a[:, None] * cos_b - sin_a[:, None] * sin_b
    )
    return mind, overlap


NBKT = 16  # distance buckets of the front-to-back order


def bucket_order(mind, overlap):
    """Approximate front-to-back compaction of live chunks per block.

    mind/overlap: (n_blocks, n_chunks). Returns (order (B, C) i32 live chunk
    ids first, key (B, C) f32 each chunk's bucket FLOOR keyed by CHUNK ID
    (look up through `order`), counts (B,) i32 live chunks per block).

    Early termination only needs APPROXIMATE front-to-back order, so chunks
    are ordered by distance bucket (a stable sort keeps chunk-id order
    within a bucket). The kernels' early-termination test compares the NEXT
    chunk's key against the block bound, assuming keys are non-decreasing
    along `order`; publishing each chunk's bucket floor (<= its true mind,
    constant within a bucket) makes stopping on keys sound.
    """
    lo_k = jnp.min(mind, axis=1, keepdims=True)
    hi_k = jnp.max(jnp.where(overlap, mind, -INF), axis=1, keepdims=True)
    span = jnp.maximum(hi_k - lo_k, 1e-6)
    bucket = jnp.clip(((mind - lo_k) / span * (NBKT - 1)).astype(jnp.int32), 0, NBKT - 1)
    key = lo_k + bucket.astype(jnp.float32) * (span / (NBKT - 1))
    bucket = jnp.where(overlap, bucket, NBKT)  # dead chunks go last
    order = jnp.argsort(bucket, axis=1, stable=True).astype(jnp.int32)
    counts = jnp.sum(overlap, axis=1).astype(jnp.int32)
    return order, key, counts


def live_chunk_lists(spheres, dh_p, o_p, valid=None, lane_bound=None,
                     endpoints=None, seg_len=None):
    """Dense (block, chunk) culling + compaction, all outside the kernel.

    spheres: (n_chunks, 4); dh_p/o_p: (3, n_pad) unit dirs / origins.
    valid: optional (n_pad,) bool -- lanes whose rays are masked out (their
    origins/dirs may be garbage, e.g. miss-lane shadow rays) are excluded
    from the block bounding cones so they cannot blow up the cone radius and
    defeat culling for the block's real lanes.
    lane_bound: optional (n_pad,) f32 -- each lane's maximum USEFUL ray
    parameter (e.g. a shadow ray's light distance, or its union-box exit).
    Rays are then culled as SEGMENTS: a chunk whose conservative min distance
    exceeds every lane's bound in a sub-cone can only produce hits beyond
    every lane's search bound, so dropping it is exact. Bounded culling both
    shortens live lists and tightens the bucket spans the early-termination
    floors are quantized on.
    Returns bucket_order's (order, key, counts) per NB-lane block.
    """
    mind, overlap = _sub_cone_cull(spheres, dh_p, o_p, valid, lane_bound,
                                   endpoints=endpoints, seg_len=seg_len)
    return bucket_order(mind, overlap)


def _sub_cone_cull(spheres, dh_p, o_p, valid=None, lane_bound=None,
                   endpoints=None, seg_len=None):
    """Cull at SUB-cone granularity (NB/SUB-lane groups), then reduce to
    NB-lane blocks: overlap = any sub overlaps, mind = min over overlapping
    subs (sound: lanes of a non-overlapping sub cannot hit the chunk, so
    excluding their sub from the bound loses nothing). Sub-cones have a
    fraction of the apex radius and angular spread of a full-block cone,
    which is what defeats the fat near-apex cones of surface-origin shadow
    blocks. endpoints: optional (3, n_pad) per-lane segment endpoints (the
    light position for shadow rays) -- adds a REVERSED cone test (apex at
    the endpoints, see _revcone_on); seg_len: optional (n_pad,) per-lane
    segment length for the reversed distance bound. Both tests are
    conservative; ANDing them only shrinks live sets.
    Returns (mind, overlap) shaped (n_blocks, n_chunks)."""
    nb = NB // SUB
    n_sub = dh_p.shape[1] // nb
    d = dh_p.reshape(3, n_sub, nb)
    o = o_p.reshape(3, n_sub, nb)
    if valid is not None:
        d, o = _mask_invalid_lanes(d, o, valid)
    mind_s, over_s = _cone_cull(spheres, d, o)  # (n_sub, C)
    if endpoints is not None:
        # Reversed cone: apex = the (near-coincident) segment endpoints,
        # dirs = endpoint -> origin. The endpoint spread takes the o_rad
        # role in _cone_cull, so lights moving relative to the object (whose
        # per-lane retarded events smear the apex) stay conservative. Masked
        # lanes reuse _mask_invalid_lanes so garbage endpoints cannot widen
        # the cone; a degenerate all-masked sub is dropped by has_valid
        # below. Dir normalization guards tmax~0 lanes (endpoint == origin):
        # a garbage direction only WIDENS the cone (cos_a is a min).
        e = endpoints.reshape(3, n_sub, nb)
        if valid is not None:
            _, e = _mask_invalid_lanes(d, e, valid)
        dr = o - e
        dr = dr / jnp.maximum(jnp.sqrt(jnp.sum(dr * dr, axis=0)), 1e-12)
        mind_r, over_r = _cone_cull(spheres, dr, e)
        if seg_len is not None:
            # A chunk farther from the light than ANY lane's segment length
            # cannot contain a point of any segment (margin as lane_bound's).
            sl = seg_len.reshape(n_sub, nb)
            if valid is not None:
                sl = jnp.where(valid.reshape(n_sub, nb), sl, 0.0)
            over_r = over_r & (mind_r <= jnp.max(sl, axis=1)[:, None] + 1e-3)
        over_s = over_s & over_r
    if valid is not None:
        # A sub with ZERO valid lanes gets a degenerate all-zero cone from
        # _mask_invalid_lanes, which the overlap test reads as "overlaps
        # everything at distance ~0" -- poisoning its whole block's live
        # list and floors. Its lanes cannot hit anything: drop the sub.
        has_valid = jnp.any(valid.reshape(n_sub, nb), axis=1)
        over_s = over_s & has_valid[:, None]
    if lane_bound is not None:
        # Segment culling: mind_s <= min distance from ANY lane origin in the
        # sub to the (o_rad-inflated) chunk sphere, so a chunk with
        # mind_s > max lane bound is unreachable within every lane's search
        # bound. The 1e-3 margin mirrors the kernels' own bound margins.
        sub_bound = jnp.max(lane_bound.reshape(n_sub, nb), axis=1)  # (n_sub,)
        over_s = over_s & (mind_s <= sub_bound[:, None] + 1e-3)
    C = mind_s.shape[1]
    over_s = over_s.reshape(n_sub // SUB, SUB, C)
    mind_s = jnp.where(over_s, mind_s.reshape(n_sub // SUB, SUB, C), INF)
    return jnp.min(mind_s, axis=1), jnp.any(over_s, axis=1)


def _revcone_on() -> bool:
    """REVERSED-cone shadow culling (RPT_REVCONE=1, trace-time).

    Every shadow segment for one point light ENDS at the same place: the
    light's position in the walked object's frame (endpoint = o + dh *
    tmax_obj, exact by linearity of the boost+affine chain). Culling with a
    second cone whose apex sits AT the light therefore has ~zero apex radius
    and a half-angle set by the surface patch as seen FROM the light --
    tight exactly where the forward cone is weakest ("the fat near-apex
    cones of surface-origin shadow blocks", _sub_cone_cull). A chunk must
    overlap BOTH cones (and lie within the light's maximum segment length)
    to stay live. Output is BIT-IDENTICAL: the general kernel clamps its
    result at tmax, and every hit below tmax lies ON its lane's segment,
    which both cones contain (see test_revcone_exact).

    Off by default: when the light sits close to the mesh the patch
    subtends a wide angle from the light, the reversed cone culls ~nothing,
    and the second dense cull pass doubles the shadow list-build cost. Its
    gain on the card is not measured."""
    return os.environ.get("RPT_REVCONE", "").strip() == "1"


def _shadow_cull_mode() -> str:
    """Segment-culling mode for the general (shadow) kernel's live lists.

    "boxfar" (default): each lane's bound for CULLING is min(tmax, its exit
    distance from the chunk-sphere union box) -- the same cap the kernel
    applies to its walk, so list construction and walk agree.
    "tmax": cull with the raw caller bound only (no extra slab pass).
    "none": unbounded cull. Overridable per process via RPT_SHADOW_CULL;
    read at trace time."""
    v = os.environ.get("RPT_SHADOW_CULL", "").strip()
    return v if v in ("none", "tmax", "boxfar") else "boxfar"


def shared_rows(consts, T_pad):
    """(4*T_pad, 3) factor-grouped shared-origin constants
    (ops.mesh_intersect.shared_origin_constants) -> (SHARED_ROWS, T_pad)
    factor-major rows, so one chunk's coefficient is a contiguous load."""
    rows = consts.reshape(4, T_pad, 3).transpose(0, 2, 1).reshape(12, T_pad)
    return rows[:SHARED_ROWS]


def general_rows(cols, T_pad):
    """(4*T_pad, 10) factor-grouped Plucker operators
    (ops.mesh_intersect.general_ray_constants) -> (GENERAL_ROWS, T_pad)
    factor-major rows keeping only each factor's nonzero columns (det uses
    r10[0:3], u/v r10[0:6], t r10[6:10])."""
    g = cols.reshape(4, T_pad, 10).transpose(0, 2, 1)  # (4, 10, T_pad)
    return jnp.concatenate([g[0, 0:3], g[1, 0:6], g[2, 0:6], g[3, 6:10]],
                           axis=0)


def _accept(det, u, v, dist):
    return ((jnp.abs(det) >= EPSILON)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (dist >= 0.0))


def _walk(order_ref, minds_ref, count_ref, mb0, carry, step):
    """Walk this program's live-chunk list front to back.

    The list belongs to the NB-lane block that holds the program's rays.
    step(k, carry) -> (mb, carry) processes chunk k and returns the
    program's new search bound (the max over its lanes). The loop stops at
    the end of the list, or once the next chunk's bucket floor is not
    STRICTLY below the bound (a hit at dist == mb cannot improve any lane,
    and floor-0 chunks must not keep a block alive once every bound is 0).
    """
    b = pl.program_id(0) // (NB // RAYS)
    n_live = count_ref[b]
    last = order_ref.shape[1] - 1

    def cond(state):
        j, mb = state[0], state[1]
        k = order_ref[b, jnp.minimum(j, last)]  # & does not short-circuit
        return (j < n_live) & (minds_ref[b, k] < mb)

    def body(state):
        j = state[0]
        mb, carry = step(order_ref[b, j], state[2:])
        return (j + 1, mb) + tuple(carry)

    return jax.lax.while_loop(cond, body, (jnp.int32(0), mb0) + tuple(carry))[2:]


def _shared_kernel(order_ref, minds_ref, count_ref, rows_ref, dh_ref,
                   bound_ref, t_ref, tri_ref):
    dx = dh_ref[0, :][None, :]  # (1, RAYS)
    dy = dh_ref[1, :][None, :]
    dz = dh_ref[2, :][None, :]
    bound = bound_ref[:]

    def step(k, carry):
        best_t, best_tri = carry
        base = pl.multiple_of(k * TC, TC)

        def c(r):  # (TC, 1) column of coefficient row r for this chunk
            return rows_ref[r, pl.ds(base, TC)][:, None]

        det = c(0) * dx + c(1) * dy + c(2) * dz
        u_num = c(3) * dx + c(4) * dy + c(5) * dz
        v_num = c(6) * dx + c(7) * dy + c(8) * dz
        inv_det = 1.0 / det
        u = u_num * inv_det
        v = v_num * inv_det
        dist = c(9) * inv_det
        dist = jnp.where(_accept(det, u, v, dist), dist, INF)  # (TC, RAYS)
        dmin = jnp.min(dist, axis=0)
        idx = jnp.argmin(dist, axis=0).astype(jnp.int32)  # lowest id at ties
        better = dmin < best_t
        best_t = jnp.where(better, dmin, best_t)
        best_tri = jnp.where(better, base + idx, best_tri)
        return jnp.max(jnp.minimum(best_t, bound)), (best_t, best_tri)

    # Starting from the block's true bound (not INF): programs whose every
    # lane misses the union box (bound 0) run ZERO chunk iterations.
    best_t, best_tri = _walk(
        order_ref, minds_ref, count_ref, jnp.max(bound),
        (jnp.full((RAYS,), INF, jnp.float32),
         jnp.full((RAYS,), -1, jnp.int32)), step)
    t_ref[:] = best_t
    tri_ref[:] = best_tri


def _general_kernel(order_ref, minds_ref, count_ref, rows_ref, r10_ref,
                    lim_ref, t_ref):
    r = [r10_ref[i, :][None, :] for i in range(10)]  # (1, RAYS) each
    tmax = lim_ref[0, :]
    tcut = lim_ref[1, :]
    tmax_eff = lim_ref[2, :]

    def step(k, carry):
        (best_t,) = carry
        base = pl.multiple_of(k * TC, TC)

        def fma(row0, lo, hi):
            acc = rows_ref[row0, pl.ds(base, TC)][:, None] * r[lo]
            for i in range(lo + 1, hi):
                acc = acc + rows_ref[row0 + i - lo, pl.ds(base, TC)][:, None] * r[i]
            return acc

        det = fma(0, 0, 3)
        u_num = fma(3, 0, 6)
        v_num = fma(9, 0, 6)
        t_num = fma(15, 6, 10)
        inv_det = 1.0 / det
        u = u_num * inv_det
        v = v_num * inv_det
        dist = t_num * inv_det
        dist = jnp.where(_accept(det, u, v, dist), dist, INF)
        best_t = jnp.minimum(best_t, jnp.min(dist, axis=0))
        # Search bounded at min(tmax, box exit); lanes already provably
        # occluded (hit < tcut) no longer extend the walk.
        live = jnp.where(best_t < tcut, 0.0, jnp.minimum(best_t, tmax_eff))
        return jnp.max(live), (best_t,)

    (best_t,) = _walk(order_ref, minds_ref, count_ref, jnp.max(tmax_eff),
                      (jnp.full((RAYS,), INF, jnp.float32),), step)
    t_ref[:] = jnp.minimum(best_t, tmax)


def _call(kernel, lists, rows, rays, out_shape, interpret):
    """pallas_call over RAYS-lane programs: lists and constant rows are read
    from global memory by index; `rays` are per-lane (k, n_pad) blocks."""
    n_pad = rays[0].shape[1]
    vma = ray_vma(*rays)
    ray_spec = lambda a: pl.BlockSpec((a.shape[0], RAYS), lambda i: (0, i))  # noqa: E731
    out_spec = pl.BlockSpec((RAYS,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // RAYS,),
        in_specs=([pl.no_block_spec] * (len(lists) + 1)
                  + [ray_spec(a) for a in rays]),
        out_specs=tuple(out_spec for _ in out_shape),
        out_shape=tuple(jax.ShapeDtypeStruct((n_pad,), dt, vma=vma)
                        for dt in out_shape),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
    )(*lists, rows, *rays)


@functools.partial(jax.jit, static_argnames=("interpret",))
def shared_nearest_hit(rows, spheres, dh, ro, interpret=False):
    """rows: (SHARED_ROWS, T_pad) from shared_rows; spheres: (n_chunks, 4)
    at TC granularity; dh: (3, N) unit object-space dirs; ro: (3,).

    Returns (best_t (N,) object-space distance, INF on miss; best_tri (N,)
    chunk-pool triangle index, -1 on miss). interpret=True runs the kernel
    in Pallas interpret mode (CPU-testable production path).
    """
    n = dh.shape[1]
    n_pad = _round_up(n, NB)
    dh_p = jnp.pad(dh, ((0, 0), (0, n_pad - n)), constant_values=1.0)
    ro_p = jnp.broadcast_to(ro[:, None], (3, n_pad))
    order, minds, counts = live_chunk_lists(spheres, dh_p, ro_p)
    lo = jnp.min(spheres[:, :3] - spheres[:, 3:4], axis=0)
    hi = jnp.max(spheres[:, :3] + spheres[:, 3:4], axis=0)
    bound = box_exit(lo, hi, ro, dh_p)[None, :]
    bt, btri = _call(_shared_kernel, (order, minds, counts), rows,
                     (dh_p, bound), (jnp.float32, jnp.int32), interpret)
    return bt[:n], btri[:n]


@functools.partial(jax.jit, static_argnames=("interpret",))
def general_min_t(rows, spheres, r10, tmax_obj=None, valid=None,
                  tcut_obj=None, interpret=False):
    """rows: (GENERAL_ROWS, T_pad) from general_rows; spheres: (n_chunks, 4);
    r10: (10, N) lifted rays [dh, o x dh, o, 1]; tmax_obj: optional (N,)
    object-space search bound per ray -- the result is min(nearest hit,
    tmax_obj); valid: optional (N,) lanes included in the culling cones;
    tcut_obj: optional (N,) occlusion-retirement threshold -- a lane with a
    hit strictly below it stops extending the walk (its exact min-t may then
    be missed, but it is still returned < tcut; only sound for callers that
    compare the result against a bound >= tcut).
    Returns per-ray min object-space distance."""
    n = r10.shape[1]
    n_pad = _round_up(n, NB)
    r10_p = jnp.pad(r10, ((0, 0), (0, n_pad - n)), constant_values=1.0)
    bounded = tmax_obj is not None
    if tmax_obj is None:
        tmax_obj = jnp.full((n,), INF, jnp.float32)
    if tcut_obj is None:
        tcut_obj = jnp.zeros((n,), jnp.float32)
    tmax_p = jnp.pad(tmax_obj, (0, n_pad - n))
    tcut_p = jnp.pad(tcut_obj, (0, n_pad - n))
    valid_p = None if valid is None else jnp.pad(valid, (0, n_pad - n))
    lo = jnp.min(spheres[:, :3] - spheres[:, 3:4], axis=0)
    hi = jnp.max(spheres[:, :3] + spheres[:, 3:4], axis=0)
    # Per-lane walk bound: min(tmax, union-box exit). For shadow rays from
    # the mesh's own surface this caps LIT lanes (the expensive ones: they
    # must otherwise prove no occluder exists all the way to the light) at
    # the box exit instead of the light distance. The RESULT is still
    # min(best_t, tmax): no hit can exist beyond the box.
    tmax_eff = jnp.minimum(tmax_p, box_exit(lo, hi, r10_p[6:9], r10_p[0:3]))
    mode = _shadow_cull_mode()
    lane_bound = {"none": None, "tmax": tmax_p, "boxfar": tmax_eff}[mode]
    endpoints = seg_len = None
    if bounded and valid is not None and _revcone_on():
        # Per-lane segment endpoint: o + dh * tmax_obj -- for shadow rays,
        # the light's position in this object's frame. tmax_obj already
        # carries the caller's bound margin, so the reversed cone covers
        # every hit the clamped result can expose.
        endpoints = r10_p[6:9] + r10_p[0:3] * tmax_p[None, :]
        seg_len = tmax_p
    order, minds, counts = live_chunk_lists(
        spheres, r10_p[0:3], r10_p[6:9], valid=valid_p,
        lane_bound=lane_bound, endpoints=endpoints, seg_len=seg_len)
    lim = jnp.stack([tmax_p, tcut_p, tmax_eff])
    (bt,) = _call(_general_kernel, (order, minds, counts), rows,
                  (r10_p, lim), (jnp.float32,), interpret)
    return bt[:n]
