"""Batched ray/triangle-mesh intersection.

The reference walks a stackless octree per pixel with a divergent while-loop
(/root/reference/opencl_kernel.cl:200-308). Here Moller-Trumbore
(/root/reference/opencl_kernel.cl:106-126) is factored into per-triangle
constants that are linear in the ray, so a triangle block against a ray
block is one small matrix product:

* Shared-origin rays (all primary rays of one object share origin
  `stationaryCam`): with tvec = o - A constant per triangle,
      det   = cross(e2, e1) . d
      u_num = cross(e2, o - A) . d
      v_num = qvec . d,   qvec = (o - A) x e1     (per-triangle constant)
      t_num = e2 . qvec                            (per-triangle scalar)
  so the whole test is one (3T, 3) @ (3, N) matmul plus elementwise masking.

* General rays (per-pixel shadow-ray origins): lift each ray to the 10-vector
  r = [d, m, o, 1] with moment m = cross(o, d); then det/u_num/v_num/t_num are
  all linear in r, i.e. one (4T, 10) @ (10, N) matmul (Plucker-style).

LAYOUT: rays on the LAST axis everywhere -- directions (3, N), origins (3,)
or (3, N).

Two routes share these constants: the jnp scan here (every triangle chunk
against every ray, a running best-hit reduce; the reference for tests) and
the culled Triton walks of ops.pallas.mesh_kernels, which the renderer uses
on a GPU (resolve_kernels). Semantics (epsilon test on det, backface hits
allowed, u/v/t acceptance order) match the reference.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .intersect import apply_affine3, apply_linear3, apply_normal3, norm3, normalize3

EPSILON = 1e-7
INF = 1e20

_PREC = jax.lax.Precision.HIGHEST

# Routing override for the mesh walks, for tests. None = choose from the
# platform (the Triton kernels on a GPU, the jnp scan anywhere else);
# True/False force a path; "interpret" runs the REAL kernels in Pallas
# interpret mode (CPU-testable: exercises live-chunk culling, the bucket
# order, early termination and tmax bounding -- none of which the jnp scan
# contains). Tests that flip this must clear the render-fn caches (they
# close over the resolved mode).
PALLAS_MODE = None


def resolve_kernels(use_kernels=None):
    """(use_kernels, interpret) for the mesh walks. Without an explicit
    request or a PALLAS_MODE override, the observed platform decides: the
    compiled Triton kernels on "gpu", the jnp scan on anything else. Interpret
    mode runs only when asked for."""
    if use_kernels is None:
        use_kernels = PALLAS_MODE
    if use_kernels is None:
        use_kernels = jax.default_backend() == "gpu"
    return bool(use_kernels), use_kernels == "interpret"


def _vma_like(init, like):
    """Cast replicated constants in the pytree `init` to `like`'s
    varying-manual-axes, so lax.scan/while carries initialized from constants
    type-check under shard_map(check_vma=True): the carry starts replicated
    but the body combines it with per-shard rays, and JAX's VMA typing
    requires the init to already be declared varying."""
    vma = getattr(jax.typeof(like), "vma", frozenset())
    if not vma:
        return init
    return jax.tree.map(
        lambda x: jax.lax.pcast(x, tuple(vma), to="varying"), init)


def _cross_cols(a, b):
    """Cross product over the LAST axis for (T, 3) row-vectors."""
    return jnp.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        axis=-1,
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tri_count(tri_range, perm):
    return int(perm.shape[0]) if perm is not None else int(tri_range[1]) - int(tri_range[0])


def mesh_tri_vertices(mesh, tri_range, perm=None):
    """perm, when given, holds ABSOLUTE triangle ids (the Morton-ordered
    octree-reachable set); otherwise the contiguous seeded range is used."""
    if perm is not None:
        tv = mesh.tri_v[perm]
    else:
        lo, hi = int(tri_range[0]), int(tri_range[1])
        tv = mesh.tri_v[lo:hi]
    A = mesh.vertices[tv[:, 0]]
    B = mesh.vertices[tv[:, 1]]
    C = mesh.vertices[tv[:, 2]]
    return A, B, C


def shared_origin_constants(mesh, tri_range, ro, perm=None):
    """Per-triangle constant matrix for the shared-origin factorization.

    ro: (3,) object-space origin. Returns (consts (3T_pad, 3), c_t (T_pad,),
    T, T_pad) with T_pad rounded up to 128; padding rows are zero (det == 0
    -> auto-masked by the epsilon test). `perm` optionally reorders triangles
    (Morton order for chunk locality).
    """
    T = tri_count(tri_range, perm)
    A, B, C = mesh_tri_vertices(mesh, tri_range, perm)
    e1 = B - A
    e2 = C - A
    qvec = _cross_cols(ro[None, :] - A, e1)
    c_det = _cross_cols(e2, e1)
    c_u = _cross_cols(e2, ro[None, :] - A)
    c_t = jnp.sum(e2 * qvec, axis=-1)

    T_pad = _round_up(max(T, 1), 256)  # multiple of the Pallas chunk size TC
    pad = T_pad - T
    c_det = jnp.pad(c_det, ((0, pad), (0, 0)))
    c_u = jnp.pad(c_u, ((0, pad), (0, 0)))
    qvec = jnp.pad(qvec, ((0, pad), (0, 0)))
    c_t = jnp.pad(c_t, (0, pad))
    # ct rides in lane 0 of a 4th block so every kernel slice is a
    # sublane-dynamic (Tc, 3) window (lane slices would force Tc >= 128).
    ct_block = jnp.concatenate([c_t[:, None], jnp.zeros((T_pad, 2))], axis=1)
    consts = jnp.concatenate([c_det, c_u, qvec, ct_block], axis=0)  # (4*T_pad, 3)
    return consts, c_t, T, T_pad


def general_ray_constants(mesh, tri_range, perm=None):
    """Per-triangle Plucker-lift operators, FACTOR-GROUPED: returns
    (cols (4*T_pad, 10), T, T_pad) where rows [0,T_pad) are the det
    operators, then u, v, t blocks. Grouped layout keeps per-chunk slices
    contiguous (no strided sublane access). Zero padding rows auto-mask."""
    T = tri_count(tri_range, perm)
    A, B, C = mesh_tri_vertices(mesh, tri_range, perm)
    e1 = B - A
    e2 = C - A
    zeros = jnp.zeros_like(A)
    zcol = jnp.zeros((T, 1))
    col_det = jnp.concatenate([_cross_cols(e2, e1), zeros, zeros, zcol], axis=-1)
    col_u = jnp.concatenate([_cross_cols(A, e2), e2, zeros, zcol], axis=-1)
    col_v = jnp.concatenate([-_cross_cols(A, e1), -e1, zeros, zcol], axis=-1)
    tnum_c = -jnp.sum(e2 * _cross_cols(A, e1), axis=-1)
    col_t = jnp.concatenate([zeros, zeros, _cross_cols(e1, e2), tnum_c[:, None]], axis=-1)
    T_pad = _round_up(max(T, 1), 256)  # multiple of the Pallas chunk size TC

    def padrows(x):
        return jnp.pad(x, ((0, T_pad - T), (0, 0)))

    cols = jnp.concatenate(
        [padrows(col_det), padrows(col_u), padrows(col_v), padrows(col_t)], axis=0
    )
    return cols, T, T_pad


def _mt_accept(det, u_num, v_num, t_num, tri_ok):
    """Shared acceptance logic; returns dist (INF where rejected), u, v."""
    inv_det = 1.0 / det
    u = u_num * inv_det
    v = v_num * inv_det
    dist = t_num * inv_det
    ok = (
        (jnp.abs(det) >= EPSILON)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (dist >= 0.0) & tri_ok
    )
    return jnp.where(ok, dist, INF), u, v


def mesh_intersect_shared(mesh, tri_range, m4, inv_m, o3, d3, *, tri_chunk=512,
                          use_pallas=None, perm=None, static=None):
    """Nearest-hit of shared-origin rays against triangles [lo, hi).

    o3: (3,) rest-frame spatial origin; d3: (3, N) rest-frame spatial dirs.
    Returns (t, normal (3, N), uv (2, N), valid); t is the 4D ray parameter,
    converted via world-space distance like intersect_octree
    (opencl_kernel.cl:301-303).

    use_pallas: route through the Triton walk (default: resolve_kernels).
    static: the mesh object's models.scene.MeshStatic, if prebuilt.
    """
    n = d3.shape[1]
    if tri_count(tri_range, perm) == 0:
        return (jnp.full((n,), INF), jnp.zeros((3, n)), jnp.zeros((2, n)),
                jnp.zeros((n,), bool))
    ro, dh, bt, bu, bv, btri = mesh_nearest_hit(
        mesh, tri_range, inv_m, o3, d3, tri_chunk=tri_chunk,
        use_pallas=use_pallas, perm=perm, static=static)
    return finalize_best_hit(mesh, int(tri_range[0]), m4, inv_m, o3, d3, ro,
                             dh, bt, bu, bv, btri, perm)


def mesh_nearest_hit(mesh, tri_range, inv_m, o3, d3, *, tri_chunk=512,
                     use_pallas=None, perm=None, static=None):
    """The object-space walk of mesh_intersect_shared (non-empty mesh).

    Returns (ro (3,) object-space origin, dh (3, N) unit object-space dirs,
    bt (N,) object-space hit distance (INF on miss), bu, bv barycentrics,
    btri (N,) index into the (Morton-ordered) triangle set, -1 or 0 on
    miss)."""
    n = d3.shape[1]
    ro = apply_affine3(inv_m, o3)  # (3,)
    d = apply_linear3(inv_m, d3)  # (3, N)
    scale = norm3(d)
    dh = d / scale

    use_pallas, interpret = resolve_kernels(use_pallas)
    consts, c_t, T, T_pad = shared_origin_constants(mesh, tri_range, ro, perm)

    if use_pallas:
        from .pallas.mesh_kernels import chunk_spheres, shared_nearest_hit, shared_rows

        if static is not None:
            spheres = static.spheres
        else:
            A, B, C = mesh_tri_vertices(mesh, tri_range, perm)
            spheres = chunk_spheres(A, B, C, T, T_pad)
        rows = shared_rows(consts, T_pad)
        bt, btri = shared_nearest_hit(rows, spheres, dh, ro, interpret=interpret)
        # Barycentrics of the winning triangle, recomputed from its
        # constants with the kernel's own arithmetic (one gather per ray).
        w = rows[:, jnp.clip(btri, 0, T_pad - 1)]  # (10, N)
        inv_det = 1.0 / (w[0] * dh[0] + w[1] * dh[1] + w[2] * dh[2])
        hit = btri >= 0
        bu = jnp.where(hit, (w[3] * dh[0] + w[4] * dh[1] + w[5] * dh[2]) * inv_det, 0.0)
        bv = jnp.where(hit, (w[6] * dh[0] + w[7] * dh[1] + w[8] * dh[2]) * inv_det, 0.0)
        return ro, dh, bt, bu, bv, btri

    # Tc must DIVIDE T_pad: the factor blocks are packed contiguously at
    # T_pad stride, so a floor-divided chunk count silently drops the tail
    # triangles (T_pad = 768 with Tc = 512 skipped tris 512..767 -- rays
    # passed through geometry on the jnp path), while a ceil count would
    # run the last chunk's cv slice out of bounds (dynamic_slice clamps the
    # start, unmasking WRONG rows). T_pad is a multiple of 256, so the gcd
    # is always >= 256.
    Tc = math.gcd(min(tri_chunk, T_pad), T_pad)
    n_chunks = T_pad // Tc

    def chunk_step(carry, k):
        best_t, best_u, best_v, best_tri = carry
        base = k * Tc
        cd = jax.lax.dynamic_slice_in_dim(consts, base, Tc, 0)
        cu = jax.lax.dynamic_slice_in_dim(consts, T_pad + base, Tc, 0)
        cv = jax.lax.dynamic_slice_in_dim(consts, 2 * T_pad + base, Tc, 0)
        ct = jax.lax.dynamic_slice_in_dim(c_t, base, Tc, 0)
        blk = jnp.concatenate([cd, cu, cv], axis=0)  # (3Tc, 3)
        prods = jnp.matmul(blk, dh, precision=_PREC)  # (3Tc, N)
        det, u_num, v_num = prods[:Tc], prods[Tc:2 * Tc], prods[2 * Tc:]
        tri_ok = (base + jnp.arange(Tc)) < T
        dist, u, v = _mt_accept(det, u_num, v_num, ct[:, None], tri_ok[:, None])
        idx = jnp.argmin(dist, axis=0)  # (N,)
        onehot = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 0) == idx[None, :]
        dmin = jnp.min(dist, axis=0)
        umin = jnp.sum(jnp.where(onehot, u, 0.0), axis=0)
        vmin = jnp.sum(jnp.where(onehot, v, 0.0), axis=0)
        better = dmin < best_t
        carry = (
            jnp.where(better, dmin, best_t),
            jnp.where(better, umin, best_u),
            jnp.where(better, vmin, best_v),
            jnp.where(better, (base + idx).astype(jnp.int32), best_tri),
        )
        return carry, None

    init = _vma_like((jnp.full((n,), INF), jnp.zeros((n,)), jnp.zeros((n,)),
                      jnp.zeros((n,), jnp.int32)), dh)
    (bt, bu, bv, btri), _ = jax.lax.scan(chunk_step, init, jnp.arange(n_chunks))
    return ro, dh, bt, bu, bv, btri


def finalize_best_hit(mesh, lo, m4, inv_m, o3, d3, ro, dh, bt, bu, bv, btri, perm=None):
    """Attribute interpolation + world-distance conversion for the best hit.

    Mirrors the post-walk block of intersect_octree
    (opencl_kernel.cl:287-303). Shared by the jnp scan and the Triton walk.
    """
    valid = bt < INF
    if perm is not None:
        tri = perm[jnp.clip(btri, 0, perm.shape[0] - 1)]
    else:
        tri = jnp.clip(btri + lo, 0, mesh.tri_v.shape[0] - 1)

    w0 = 1.0 - bu - bv
    tn = mesh.tri_n[tri]  # (N, 3) gather
    nrm = (
        w0 * mesh.normals[tn[:, 0]].T
        + bu * mesh.normals[tn[:, 1]].T
        + bv * mesh.normals[tn[:, 2]].T
    )  # (3, N)
    normal = normalize3(apply_normal3(inv_m, nrm))
    tuv = mesh.tri_uv[tri]
    uv = (
        w0 * mesh.uvs[tuv[:, 0]].T
        + bu * mesh.uvs[tuv[:, 1]].T
        + bv * mesh.uvs[tuv[:, 2]].T
    )  # (2, N)

    # World-distance conversion (opencl_kernel.cl:301-303).
    obj_pt = ro[:, None] + bt * dh if ro.ndim == 1 else ro + bt * dh
    world_pt = apply_affine3(m4, obj_pt)
    o3b = o3[:, None] if o3.ndim == 1 else o3
    t = norm3(world_pt - o3b) / norm3(d3)
    t = jnp.where(valid, t, INF)
    return t, normal, uv, valid


def mesh_min_t_general(mesh, tri_range, m4, inv_m, o3, d3, *, tri_chunk=512,
                       use_pallas=None, perm=None, tmax=None, static=None):
    """Minimum hit parameter t for rays with per-ray origins (shadow rays).

    o3: (3, N) rest-frame spatial origins; d3: (3, N) spatial dirs.
    tmax: optional (N,) search bound in ray-parameter units (the light
    distance for shadow rays); hits beyond it need not be found exactly.
    Lanes with tmax == 0 are treated as fully masked: they are excluded from
    the block bounding cones (their origins/dirs may be garbage) and their
    search bound is EXACTLY zero so masked-only blocks run no chunk work.
    Returns t (N,), INF where no hit, converted to the shared ray parameter.
    """
    n = d3.shape[1]
    if tri_count(tri_range, perm) == 0:
        return jnp.full((n,), INF)

    ro = apply_affine3(inv_m, o3)  # (3, N)
    d = apply_linear3(inv_m, d3)
    scale = norm3(d)
    dh = d / scale
    mom = jnp.stack(
        [
            ro[1] * dh[2] - ro[2] * dh[1],
            ro[2] * dh[0] - ro[0] * dh[2],
            ro[0] * dh[1] - ro[1] * dh[0],
        ]
    )
    r10 = jnp.concatenate([dh, mom, ro, jnp.ones((1, n))], axis=0)  # (10, N)

    use_pallas, interpret = resolve_kernels(use_pallas)

    if use_pallas:
        from .pallas.mesh_kernels import chunk_spheres, general_min_t, general_rows

        if static is not None:
            rows, spheres = static.gen_rows, static.spheres
        else:
            cols, T, T_pad = general_ray_constants(mesh, tri_range, perm)
            rows = general_rows(cols, T_pad)
            A, B, C = mesh_tri_vertices(mesh, tri_range, perm)
            spheres = chunk_spheres(A, B, C, T, T_pad)
        tmax_obj = None
        valid = None
        tcut_obj = None
        if tmax is not None:
            # Convert the t-parameter bound to object-space distance: along a
            # ray, t = bt * |M3 dh| / |d3| (M maps object space back to the
            # rest frame and the origin is a fixed point of the round trip).
            # 0.1% margin keeps the no-hit result strictly beyond the caller's
            # `t < tmax` test (hits inside the margin fail it anyway). Masked
            # lanes (tmax == 0) keep an EXACT zero bound -- the margin would
            # otherwise keep whole blocks walking floor-0 chunks for lanes
            # whose result is discarded.
            valid = tmax > 0.0
            k_r = norm3(apply_linear3(m4, dh))
            tmax_base = tmax * norm3(d3) / k_r
            tmax_obj = jnp.where(valid, tmax_base * 1.001 + 1e-3, 0.0)
            # Occlusion retirement: shadow callers only test `t >= tmax`, so
            # a hit strictly below tcut (inverse margin of the bound above)
            # proves the lane shadowed no matter what closer hits exist --
            # the kernel then drops it from the walk bound. The margin keeps
            # fp error in the object->shared conversion from flipping the
            # caller's comparison.
            tcut_obj = jnp.where(valid,
                                 jnp.maximum(tmax_base * 0.999 - 1e-3, 0.0),
                                 0.0)
        bt = general_min_t(rows, spheres, r10, tmax_obj, valid=valid,
                           tcut_obj=tcut_obj, interpret=interpret)
    else:
        cols, T, T_pad = general_ray_constants(mesh, tri_range, perm)
        # Tc must divide T_pad (see mesh_intersect_shared: a floor-divided
        # chunk count drops tail triangles; shadows then leak).
        Tc = math.gcd(min(tri_chunk, T_pad), T_pad)
        n_chunks = T_pad // Tc

        def chunk_step(best_t, k):
            base = k * Tc
            det = jnp.matmul(jax.lax.dynamic_slice_in_dim(cols, base, Tc, 0), r10, precision=_PREC)
            u_num = jnp.matmul(jax.lax.dynamic_slice_in_dim(cols, T_pad + base, Tc, 0), r10, precision=_PREC)
            v_num = jnp.matmul(jax.lax.dynamic_slice_in_dim(cols, 2 * T_pad + base, Tc, 0), r10, precision=_PREC)
            t_num = jnp.matmul(jax.lax.dynamic_slice_in_dim(cols, 3 * T_pad + base, Tc, 0), r10, precision=_PREC)
            tri_ok = (base + jnp.arange(Tc)) < T
            dist, _, _ = _mt_accept(det, u_num, v_num, t_num, tri_ok[:, None])
            return jnp.minimum(best_t, jnp.min(dist, axis=0)), None

        bt, _ = jax.lax.scan(chunk_step, _vma_like(jnp.full((n,), INF), r10),
                             jnp.arange(n_chunks))

    valid = bt < INF
    obj_pt = ro + bt * dh
    world_pt = apply_affine3(m4, obj_pt)
    t = norm3(world_pt - o3) / norm3(d3)
    return jnp.where(valid, t, INF)
