"""Batched analytic primitive intersectors (sphere, cube).

Wavefront re-design of the reference per-pixel intersectors
(/root/reference/opencl_kernel.cl:310-359): every function evaluates a whole
ray batch against one object with dense vector math and masked invalid lanes.

LAYOUT: rays live on the LAST axis -- 3-vectors are (3, N), scalars (N,),
so every component is a contiguous ray vector; component count (3 or 4)
stays on the leading side. All math is written per-component to keep XLA
from materializing (N, 3) arrays.

Inputs are the spatial components of the 4D rest-frame ray (origin `o3`,
direction `d3`); the object-space transform by InvM happens inside, exactly as
in the reference intersectors.
"""

from __future__ import annotations

import jax.numpy as jnp

EPSILON = 1e-7
INF = 1e20


def apply_affine3(m, p):
    """(4,4) affine applied to (3, ...) points (implicit w=1) -> (3, ...)."""
    return jnp.einsum("ij,j...->i...", m[:3, :3], p) + m[:3, 3].reshape(3, *([1] * (p.ndim - 1)))


def apply_linear3(m, d):
    """Linear 3x3 part of (4,4) applied to (3, ...) directions."""
    return jnp.einsum("ij,j...->i...", m[:3, :3], d)


def apply_normal3(inv_m, n):
    """Inverse-transpose normal transform: (inv_m[:3,:3])^T @ n."""
    return jnp.einsum("ji,j...->i...", inv_m[:3, :3], n)


def norm3(v):
    return jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def normalize3(v):
    return v / norm3(v)


def sphere_intersect(inv_m, o3, d3, with_attrs=True):
    """Unit-sphere intersection in object space.

    Mirrors intersect_sphere (/root/reference/opencl_kernel.cl:335-359).
    inv_m: (4, 4); o3: (3,) or (3, N); d3: (3, N).
    Returns (t, normal (3, N), uv (2, N), valid): t = dist/scale.
    """
    ro = apply_affine3(inv_m, o3)  # (3,) or (3, N)
    d = apply_linear3(inv_m, d3)  # (3, N)
    scale = norm3(d)
    dh = d / scale
    if ro.ndim == 1:
        ro = ro[:, None]
    b = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2])
    c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0
    disc = b * b - c
    hit = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    near = b - sq
    far = b + sq
    use_near = near > EPSILON
    dist = jnp.where(use_near, near, far)
    valid = hit & (use_near | (far > EPSILON))

    t = jnp.where(valid, dist / scale, INF)
    if not with_attrs:  # shadow rays only need the hit parameter
        return t, None, None, valid
    obj_pt = ro + dh * dist
    normal = normalize3(apply_normal3(inv_m, obj_pt))
    u = 0.5 + jnp.arctan2(obj_pt[2], obj_pt[0]) / (2.0 * jnp.pi)
    v = jnp.arcsin(jnp.clip(obj_pt[1], -1.0, 1.0)) / jnp.pi + 0.5
    return t, normal, jnp.stack([u, v]), valid


def cube_intersect(inv_m, o3, d3, with_attrs=True):
    """Unit-cube [-1, 1]^3 slab intersection (Majercik et al.).

    Mirrors intersect_cube (/root/reference/opencl_kernel.cl:312-333).
    Shapes as sphere_intersect.
    """
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    scale = norm3(d)
    dh = d / scale
    if ro.ndim == 1:
        ro = ro[:, None]
    ro = jnp.broadcast_to(ro, dh.shape)

    inside = jnp.maximum(jnp.maximum(jnp.abs(ro[0]), jnp.abs(ro[1])), jnp.abs(ro[2])) < 1.0
    winding = jnp.where(inside, -1.0, 1.0)
    sgn = -jnp.sign(dh)
    dcand = (winding * sgn - ro) / dh  # inf/nan lanes masked below

    def face_test(axis, a1, a2):
        da = dcand[axis]
        p1 = jnp.abs(ro[a1] + dh[a1] * da)
        p2 = jnp.abs(ro[a2] + dh[a2] * da)
        # comparisons with nan are False, matching OpenCL isless semantics
        return (da >= 0.0) & (p1 < 1.0) & (p2 < 1.0)

    tx = face_test(0, 1, 2)
    ty = face_test(1, 2, 0)
    tz = face_test(2, 0, 1)

    sx = jnp.where(tx, sgn[0], 0.0)
    sy = jnp.where(~tx & ty, sgn[1], 0.0)
    sz = jnp.where(~tx & ~ty & tz, sgn[2], 0.0)
    sgn_out = jnp.stack([sx, sy, sz])

    dist = jnp.where(sx != 0.0, dcand[0], jnp.where(sy != 0.0, dcand[1], dcand[2]))
    valid = (sx != 0.0) | (sy != 0.0) | (sz != 0.0)

    t = jnp.where(valid, dist / scale, INF)
    if not with_attrs:  # shadow rays only need the hit parameter
        return t, None, None, valid
    obj_pt = ro + dh * dist
    normal = normalize3(apply_normal3(inv_m, sgn_out))
    on_x = sx != 0.0
    on_y = sy != 0.0
    u = jnp.where(on_x, obj_pt[1], obj_pt[0])
    v = jnp.where(on_x | on_y, obj_pt[2], obj_pt[1])
    uv = jnp.stack([(u + 1.0) / 2.0, (v + 1.0) / 2.0])
    return t, normal, uv, valid
