"""Special-relativity and affine-transform math, batched over leading axes.

Device-side re-design of the reference host math layer
(/root/reference/Vector.cpp:94-232). Everything here is pure jnp so it can run
inside a jitted frame step: the reference recomputes per-object boost matrices
on the host each frame and re-uploads a buffer (/root/reference/Render.cpp:179-203);
we instead fold the same algebra into the compiled step so per-frame host work
is a single tiny pytree argument.

All functions broadcast over arbitrary leading batch dimensions.
Convention: 4-vectors are (t, x, y, z); 4x4 matrices act on column 4-vectors.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot3(a, b):
    """Batched 3-vector dot product over the last axis."""
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    """Batched 3-vector cross product over the last axis."""
    return jnp.cross(a, b)


def normalize3(v, eps=0.0):
    """Normalize over last axis. Matches reference semantics (no epsilon guard
    unless requested): normalize(0) -> nan/inf, as in Vector.cpp:12-15."""
    m = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    if eps:
        m = jnp.maximum(m, eps)
    return v / m


def identity4(batch_shape=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (*batch_shape, 4, 4))


def lorentz(v):
    """Symmetric Lorentz boost matrix for 3-velocity v (units of c).

    Mirrors the closed form of /root/reference/Vector.cpp:175-187:
      row0 = (gamma, -gamma*v)
      rows 1..3: delta_ij + (gamma-1) v_i v_j / |v|^2, first column -gamma*v_i.
    v == 0 yields the identity exactly.

    v: (..., 3) -> (..., 4, 4)
    """
    v = jnp.asarray(v, jnp.float32)
    vsqr = jnp.sum(v * v, axis=-1)  # (...,)
    gamma = 1.0 / jnp.sqrt(1.0 - vsqr)
    # Guard the 0/0 in the spatial projector; masked out below.
    safe_vsqr = jnp.where(vsqr == 0.0, 1.0, vsqr)
    g1 = (gamma - 1.0) / safe_vsqr  # (...,)

    vg = -v * gamma[..., None]  # (..., 3)
    top = jnp.concatenate([gamma[..., None], vg], axis=-1)  # (..., 4)
    # Spatial 3x3 block: I + g1 * outer(v, v)
    outer = v[..., :, None] * v[..., None, :]  # (..., 3, 3)
    spatial = jnp.eye(3, dtype=v.dtype) + g1[..., None, None] * outer
    rows = jnp.concatenate([vg[..., :, None], spatial], axis=-1)  # (..., 3, 4)
    M = jnp.concatenate([top[..., None, :], rows], axis=-2)  # (..., 4, 4)
    return jnp.where(vsqr[..., None, None] == 0.0, identity4(v.shape[:-1]), M)


def lorentz_pair(v):
    """(boost, inverse boost) for velocity v, i.e. (lorentz(v), lorentz(-v)).

    The reference builds the inverse by flipping the time-space signs in place
    (/root/reference/Vector.cpp:222-232); that construction is algebraically
    and bitwise identical to lorentz(-v).
    """
    return lorentz(v), lorentz(-v)


def add_velocity(v1, v2):
    """Relativistic velocity composition (v1 'boosted by' v2).

    Closed form from /root/reference/Vector.cpp:189-193:
      w = (v1 + v2 + gamma/(1+gamma) * v1 x (v1 x v2)) / (1 + v1.v2)
    with gamma computed from v1.
    """
    v1 = jnp.asarray(v1, jnp.float32)
    v2 = jnp.asarray(v2, jnp.float32)
    gamma = 1.0 / jnp.sqrt(1.0 - dot3(v1, v1))
    coef = gamma / (1.0 + gamma)
    num = v1 + v2 + coef[..., None] * cross3(v1, cross3(v1, v2))
    return num / (1.0 + dot3(v2, v1))[..., None]


def matmul4(a, b):
    """Batched 4x4 matrix product a @ b."""
    return jnp.einsum("...ij,...jk->...ik", a, b)


def transform4(m, v):
    """Apply 4x4 matrix to 4-vector(s): (..., 4, 4) x (..., 4) -> (..., 4).

    Equivalent of transformPoint4D (/root/reference/opencl_kernel.cl:84-91).
    """
    return jnp.einsum("...ij,...j->...i", m, v)


def transform_point3(m, p):
    """Apply affine 4x4 to a 3-point with implicit w=1, dropping bottom row.

    Equivalent of transformPoint (/root/reference/opencl_kernel.cl:75-82).
    m: (..., 4, 4), p: (..., 3) -> (..., 3)
    """
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir3(m, d):
    """Apply the linear 3x3 part of a 4x4 to a direction.

    Equivalent of transformDirection (/root/reference/opencl_kernel.cl:93-99).
    """
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], d)


def transform_normal3(inv_m, n):
    """Transform a surface normal by the inverse-transpose trick.

    Equivalent of applyTranspose (/root/reference/opencl_kernel.cl:102-104):
    returns (inv_m[:3,:3])^T @ n. Caller normalizes.
    """
    return jnp.einsum("...ji,...j->...i", inv_m[..., :3, :3], n)


def rotation_axis_angle(angle, axis):
    """Rodrigues rotation matrix (3x3) about `axis` by `angle` radians.

    Matches /root/reference/Vector.cpp:151-160 exactly, including: the axis is
    normalized only when angle != 0 (angle == 0 yields identity regardless of
    axis, even a zero axis).
    """
    angle = jnp.asarray(angle, jnp.float32)
    axis = jnp.asarray(axis, jnp.float32)
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    # Avoid nan from normalizing a zero axis when angle == 0 (masked out below)
    m = jnp.sqrt(jnp.sum(axis * axis, axis=-1, keepdims=True))
    u = axis / jnp.where(m == 0.0, 1.0, m)
    one_c = 1.0 - c
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    R = jnp.stack(
        [
            jnp.stack([c + ux * ux * one_c, ux * uy * one_c - uz * s, ux * uz * one_c + uy * s], axis=-1),
            jnp.stack([uy * ux * one_c + uz * s, c + uy * uy * one_c, uy * uz * one_c - ux * s], axis=-1),
            jnp.stack([uz * ux * one_c - uy * s, uz * uy * one_c + ux * s, c + uz * uz * one_c], axis=-1),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), R.shape)
    return jnp.where(angle[..., None, None] == 0.0, eye, R)


def trs(translation, angle, axis, scale):
    """Model matrix: translation * rotation(axis, angle) * scale.

    Layout matches /root/reference/Vector.cpp:151-166: the upper 3x3 is
    R * diag(scale) (columns scaled), last column is the translation.
    """
    translation = jnp.asarray(translation, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    R = rotation_axis_angle(angle, axis)
    RS = R * scale[..., None, :]  # scale columns
    top = jnp.concatenate([RS, translation[..., :, None]], axis=-1)  # (...,3,4)
    bottom = jnp.broadcast_to(
        jnp.array([0, 0, 0, 1], jnp.float32), (*top.shape[:-2], 1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def inverse4(m):
    """Analytic 4x4 inverse via the adjugate (cofactor) formula.

    Functional equivalent of calcInvM (/root/reference/Vector.cpp:94-149),
    expressed as a batched cofactor expansion. det == 0 inputs produce inf/nan
    (the reference leaves InvM unset and reports failure; our scenes never hit
    that path).
    """
    m = jnp.asarray(m, jnp.float32)

    def det2(r0, r1, c0, c1):
        return m[..., r0, c0] * m[..., r1, c1] - m[..., r0, c1] * m[..., r1, c0]

    # 2x2 minors of the bottom two / relevant row pairs.
    # Cofactor expansion along rows, standard adjugate assembly.
    A2323 = det2(2, 3, 2, 3)
    A1323 = det2(2, 3, 1, 3)
    A1223 = det2(2, 3, 1, 2)
    A0323 = det2(2, 3, 0, 3)
    A0223 = det2(2, 3, 0, 2)
    A0123 = det2(2, 3, 0, 1)
    A2313 = det2(1, 3, 2, 3)
    A1313 = det2(1, 3, 1, 3)
    A1213 = det2(1, 3, 1, 2)
    A2312 = det2(1, 2, 2, 3)
    A1312 = det2(1, 2, 1, 3)
    A1212 = det2(1, 2, 1, 2)
    A0313 = det2(1, 3, 0, 3)
    A0213 = det2(1, 3, 0, 2)
    A0312 = det2(1, 2, 0, 3)
    A0212 = det2(1, 2, 0, 2)
    A0113 = det2(1, 3, 0, 1)
    A0112 = det2(1, 2, 0, 1)

    m00, m01, m02, m03 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    m10, m11, m12, m13 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]

    det = (
        m00 * (m11 * A2323 - m12 * A1323 + m13 * A1223)
        - m01 * (m10 * A2323 - m12 * A0323 + m13 * A0223)
        + m02 * (m10 * A1323 - m11 * A0323 + m13 * A0123)
        - m03 * (m10 * A1223 - m11 * A0223 + m12 * A0123)
    )
    inv_det = 1.0 / det

    r0 = jnp.stack(
        [
            m11 * A2323 - m12 * A1323 + m13 * A1223,
            -(m01 * A2323 - m02 * A1323 + m03 * A1223),
            m01 * A2313 - m02 * A1313 + m03 * A1213,
            -(m01 * A2312 - m02 * A1312 + m03 * A1212),
        ],
        axis=-1,
    )
    r1 = jnp.stack(
        [
            -(m10 * A2323 - m12 * A0323 + m13 * A0223),
            m00 * A2323 - m02 * A0323 + m03 * A0223,
            -(m00 * A2313 - m02 * A0313 + m03 * A0213),
            m00 * A2312 - m02 * A0312 + m03 * A0212,
        ],
        axis=-1,
    )
    r2 = jnp.stack(
        [
            m10 * A1323 - m11 * A0323 + m13 * A0123,
            -(m00 * A1323 - m01 * A0323 + m03 * A0123),
            m00 * A1313 - m01 * A0313 + m03 * A0113,
            -(m00 * A1312 - m01 * A0312 + m03 * A0112),
        ],
        axis=-1,
    )
    r3 = jnp.stack(
        [
            -(m10 * A1223 - m11 * A0223 + m12 * A0123),
            m00 * A1223 - m01 * A0223 + m02 * A0123,
            -(m00 * A1213 - m01 * A0213 + m02 * A0113),
            m00 * A1212 - m01 * A0212 + m02 * A0112,
        ],
        axis=-1,
    )
    return jnp.stack([r0, r1, r2, r3], axis=-2) * inv_det[..., None, None]
