"""Bilinear texture sampling from the flat byte atlas.

Reproduces the reference's exact tap pattern
(/root/reference/opencl_kernel.cl:427-470), including its quirky clamp
sequence: after clamping x+1 for the second tap, the fourth tap uses
clamp((x+1)-1), which differs from the original x when x was at the border.
Per-pixel texture (offset, width, height) come from the hit object, so mixed
texture sizes batch fine; out-of-atlas lanes must be masked by the caller.

LAYOUT: rays on the last axis -- uv is (2, N), outputs (3, N).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_sample_packed(atlas_u32, offset_texels, width, height, uv):
    """Bilinear sample from the RGB-packed uint32 atlas.

    atlas_u32: (R, 8) uint32 rows (flat texel index = 8*row + lane).
    Each tap is one row gather of a 32-byte row ((N, 8) u32) + a one-hot
    8-lane select. Texel layout: R | G<<8 | B<<16.

    offset_texels: (N,) int32 (byte offset / 3); uv: (2, N).
    Returns (3, N) float RGB in [0, 1].
    """
    w = width
    h = height
    u = w.astype(jnp.float32) * uv[0]
    v = h.astype(jnp.float32) * (1.0 - uv[1])
    x = jnp.minimum(jnp.floor(u).astype(jnp.int32), w - 1)
    y = jnp.minimum(jnp.floor(v).astype(jnp.int32), h - 1)
    u_ratio = u - x.astype(jnp.float32)
    v_ratio = v - y.astype(jnp.float32)
    u_opp = 1.0 - u_ratio
    v_opp = 1.0 - v_ratio

    x0 = jnp.clip(x, 0, w - 1)
    y0 = jnp.clip(y, 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x2 = jnp.clip(x1 - 1, 0, w - 1)  # reference tap quirk preserved

    limit = atlas_u32.shape[0] * 8 - 1
    n = uv.shape[1]

    def fetch(xi, yi):
        idx = jnp.clip(offset_texels + w * yi + xi, 0, limit)
        rows = jnp.take(atlas_u32, idx >> 3, axis=0)  # (N, 8) row gather
        lane = jax.lax.broadcasted_iota(jnp.int32, (n, 8), 1) == (idx & 7)[:, None]
        packed = jnp.sum(jnp.where(lane, rows, 0), axis=1)
        r = (packed & 0xFF).astype(jnp.float32)
        g = ((packed >> 8) & 0xFF).astype(jnp.float32)
        b = ((packed >> 16) & 0xFF).astype(jnp.float32)
        return jnp.stack([r, g, b]) / 255.0

    row1 = (fetch(x0, y0) * u_opp + fetch(x1, y0) * u_ratio) * v_opp
    row2 = (fetch(x1, y1) * u_ratio + fetch(x2, y1) * u_opp) * v_ratio
    return row1 + row2


def bilinear_sample_footprint(quads, fp, width, height, uv):
    """Bilinear sample via the precomputed footprint atlas: ONE 32-byte row
    gather per pixel fetches all 4 reference taps (models.scene
    _footprint_atlas), vs ~2.6ms per separate 786k-ray tap.

    quads: (Rq, 8) uint32 (4 consecutive u32 per (x0, y0) footprint);
    fp: (6, N) int32 per-pixel region params [base rx ry wb rw rh], or
    (9, N) with precomputed tile_params rows [sm1 ss r16] appended (skips
    the per-ray pow2-grid math and integer division);
    width/height: (N,) int32; uv: (2, N). Returns (3, N) float RGB in [0, 1].
    """
    w = width
    h = height
    u = w.astype(jnp.float32) * uv[0]
    v = h.astype(jnp.float32) * (1.0 - uv[1])
    x = jnp.minimum(jnp.floor(u).astype(jnp.int32), w - 1)
    y = jnp.minimum(jnp.floor(v).astype(jnp.int32), h - 1)
    u_ratio = u - x.astype(jnp.float32)
    v_ratio = v - y.astype(jnp.float32)
    u_opp = 1.0 - u_ratio
    v_opp = 1.0 - v_ratio
    x0 = jnp.clip(x, 0, w - 1)
    y0 = jnp.clip(y, 0, h - 1)

    n = uv.shape[1]
    base_quad, rx, ry, wb, rw, rh = fp[0], fp[1], fp[2], fp[3], fp[4], fp[5]
    # region-local coordinates; clamping is a no-op for addressable uvs
    lx = jnp.clip(x0 - rx, 0, jnp.maximum(rw - 1, 0))
    ly = jnp.clip(y0 - ry, 0, jnp.maximum(rh - 1, 0))
    # Morton-tiled slot (ops.texture_layout): shared with the builder and
    # the Pallas texture kernels.
    from .texture_layout import tile_slot, tile_slot_fast

    if fp.shape[0] >= 9:
        slot = tile_slot_fast(lx, ly, fp[6], fp[7], fp[8])
    else:
        slot = tile_slot(lx, ly, wb, rh)
    idx4 = jnp.clip((base_quad + slot) * 4, 0, quads.shape[0] * 8 - 4)
    rows = jnp.take(quads, idx4 >> 3, axis=0)  # (N, 8)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (n, 8), 1)
    lb = (idx4 & 7)[:, None]

    def texel(k):
        packed = jnp.sum(jnp.where(lanes == lb + k, rows, 0), axis=1)
        r = (packed & 0xFF).astype(jnp.float32)
        g = ((packed >> 8) & 0xFF).astype(jnp.float32)
        b = ((packed >> 16) & 0xFF).astype(jnp.float32)
        return jnp.stack([r, g, b]) / 255.0

    # taps: [(x0,y0), (x1,y0), (x1,y1), (x2,y1)] matching the reference order
    row1 = texel(0) * u_opp + texel(1) * u_ratio
    row2 = texel(2) * u_ratio + texel(3) * u_opp
    return row1 * v_opp + row2 * v_ratio
