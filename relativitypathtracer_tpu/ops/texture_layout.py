"""Footprint-atlas tile addressing, shared by the builder and every sampler.

Texels are stored as 16x16-texel tiles (256 footprint quads each). Tiles
within a region are laid out in MORTON (Z-curve) order over the region's
tile grid (each axis padded to a power of two): a screen block's 2D texel
footprint then maps to a COMPACT 1D range of atlas rows instead of spanning
whole tile rows (one tile-row of a 1024^2 texture spans 8,192 atlas rows in
row-major order), which keeps a block's gathers local in memory.

Everything here is plain operator arithmetic (&, |, shifts, comparisons) so
the SAME functions run on numpy arrays (scene build), jnp traced arrays
(the XLA sampler) and inside Pallas kernels. Axes support up to 256 tiles
(4096-texel textures); the builder asserts this.

Addressing parameters come from the per-object fp row [base rx ry wb rw rh]
(models.scene): wb = ceil(rw/16) tiles per row, rh = region texel height.
"""

from __future__ import annotations

MAX_TILES_PER_AXIS = 256  # 8-bit Morton interleave -> textures <= 4096 px


def _next_pow2(x):
    x = x - 1
    for k in (1, 2, 4, 8):
        x = x | (x >> k)
    return x + 1


def _interleave8(x):
    """Spread the low 8 bits of x to even bit positions."""
    x = (x | (x << 4)) & 0x0F0F
    x = (x | (x << 2)) & 0x3333
    x = (x | (x << 1)) & 0x5555
    return x


def region_tile_grid(wb, rh):
    """Padded-pow2 tile grid (wb2, hb2) for a region with wb tiles per row
    and rh texel rows. Works on scalars and arrays."""
    hb = (rh + 15) >> 4
    one = wb * 0 + 1
    wb2 = _next_pow2(_maximum(wb, one))
    hb2 = _next_pow2(_maximum(hb, one))
    return wb2, hb2


def _maximum(a, b):
    ge = a >= b
    return a * ge + b * (1 - ge)


def _minimum(a, b):
    le = a <= b
    return a * le + b * (1 - le)


def tile_params(wb, rh):
    """Region-derived addressing constants (sm1, ss, r16) for
    tile_slot_fast. They depend only on the REGION shape, so hot samplers
    hoist them to per-object scale (one row each in the renderer's fused
    attribute select) instead of re-deriving the pow2 grid per ray: the
    per-lane `_next_pow2` chains and the variable integer division drop out
    of the per-ray path entirely.
    r16 = 65536 // s is the exact multiply-shift reciprocal of the pow2
    Morton core size s (tile counts <= 256 so tx * r16 < 2^24)."""
    wb2, hb2 = region_tile_grid(wb, rh)
    s = _minimum(wb2, hb2)
    return s - 1, s * s, 65536 // s


def tile_slot_fast(lx, ly, sm1, ss, r16):
    """tile_slot with the region constants precomputed (tile_params).
    Division-free and _next_pow2-free: tx // s == (tx * r16) >> 16 exactly
    for 0 <= tx <= 255 and pow2 s."""
    tx = lx >> 4
    ty = ly >> 4
    m = _interleave8(tx & sm1) | (_interleave8(ty & sm1) << 1)
    extra = ((tx * r16) >> 16) | ((ty * r16) >> 16)  # longer axis' high bits
    tile = extra * ss + m
    return tile * 256 + (ly & 15) * 16 + (lx & 15)


def tile_slot(lx, ly, wb, rh):
    """Footprint-quad slot of region-local texel (lx, ly): Morton tile index
    (square pow2 core, extra high bits of the longer axis appended above)
    times 256, plus the row-major offset within the 16x16 tile.

    NO per-lane-variable-amount shifts anywhere: the high bits are
    extracted with an exact multiply-shift by the reciprocal of the
    (power-of-two) core size (tile_slot_fast), which every backend lowers
    to plain integer multiplies. Samplers on the hot path precompute tile_params per
    OBJECT instead of calling this per ray."""
    return tile_slot_fast(lx, ly, *tile_params(wb, rh))


def region_quads(wb, rh):
    """Total footprint quads a region occupies (padded pow2 tile grid)."""
    wb2, hb2 = region_tile_grid(wb, rh)
    return wb2 * hb2 * 256
