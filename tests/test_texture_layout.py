"""ops.texture_layout: Morton tile addressing invariants.

tile_slot is consumed identically by the numpy atlas builder, the XLA
sampler and (via precomputed lanes) the Pallas texture kernels; these
tests pin the algebra those consumers share.
"""

import numpy as np

from relativitypathtracer_tpu.ops.texture_layout import (
    _interleave8, _minimum, region_quads, region_tile_grid, tile_params,
    tile_slot, tile_slot_fast,
)


import pytest

pytestmark = pytest.mark.fast  # inner-loop subset


def _grid(rw, rh):
    lx = np.broadcast_to(np.arange(rw, dtype=np.int64)[None, :], (rh, rw))
    ly = np.broadcast_to(np.arange(rh, dtype=np.int64)[:, None], (rh, rw))
    return lx, ly


def test_slot_bijective_and_bounded():
    """Every texel of a region maps to a UNIQUE slot below region_quads,
    across square, wide, tall, and non-pow2 tile grids."""
    for rw, rh in ((1024, 1024), (224, 225), (48, 130), (3, 2), (16, 16),
                   (1024, 64)):
        wb = -(-rw // 16)
        lx, ly = _grid(rw, rh)
        slot = tile_slot(lx, ly, np.int64(wb), np.int64(rh))
        assert slot.min() >= 0
        assert slot.max() < int(region_quads(np.int64(wb), np.int64(rh)))
        assert len(np.unique(slot)) == rw * rh, (rw, rh)


def test_morton_locality():
    """The point of the layout: a 2D texel neighborhood spans a 1D slot
    range proportional to its AREA, not to its tile-row span. For a 32x32
    texel patch of a 1024^2 region, row-major tile order spans ~2 tile-rows
    = ~32k slots; Morton must stay within a small constant of the patch's
    own slot count."""
    rw = rh = 1024
    wb = -(-rw // 16)
    for ox, oy in ((0, 0), (512, 256), (960, 960), (133, 711)):
        xs = np.arange(ox, min(ox + 32, rw), dtype=np.int64)
        ys = np.arange(oy, min(oy + 32, rh), dtype=np.int64)
        lx = np.broadcast_to(xs[None, :], (len(ys), len(xs)))
        ly = np.broadcast_to(ys[:, None], (len(ys), len(xs)))
        slot = tile_slot(lx, ly, np.int64(wb), np.int64(rh))
        span = int(slot.max() - slot.min())
        assert span <= 16 * 1024, (ox, oy, span)  # vs ~131k for row-major


def _slot_reference(lx, ly, wb, rh):
    """The self-derived formula with TRUE integer division: the ground truth
    tile_params/tile_slot_fast must reproduce (the hot path replaces
    tx // s with the exact multiply-shift (tx * (65536 // s)) >> 16)."""
    tx = lx >> 4
    ty = ly >> 4
    wb2, hb2 = region_tile_grid(wb, rh)
    s = _minimum(wb2, hb2)
    sm1 = s - 1
    m = _interleave8(tx & sm1) | (_interleave8(ty & sm1) << 1)
    extra = (tx // s) | (ty // s)
    tile = extra * (s * s) + m
    return tile * 256 + (ly & 15) * 16 + (lx & 15)


def test_fast_slot_matches_division_formula():
    """tile_slot / tile_slot_fast+tile_params == the division formula for
    every region shape class (square, wide, tall, tiny, max 4096-texel
    axis) over the full texel grid."""
    for rw, rh in ((1024, 1024), (224, 225), (48, 130), (3, 2), (16, 16),
                   (1024, 64), (4096, 32), (17, 4096)):
        wb = -(-rw // 16)
        lx, ly = _grid(rw, rh)
        want = _slot_reference(lx, ly, np.int64(wb), np.int64(rh))
        got = tile_slot(lx, ly, np.int64(wb), np.int64(rh))
        np.testing.assert_array_equal(got, want, err_msg=str((rw, rh)))
        sm1, ss, r16 = tile_params(np.int64(wb), np.int64(rh))
        got_fast = tile_slot_fast(lx, ly, sm1, ss, r16)
        np.testing.assert_array_equal(got_fast, want, err_msg=str((rw, rh)))


def test_tile_params_sentinel_rows():
    """Untextured objects carry all-zero fp rows (models.scene); the derived
    constants must stay benign (s = 1 grid) rather than dividing by zero."""
    sm1, ss, r16 = tile_params(np.int64(0), np.int64(0))
    assert (int(sm1), int(ss), int(r16)) == (0, 1, 65536)


def test_grid_pow2():
    wb2, hb2 = region_tile_grid(np.int64(14), np.int64(225))
    assert (int(wb2), int(hb2)) == (16, 16)
    wb2, hb2 = region_tile_grid(np.int64(64), np.int64(1024))
    assert (int(wb2), int(hb2)) == (64, 64)
    wb2, hb2 = region_tile_grid(np.int64(1), np.int64(2))
    assert (int(wb2), int(hb2)) == (1, 1)
