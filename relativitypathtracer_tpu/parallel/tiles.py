"""Multi-chip rendering: shard the pixel grid across a device mesh.

The reference is strictly single-device (one OpenCL device,
/root/reference/CLSetup.cpp:86-98); its only parallelism is the flat NDRange
over pixels. The scale-out of that axis here is data parallelism over the
renderer's 1024-lane culling blocks (32x32 screen tiles, or (32/m)^2
patches with folded MSAA samples): each device renders an equal number of
blocks with the scene pytree replicated, and the full frame materializes
sharded across devices (an all-gather only happens if the host fetches it).
Every card reaches every other at the same rate, so the mesh is 1-D.
The only in-frame collective is an optional psum of the tiny aux counters;
rays never cross blocks.

Blocks are dealt along diagonals by default ("strided"), so every device's
blocks sample the whole image: scene geometry concentrates in the center of
the frame, and contiguous row-bands leave edge devices idle while center
devices carry all the mesh-walk work (band_mesh_work measures the skew).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.7 exposes shard_map at top level; fall back for older
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..models.scene import Scene, SceneMeta
from ..ops.camera import camera_ray_dirs
from ..ops.mesh_intersect import resolve_kernels
from ..ops.tonemap import tonemap
from ..render import (
    FrameState, TILE, _round_up, msaa_swizzle, object_frames, shade,
    tile_swizzle, tile_unswizzle,
)

LANES = TILE * TILE  # rays per kernel block


def deal_blocks(n_dev: int, rows: int, cols: int, assign: str):
    """Deal the frame's 1024-lane kernel blocks (a rows x cols patch grid in
    patch-row-major order) to devices.

    "contiguous": device b owns the b-th horizontal band of blocks -- simple,
    but load-skewed for center-heavy scenes. "strided" (default): device b
    owns the wrap-around DIAGONAL class (patch_r + patch_c) % n_dev == b, so
    each device's blocks sweep both image axes evenly (a 1D deal over the
    row-major order degenerates to stripes whenever n_dev divides the grid
    pitch) and per-device work skew drops to per-block variance. When class
    sizes are unequal the stable sort spills boundary blocks to the next
    device, keeping counts exactly equal. The gathered output is
    de-interleaved with the returned inverse permutation.
    Returns (dev_blocks (n_dev, bpd) int64, inv (n_blocks,))."""
    if assign not in ("contiguous", "strided"):
        raise ValueError(f"band assign must be contiguous|strided, got {assign}")
    n_blocks = rows * cols
    if n_blocks % n_dev:
        raise ValueError(f"{n_blocks} blocks not divisible by {n_dev} devices")
    bpd = n_blocks // n_dev
    if assign == "contiguous":
        dev_blocks = np.arange(n_blocks, dtype=np.int64).reshape(n_dev, bpd)
    else:
        f = np.arange(n_blocks, dtype=np.int64)
        cls = (f // cols + f % cols) % n_dev
        dev_blocks = f[np.argsort(cls, kind="stable")].reshape(n_dev, bpd)
    inv = np.argsort(dev_blocks.reshape(-1))
    return dev_blocks, inv


def build_sharded_render_fn(meta: SceneMeta, width: int, height: int, interval: int,
                            mesh: Mesh, axis: str = "tiles", msaa: int = 1,
                            with_aux: bool = False, band_assign: str = "strided"):
    """Compile a renderer that splits the frame's kernel blocks across `mesh`
    (1D). Returns render(scene, state) -> (H, W, 3) float image, or
    (image, aux) when with_aux (aux counters psum'd over the mesh, so every
    device holds the frame totals -- the only in-frame collective).

    The image is padded so every device gets an equal number of 32x32 tiles;
    the padding is cropped after the gather. msaa folds the sample sets into
    each block's ray axis exactly like the single-device renderer
    (render.msaa_swizzle); supported values are 1, 2, 4, 8, 16.
    """
    if msaa not in (1, 2, 4, 8, 16):
        raise ValueError(f"sharded renderer supports msaa in 1/2/4/8/16, got {msaa}")
    n_dev = mesh.shape[axis]
    pw = _round_up(width, TILE)
    band_h = _round_up(-(-height // n_dev), TILE)
    ph = band_h * n_dev
    p = TILE // msaa  # patch edge in pixels
    q = p * p  # pixels per block
    n_blocks = (ph // p) * (pw // p)
    bpd = n_blocks // n_dev
    dev_blocks, inv_blocks = deal_blocks(n_dev, ph // p, pw // p, band_assign)

    # Same eager precompute as build_render_fn so per-pixel results match the
    # single-device renderer bit-for-bit (jit-fused dir math differs slightly).
    dirs = camera_ray_dirs(width, height, msaa, pad_width=pw, pad_height=ph)
    if msaa == 1:
        full = tile_swizzle(dirs.reshape(-1, 3).T, ph, pw)
    else:
        full = msaa_swizzle(dirs, ph, pw, msaa)
    full = full.reshape(3, n_blocks, LANES)
    dirs_bands = jnp.stack(
        [full[:, dev_blocks[b]].reshape(3, -1) for b in range(n_dev)]
    )  # (n_dev, 3, bpd * LANES)
    dirs_bands = jax.device_put(dirs_bands)

    def band_render(scene: Scene, state: FrameState, d_band):
        # Runs per-device: render this device's dealt blocks. d_band arrives
        # pre-sharded ((1, 3, bpd*LANES) shard of dirs_bands): each device
        # stores only ITS rays -- closing over the full array replicated the
        # frame's largest constant n_dev-fold in HBM.
        L, inv_L, stat_cam = object_frames(scene.objects, state)
        d = d_band[0]
        with jax.default_matmul_precision("highest"):
            color, aux = shade(scene, meta, L, inv_L, stat_cam, d, interval)
        if msaa > 1:
            # Block lanes run (quad_r, quad_c, r, c, sample): average the
            # minor sample axis; pixels stay in block quadrant-major order.
            color = color.reshape(3, bpd * q, msaa * msaa).mean(axis=2)
        img = tonemap(color.T, scene.white_point).reshape(bpd, q, 3)
        if with_aux:
            # frame totals on every device; the frame's only collective
            return img, jax.tree.map(lambda x: jax.lax.psum(x, axis), aux)
        return img

    sharded = shard_map(
        band_render,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),  # scene + state replicated; dirs sharded
        # blocks concatenate over devices; psum'd aux is replicated
        out_specs=(P(axis, None, None), P()) if with_aux else P(axis, None, None),
        # Static replication checking is ON for the jnp path AND the
        # compiled Triton walks: scan/while carries initialized from
        # constants inside ops.mesh_intersect are pcast to the rays' varying
        # axes (ops.mesh_intersect._vma_like), and every pallas_call
        # out_shape declares its vma (ops.pallas.ray_vma). Only
        # INTERPRET-mode Pallas fails upstream (the interpreter evaluates
        # the kernel body under vma rules, where ref loads mix varying and
        # replicated values), so that mode alone relies on the dynamic
        # coverage in tests/test_parallel.py (sharded vs single-device
        # equality).
        check_vma=not resolve_kernels()[1],
    )

    inv = jnp.asarray(inv_blocks)

    @jax.jit
    def render(scene: Scene, state: FrameState):
        out = sharded(scene, state, dirs_bands)
        if with_aux:
            blocks, aux = out
        else:
            blocks = out
        if band_assign != "contiguous":
            blocks = blocks[inv]  # de-interleave the dealt blocks
        vec = blocks.transpose(2, 0, 1).reshape(3, ph * pw)
        img = tile_unswizzle(vec, ph, pw, p)
        img = img.reshape(3, ph, pw).transpose(1, 2, 0)[:height, :width]
        return (img, aux) if with_aux else img

    return render


def per_block_mesh_work(scene: Scene, meta: SceneMeta, width: int,
                        height: int, n_dev: int, state=None,
                        interval: int | None = None):
    """Per-BLOCK mesh-work proxy: primary rays whose nearest hit is a MESH
    object, summed per 1024-lane block. Mesh-hit rays approximate each
    block's share of the mesh-walk work. The expensive intersect depends only on
    the (n_dev-padded) grid, NOT the block assignment -- compute it once
    and repartition with partition_work for each assignment under test.
    Returns (per_block (n_blocks,) f32, grid_rows, grid_cols)."""
    from ..render import intersect_scene

    if state is None:
        state = FrameState.initial()
    if interval is None:
        interval = meta.default_interval
    pw = _round_up(width, TILE)
    band_h = _round_up(-(-height // n_dev), TILE)
    ph = band_h * n_dev
    n_blocks = (ph // TILE) * (pw // TILE)

    dirs = camera_ray_dirs(width, height, 1, pad_width=pw, pad_height=ph)
    d = tile_swizzle(dirs.reshape(-1, 3).T, ph, pw)  # (3, ph*pw)
    L, inv_L, stat_cam = object_frames(scene.objects, state)
    dir4 = jnp.concatenate(
        [jnp.full((1, d.shape[1]), float(interval)), d], axis=0)
    _, _, _, obj, did_hit = intersect_scene(scene, meta, L, stat_cam, dir4,
                                            interval)
    mesh_hit = did_hit & jnp.isin(obj, jnp.asarray(meta.mesh_ids, jnp.int32))
    # Padding rows AND columns render but carry no real work: mask both
    # (right-edge blocks' padded columns would otherwise inflate whichever
    # devices own them and skew the metric).
    row_img = jnp.broadcast_to(jnp.arange(ph, dtype=jnp.float32)[:, None],
                               (ph, pw))
    col_img = jnp.broadcast_to(jnp.arange(pw, dtype=jnp.float32)[None, :],
                               (ph, pw))
    row = tile_swizzle(row_img.reshape(1, -1), ph, pw)[0]
    col = tile_swizzle(col_img.reshape(1, -1), ph, pw)[0]
    work = (mesh_hit & (row < height) & (col < width)).astype(jnp.float32)
    per_block = np.asarray(work.reshape(n_blocks, LANES).sum(axis=1))
    return per_block, ph // TILE, pw // TILE


def partition_work(per_block, grid_rows: int, grid_cols: int, n_dev: int,
                   assign: str):
    """Deal per-block work onto n_dev devices under `assign`; returns
    (counts (n_dev,) int64, skew = max/mean)."""
    dev_blocks, _ = deal_blocks(n_dev, grid_rows, grid_cols, assign)
    counts = np.array([int(per_block[dev_blocks[b]].sum())
                       for b in range(n_dev)])
    mean = counts.mean()
    skew = float(counts.max() / mean) if mean > 0 else 0.0
    return counts, skew


def band_mesh_work(scene: Scene, meta: SceneMeta, width: int, height: int,
                   n_dev: int, assign: str = "strided", state=None,
                   interval: int | None = None):
    """counts/skew for ONE assignment (per_block_mesh_work + partition_work
    convenience; compare several assignments via the split API so the
    intersect runs once)."""
    per_block, rows, cols = per_block_mesh_work(
        scene, meta, width, height, n_dev, state=state, interval=interval)
    return partition_work(per_block, rows, cols, n_dev, assign)


def default_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
