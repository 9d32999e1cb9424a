"""The sparse semantic TSDF voxel map: allocation, fusion, carving, export.

A JAX re-design of the reference's CUDA TSDF engine
(`/root/reference/utils/tsdf/voxel_tsdf.cu`, `voxel_mem.cu`,
`voxel_hash.cu`). Same behavior, different mechanics:

  reference (CUDA)                        this module (JAX/XLA)
  -----------------------------------     --------------------------------
  per-thread AquireBlock with atomic      batch allocation: sort-unique of
  free-counter + spin-locked hash         candidate keys, cumsum free-list,
  insert, drop on contention              deterministic claim-insert
  check_visibility + Blelloch scan +      frustum test over the whole pool
  gather kernel                           + argsort compaction (static Vmax)
  tsdf_integrate_kernel, 1 thread/voxel   one gather/FMA pass over
  gather-style, no atomics                [Vmax, 512] voxels, scatter back
  space_carving_kernel shared-mem         masked min-reduce + batched hash
  min-reduce + device Delete              remove

Fusion math matches the reference integrate kernel
(`voxel_tsdf.cu:170-251`): range-scaled SDF, weighted running averages
for tsdf/rgb with weight heuristic ``(1 - d/max_depth) * 4`` clamped at
40, and Bayesian semantic fusion (the reference's weighted geometric
mean of positive/negative evidence == weighted log-odds average, which
is how we compute it — numerically stabler).

New blocks initialize to tsdf=-1, weight=1, prob=0.5 exactly like
`VoxelMemPool::AquireBlock` (`voxel_mem.cu:37-54`).

Everything here is jit-compatible with static shapes; per-frame variable
counts (visible blocks, new allocations) are handled with fixed
capacities + masks, with overflow *counted* rather than silently
truncated.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map.blocks import (
    BLOCK_LEN,
    BLOCK_VOLUME,
    INVALID_KEY,
    pack_block_coords,
    unpack_block_coords,
    voxel_offsets,
)
from ra_slam_tpu.map.fusion import resolve_fuse
from ra_slam_tpu.map.hash_table import HashTable, ht_insert, ht_lookup, ht_remove

class VoxelMap(NamedTuple):
    """Fixed-capacity SoA voxel-block pool + spatial hash (a pytree)."""

    table: HashTable
    block_key: jax.Array  # [N] int32, INVALID_KEY when free
    block_slot: jax.Array  # [N] int32 table slot (O(1) delete), -1 when free
    active: jax.Array  # [N] bool
    tsdf: jax.Array  # [N, 512] float32 in [-1, 1]
    weight: jax.Array  # [N, 512] float32
    rgb: jax.Array  # [N, 3, 512] float32 in [0, 255] (channel-major, so
    #   every payload row is [*, 512] and moves as one row gather)
    prob: jax.Array  # [N, 512] float32 high-touch probability
    alloc_failures: jax.Array  # int32 scalar, cumulative
    # Explicit free-row stack (the reference keeps an atomic free-list
    # counter, voxel_mem.cu:37-41): rows free_stack[0:free_top] are the
    # free pool rows. Allocation pops from the top, carving pushes
    # released rows back: one small gather instead of a full-pool cumsum
    # ranking per frame. Active rows + stacked rows partition the pool
    # at all times.
    free_stack: jax.Array  # [N] int32 pool-row ids
    free_top: jax.Array  # int32 scalar (per-shard [1] under shard_map)

    @property
    def num_blocks(self) -> int:
        return self.block_key.shape[0]


def create_map(cfg: TsdfConfig) -> VoxelMap:
    n = cfg.num_blocks
    return VoxelMap(
        table=HashTable.create(cfg.log2_hash_size),
        block_key=jnp.full((n,), INVALID_KEY, dtype=jnp.int32),
        block_slot=jnp.full((n,), -1, dtype=jnp.int32),
        active=jnp.zeros((n,), dtype=bool),
        tsdf=jnp.full((n, BLOCK_VOLUME), -1.0, dtype=jnp.float32),
        weight=jnp.ones((n, BLOCK_VOLUME), dtype=jnp.float32),
        rgb=jnp.zeros((n, 3, BLOCK_VOLUME), dtype=jnp.float32),
        prob=jnp.full((n, BLOCK_VOLUME), 0.5, dtype=jnp.float32),
        alloc_failures=jnp.int32(0),
        free_stack=jnp.arange(n, dtype=jnp.int32),
        free_top=jnp.int32(n),
    )


def num_active(m: VoxelMap) -> jax.Array:
    return jnp.sum(m.active.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def allocate_keys(
    m: VoxelMap, cand_keys: jax.Array, max_new_blocks: int = 8192
) -> VoxelMap:
    """Allocate blocks for a batch of candidate keys [M] (may contain
    duplicates and INVALID_KEY). Deterministic replacement for the
    reference's per-pixel lock-contended `VoxelHashTable::Allocate`.
    """
    n = m.num_blocks

    # 1. sort + dedup (INVALID_KEY sorts to the end and is dropped).
    skeys = jnp.sort(cand_keys)
    uniq = (skeys != jnp.roll(skeys, 1)) & (skeys != INVALID_KEY)
    uniq = uniq.at[0].set(skeys[0] != INVALID_KEY)
    n_uniq = jnp.sum(uniq.astype(jnp.int32))

    # 2. compact the unique keys to a small window FIRST, so the hash
    #    lookup probes ~10^4 keys instead of the full candidate batch
    #    (the lookup's gather traffic was the #1 cost of allocation).
    take = min(max_new_blocks, cand_keys.shape[0])
    u_cap = min(2 * take, cand_keys.shape[0])
    dest = jnp.cumsum(uniq.astype(jnp.int32)) - 1
    dest = jnp.where(uniq & (dest < u_cap), dest, u_cap)
    ukeys = jnp.full((u_cap,), INVALID_KEY, dtype=jnp.int32).at[dest].set(
        skeys, mode="drop"
    )
    uniq_dropped = jnp.maximum(n_uniq - u_cap, 0)

    # 3. drop keys already in the table, compact the first
    #    max_new_blocks new keys (stable: ukeys are sorted).
    exists = ht_lookup(m.table, ukeys) >= 0
    new_mask = (ukeys != INVALID_KEY) & ~exists
    n_new = jnp.sum(new_mask.astype(jnp.int32))
    dest = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    dest = jnp.where(new_mask & (dest < take), dest, take)
    cand = jnp.full((take,), INVALID_KEY, dtype=jnp.int32).at[dest].set(
        ukeys, mode="drop"
    )
    cvalid = cand != INVALID_KEY
    overflow = n_new - jnp.sum(cvalid.astype(jnp.int32)) + uniq_dropped

    # 4. pop free pool rows off the free stack (reference: atomic
    #    free-list counter, voxel_mem.cu:37-41). `cvalid` is a prefix
    #    mask (step 3's compaction is stable), so candidate i takes
    #    stack position free_top-1-i — one [take]-sized gather instead
    #    of a full-pool cumsum ranking.
    stack_pos = m.free_top - 1 - jnp.arange(take, dtype=jnp.int32)
    havepool = (stack_pos >= 0) & cvalid
    pool_idx = jnp.where(
        havepool, m.free_stack[jnp.clip(stack_pos, 0, n - 1)], -1
    )
    ins_valid = cvalid & havepool
    pool_exhausted = jnp.sum((cvalid & ~havepool).astype(jnp.int32))

    # 5. claim-insert into the hash table.
    table, slots, placed = ht_insert(m.table, cand, pool_idx, ins_valid)
    n_popped = jnp.sum(ins_valid.astype(jnp.int32))
    probe_failed = n_popped - jnp.sum(placed.astype(jnp.int32))

    # 5b. rows whose bucket was full keep their pool slot: push them
    #     back onto the stack (above the new top, below the old pops).
    failed = ins_valid & ~placed
    new_top = m.free_top - n_popped + probe_failed
    fdest = m.free_top - n_popped + jnp.cumsum(failed.astype(jnp.int32)) - 1
    free_stack = m.free_stack.at[
        jnp.where(failed, fdest, n)
    ].set(pool_idx, mode="drop")

    # 6. activate the acquired blocks. Their payloads are NOT written
    #    here: free pool rows are kept pre-initialized (tsdf=-1,
    #    weight=1, prob=0.5; voxel_mem.cu:45-52) — by create_map at
    #    start and by space_carve on release — so allocation stays a
    #    cheap metadata-only op instead of a 400 MB/frame scatter.
    bidx = jnp.where(placed, pool_idx, n)
    block_key = m.block_key.at[bidx].set(cand, mode="drop")
    block_slot = m.block_slot.at[bidx].set(slots, mode="drop")
    active = m.active.at[bidx].set(True, mode="drop")

    return m._replace(
        table=table,
        block_key=block_key,
        block_slot=block_slot,
        active=active,
        free_stack=free_stack,
        free_top=new_top,
        alloc_failures=m.alloc_failures + overflow + pool_exhausted + probe_failed,
    )


def depth_to_candidate_keys(
    depth: jax.Array,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    stride: int = 1,
) -> jax.Array:
    """Per-pixel candidate block keys: back-project depth and sample the
    ray segment [d - truncation, d + truncation] (the reference's
    per-pixel DDA march, `voxel_tsdf.cu:120-168`). Returns flat [M] keys
    with INVALID_KEY for invalid pixels.
    """
    block_size = BLOCK_LEN * cfg.voxel_size
    # sample spacing <= half a block so no crossed block is skipped
    n_steps = int(2 * cfg.truncation / (0.5 * block_size)) + 2

    d = depth[::stride, ::stride]
    u = jax.lax.broadcasted_iota(jnp.float32, d.shape, 1) * stride
    v = jax.lax.broadcasted_iota(jnp.float32, d.shape, 0) * stride
    valid = (d > cfg.min_depth) & (d <= cfg.max_depth)

    uv = jnp.stack([u, v], axis=-1)
    p_cam = cam.unproject(uv, jnp.where(valid, d, 1.0))  # [h, w, 3]
    ray_len = jnp.linalg.norm(p_cam, axis=-1, keepdims=True)
    u_dir = p_cam / jnp.maximum(ray_len, 1e-9)

    ts = jnp.linspace(-cfg.truncation, cfg.truncation, n_steps)
    # [h, w, S, 3] sample points in camera frame
    pts_cam = p_cam[..., None, :] + u_dir[..., None, :] * ts[:, None]
    world_T_cam = cam_T_world.inverse()
    pts_world = world_T_cam.apply(pts_cam)

    bcoords = jnp.floor(pts_world / block_size).astype(jnp.int32)
    keys = pack_block_coords(bcoords)
    keys = jnp.where(valid[..., None], keys, INVALID_KEY)
    return keys.reshape(-1)


def allocate_from_depth(
    m: VoxelMap,
    depth: jax.Array,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    stride: int = 1,
) -> VoxelMap:
    keys = depth_to_candidate_keys(depth, cam, cam_T_world, cfg, stride)
    return allocate_keys(m, keys, cfg.max_new_blocks)


# ---------------------------------------------------------------------------
# Visibility + compaction
# ---------------------------------------------------------------------------


def visible_blocks(
    m: VoxelMap,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Conservative frustum culling over the whole pool + compaction.

    Replaces check_visibility_kernel + prefix-sum + gather
    (`voxel_tsdf.cu:98-118,847-867`). Returns (indices [Vmax], mask
    [Vmax], count) where count may exceed Vmax (overflow is clamped).
    """
    block_size = BLOCK_LEN * cfg.voxel_size
    base = unpack_block_coords(m.block_key).astype(jnp.float32) * block_size
    corner_offs = jnp.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=jnp.float32,
    ) * block_size  # [8, 3]
    corners = base[:, None, :] + corner_offs[None]  # [N, 8, 3]
    c_cam = cam_T_world.apply(corners)
    uv, z = cam.project(c_cam)
    u, v = uv[..., 0], uv[..., 1]

    zmax = cfg.max_depth + cfg.truncation
    out = (
        jnp.all(z <= 0.0, axis=1)
        | jnp.all(z > zmax, axis=1)
        | jnp.all(u < 0.0, axis=1)
        | jnp.all(u > cam.width - 1, axis=1)
        | jnp.all(v < 0.0, axis=1)
        | jnp.all(v > cam.height - 1, axis=1)
    )
    visible = m.active & ~out

    count = jnp.sum(visible.astype(jnp.int32))
    vmax = cfg.max_visible_blocks
    dest = jnp.cumsum(visible.astype(jnp.int32)) - 1
    dest = jnp.where(visible & (dest < vmax), dest, vmax)
    idx = jnp.zeros((vmax,), dtype=jnp.int32).at[dest].set(
        jnp.arange(m.num_blocks, dtype=jnp.int32), mode="drop"
    )
    mask = jnp.arange(vmax) < jnp.minimum(count, vmax)
    return idx, mask, count


# ---------------------------------------------------------------------------
# Integration (the hot kernel)
# ---------------------------------------------------------------------------


def _integrate_prep(
    m: VoxelMap,
    vis_idx: jax.Array,
    vis_mask: jax.Array,
    rgb_img: jax.Array,
    depth_img: jax.Array,
    ht_img: jax.Array,
    lt_img: jax.Array,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
):
    """Pre-pass of `integrate`: project the visible voxels, build the
    mip-tile atlas, fetch one tile per block, and compute the per-voxel
    tile index + gating.

    One block's 512 voxels project into a small uv footprint: pick a
    mip level so the footprint spans <= 8 px, and fetch ONE pre-built
    overlapping 16x16 tile that is guaranteed to contain it (tiles at
    stride 8: any 8-px window starting inside a stride-8 cell ends
    within that cell's 16-px tile). The tile fetch is one row gather of
    [NT, 6, TP^2]; each voxel then reads its pixel inside the tile.
    Blocks spanning 9-16 px read the next mip level, i.e. every other
    pixel — still >= their 8-voxel-per-axis density. (The layout was
    chosen where a per-element image gather was the hottest stage; the
    per-voxel sample it yields is now the map's definition of which
    pixel a voxel sees.)

    Returns (patch [V,6,TP*TP], idx [V,512] i32, z_cam, d2r, gate
    [V,512] f32).
    """
    H, W = depth_img.shape
    P = 8  # max footprint span; mip level chosen so it fits
    CELL = 8  # tile grid stride
    TP = 16  # tile edge: CELL-aligned window of P=8 always fits
    base_voxel = unpack_block_coords(m.block_key[vis_idx]) * BLOCK_LEN  # [V, 3]
    offs = voxel_offsets()  # [512, 3]
    grid = base_voxel[:, None, :] + offs[None]  # [V, 512, 3]
    world = grid.astype(jnp.float32) * cfg.voxel_size
    p_cam = cam_T_world.apply(world)  # [V, 512, 3]
    uv, z_cam = cam.project(p_cam)

    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z_cam > 0)
    uc = jnp.clip(ui, 0, W - 1)
    vc = jnp.clip(vi, 0, H - 1)

    # --- tiled mip atlas: nearest-subsampled (strided) levels.
    # Enough levels that ANY in-bounds footprint fits a tile:
    # span <= max(W,H)-1 and level l covers span < (1<<l)*P, so
    # n_levels = ceil(log2(max(W,H)/P)) + 1 guarantees span>>lvl <= P-1
    # always holds — near-camera blocks included (a fixed 4-level
    # pyramid silently dropped voxels of blocks spanning > 127 px).
    # Nearest keeps every sample a true sensor value (no depth averaging
    # across silhouettes); near blocks just read a sparser pixel subset,
    # which matches their voxel-per-pixel density anyway. Each level is
    # cut into overlapping TPxTP tiles at stride CELL, built from pure
    # reshapes/transposes (no gather), all levels flattened into one
    # [NT, 6, TP*TP] channel-major array fetched by row below (the
    # layout the per-voxel resolve in `integrate` reads).
    img6 = jnp.concatenate(
        [
            depth_img[..., None],
            rgb_img,
            ht_img[..., None],
            lt_img[..., None],
        ],
        axis=-1,
    )  # [H, W, 6]
    n_levels = max(1, (max(H, W) + P - 1) // P - 1).bit_length() + 1
    tile_arrays, tile_off_l, ntx_l, hs_l, ws_l = [], [], [], [], []
    n_tiles = 0
    for l in range(n_levels):
        s = 1 << l
        band = img6[::s, ::s]
        h_l, w_l = band.shape[0], band.shape[1]
        hs_l.append(h_l)
        ws_l.append(w_l)
        nty = (h_l + CELL - 1) // CELL
        ntx = (w_l + CELL - 1) // CELL
        pad = jnp.pad(band, ((0, TP), (0, TP), (0, 0)))
        # tile(ty, tx) = pad[CELL*ty : CELL*ty+TP, CELL*tx : CELL*tx+TP]
        # assembled from a 3x3 grid of CELL-cells via shifted views.
        rows = []
        for cy in range(TP // CELL):
            cols = []
            for cx in range(TP // CELL):
                sub = jax.lax.slice(
                    pad,
                    (CELL * cy, CELL * cx, 0),
                    (CELL * cy + CELL * nty, CELL * cx + CELL * ntx, 6),
                )
                cols.append(sub.reshape(nty, CELL, ntx, CELL, 6))
            rows.append(jnp.concatenate(cols, axis=3))  # [nty,CELL,ntx,TP,6]
        tiles = jnp.concatenate(rows, axis=1)  # [nty, TP, ntx, TP, 6]
        # -> [NT, 6, TPy*TPx] (channel-major, dv*TP+du flattening)
        tiles = tiles.transpose(0, 2, 4, 1, 3).reshape(nty * ntx, 6, TP * TP)
        tile_arrays.append(tiles)
        tile_off_l.append(n_tiles)
        ntx_l.append(ntx)
        n_tiles += nty * ntx
    flat_tiles = jnp.concatenate(tile_arrays, axis=0)  # [NT, 6, 256]
    tile_off = jnp.array(tile_off_l, dtype=jnp.int32)
    ntx_of = jnp.array(ntx_l, dtype=jnp.int32)
    level_h = jnp.array(hs_l, dtype=jnp.int32)
    level_w = jnp.array(ws_l, dtype=jnp.int32)

    # per-block footprint over valid voxels
    big = jnp.int32(1 << 20)
    umin = jnp.min(jnp.where(inb, ui, big), axis=1)
    vmin = jnp.min(jnp.where(inb, vi, big), axis=1)
    umax = jnp.max(jnp.where(inb, ui, -big), axis=1)
    vmax = jnp.max(jnp.where(inb, vi, -big), axis=1)
    any_valid = jnp.any(inb, axis=1)
    umin = jnp.where(any_valid, jnp.maximum(umin, 0), 0)
    vmin = jnp.where(any_valid, jnp.maximum(vmin, 0), 0)
    span = jnp.maximum(umax - umin, vmax - vmin)  # [V]
    lvl = jnp.zeros_like(span)
    for l in range(n_levels - 1):
        lvl = lvl + ((span > (1 << l) * P - 1)).astype(jnp.int32)

    u0 = jnp.clip(umin >> lvl, 0, jnp.maximum(level_w[lvl] - 1, 0))
    v0 = jnp.clip(vmin >> lvl, 0, jnp.maximum(level_h[lvl] - 1, 0))
    tx = u0 >> 3  # CELL = 8
    ty = v0 >> 3
    tid = tile_off[lvl] + ty * ntx_of[lvl] + tx
    patch = flat_tiles[tid]  # [V, 6, 256] — one row gather

    du = (uc >> lvl[:, None]) - (tx << 3)[:, None]  # [V, 512]
    dv = (vc >> lvl[:, None]) - (ty << 3)[:, None]
    in_patch = (du >= 0) & (du < TP) & (dv >= 0) & (dv < TP)
    du = jnp.clip(du, 0, TP - 1)
    dv = jnp.clip(dv, 0, TP - 1)
    idx = dv * TP + du  # [V, 512] flat tile-pixel index

    # depth-to-range scale: ||K^-1 (u, v, 1)|| (reference precomputes
    # img_depth_to_range, voxel_tsdf.cu:134-140). Use the mip-snapped
    # pixel coords so the scale matches the pixel actually sampled.
    us = (uc >> lvl[:, None]) << lvl[:, None]
    vs = (vc >> lvl[:, None]) << lvl[:, None]
    xn = (us.astype(jnp.float32) - cam.cx) / cam.fx
    yn = (vs.astype(jnp.float32) - cam.cy) / cam.fy
    d2r = jnp.sqrt(xn * xn + yn * yn + 1.0)

    gate = (vis_mask[:, None] & inb & in_patch).astype(jnp.float32)
    return patch, idx, z_cam, d2r, gate


def integrate(
    m: VoxelMap,
    vis_idx: jax.Array,
    vis_mask: jax.Array,
    rgb_img: jax.Array,  # [H, W, 3] float32 0..255
    depth_img: jax.Array,  # [H, W] float32 meters
    ht_img: jax.Array,  # [H, W] float32 prob
    lt_img: jax.Array,  # [H, W] float32 prob
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    carve: bool = False,
) -> VoxelMap:
    """Fuse one RGB-D(+semantics) frame into the visible blocks.

    Gather-formulated like the reference `tsdf_integrate_kernel`
    (`voxel_tsdf.cu:170-251`): every voxel of every visible block reads
    its pixel from the block's image tile; no write conflicts by
    construction. The resolve + fusion is `fusion.resolve_fuse` (a
    Pallas kernel on the GPU); the space-carving decision is the
    per-block min |tsdf| of the fused values.

    With `carve=True` the space-carving release (reference
    `space_carving_kernel` + hash `Delete`, `voxel_tsdf.cu:253-276`) is
    fused into the same payload scatter: released rows are written with
    their acquire-time init values instead of the fused update, so
    carving costs one cheap metadata pass instead of a second full
    gather + scatter over the visible set.
    """
    patch, idx, z_cam, d2r, gate = _integrate_prep(
        m, vis_idx, vis_mask, rgb_img, depth_img, ht_img, lt_img,
        cam, cam_T_world, cfg,
    )
    t_out, w_out, p_out, c_out, minabs = resolve_fuse(
        m.tsdf, m.weight, m.prob, m.rgb, vis_idx, patch, idx, z_cam, d2r,
        gate, cfg,
    )

    table = m.table
    block_key = m.block_key
    block_slot = m.block_slot
    active = m.active
    free_stack = m.free_stack
    free_top = m.free_top
    if carve:
        release = vis_mask & (minabs >= cfg.carve_threshold)
        # released rows get their acquire-time init values in the SAME
        # scatter below (voxel_mem.cu:45-52 init: tsdf=-1, w=1, p=0.5)
        t_out = jnp.where(release[:, None], -1.0, t_out)
        w_out = jnp.where(release[:, None], 1.0, w_out)
        c_out = jnp.where(release[:, None, None], 0.0, c_out)
        p_out = jnp.where(release[:, None], 0.5, p_out)
        table = ht_remove(table, m.block_slot[vis_idx], release)
        rel_rows = jnp.where(release, vis_idx, m.num_blocks)
        block_key = block_key.at[rel_rows].set(INVALID_KEY, mode="drop")
        block_slot = block_slot.at[rel_rows].set(-1, mode="drop")
        active = active.at[rel_rows].set(False, mode="drop")
        # push released rows back onto the free stack
        sdest = free_top + jnp.cumsum(release.astype(jnp.int32)) - 1
        free_stack = free_stack.at[
            jnp.where(release, sdest, m.num_blocks)
        ].set(vis_idx, mode="drop")
        free_top = free_top + jnp.sum(release.astype(jnp.int32))

    rows = jnp.where(vis_mask, vis_idx, m.num_blocks)
    return m._replace(
        table=table,
        block_key=block_key,
        block_slot=block_slot,
        active=active,
        free_stack=free_stack,
        free_top=free_top,
        tsdf=m.tsdf.at[rows].set(t_out, mode="drop"),
        weight=m.weight.at[rows].set(w_out, mode="drop"),
        rgb=m.rgb.at[rows].set(c_out, mode="drop"),
        prob=m.prob.at[rows].set(p_out, mode="drop"),
    )


# ---------------------------------------------------------------------------
# Space carving
# ---------------------------------------------------------------------------


def space_carve(
    m: VoxelMap,
    vis_idx: jax.Array,
    vis_mask: jax.Array,
    cfg: TsdfConfig,
) -> VoxelMap:
    """Release visible blocks whose min |tsdf| >= threshold (entirely
    empty space), like `space_carving_kernel` (`voxel_tsdf.cu:253-276`)
    + hash `Delete`.
    """
    min_abs = jnp.min(jnp.abs(m.tsdf[vis_idx]), axis=-1)
    release = vis_mask & (min_abs >= cfg.carve_threshold)

    # Bound the per-frame release batch so the payload re-init scatter
    # below stays small; blocks beyond the cap stay allocated and are
    # carved on a later frame (carving is opportunistic anyway).
    r_cap = min(4096, vis_idx.shape[0])
    rrank = jnp.cumsum(release.astype(jnp.int32)) - 1
    release = release & (rrank < r_cap)
    dest = jnp.where(release, rrank, r_cap)
    rel_rows = jnp.full((r_cap,), m.num_blocks, dtype=jnp.int32).at[dest].set(
        vis_idx, mode="drop"
    )

    table = ht_remove(m.table, m.block_slot[vis_idx], release)
    rows = jnp.where(release, vis_idx, m.num_blocks)
    sdest = m.free_top + jnp.cumsum(release.astype(jnp.int32)) - 1
    return m._replace(
        table=table,
        block_key=m.block_key.at[rows].set(INVALID_KEY, mode="drop"),
        block_slot=m.block_slot.at[rows].set(-1, mode="drop"),
        active=m.active.at[rows].set(False, mode="drop"),
        free_stack=m.free_stack.at[
            jnp.where(release, sdest, m.num_blocks)
        ].set(vis_idx, mode="drop"),
        free_top=m.free_top + jnp.sum(release.astype(jnp.int32)),
        # restore the free-rows-are-initialized invariant (see
        # allocate_keys step 6) for the released rows only
        tsdf=m.tsdf.at[rel_rows].set(-1.0, mode="drop"),
        weight=m.weight.at[rel_rows].set(1.0, mode="drop"),
        rgb=m.rgb.at[rel_rows].set(0.0, mode="drop"),
        prob=m.prob.at[rel_rows].set(0.5, mode="drop"),
    )


# ---------------------------------------------------------------------------
# Per-frame pipeline
# ---------------------------------------------------------------------------


def integrate_frame(
    m: VoxelMap,
    rgb_img: jax.Array,
    depth_img: jax.Array,
    ht_img: jax.Array,
    lt_img: jax.Array,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    alloc_stride: int = 1,
    carve: bool = True,
) -> Tuple[VoxelMap, dict]:
    """allocate -> cull -> integrate -> carve: one fused-map frame
    (the device pipeline of `TSDFGrid::Integrate`, `voxel_tsdf.cu:416-452`).
    Fully jit-able; call under jax.jit with static cfg/stride/carve.
    """
    m = allocate_from_depth(m, depth_img, cam, cam_T_world, cfg, alloc_stride)
    vis_idx, vis_mask, vis_count = visible_blocks(m, cam, cam_T_world, cfg)
    m = integrate(
        m, vis_idx, vis_mask, rgb_img, depth_img, ht_img, lt_img,
        cam, cam_T_world, cfg, carve=carve,
    )
    stats = {
        "num_active": num_active(m),
        "num_visible": vis_count,
        "alloc_failures": m.alloc_failures,
    }
    return m, stats


# ---------------------------------------------------------------------------
# Export (host-side; reference binary layouts kept byte-compatible)
# ---------------------------------------------------------------------------


def gather_valid(m: VoxelMap, cfg: TsdfConfig):
    """All voxels of active blocks as (x, y, z, tsdf) float32 rows
    (reference `GatherValid`, `voxel_tsdf.cu:476-502`). Host-side."""
    import numpy as np

    active = np.asarray(m.active)
    idx = np.nonzero(active)[0]
    coords = np.asarray(unpack_block_coords(m.block_key[idx])) * BLOCK_LEN
    offs = np.asarray(voxel_offsets())
    grid = coords[:, None, :] + offs[None]  # [K, 512, 3]
    pos = grid.astype(np.float32) * cfg.voxel_size
    tsdf = np.asarray(m.tsdf[idx])[..., None]
    return np.concatenate([pos, tsdf], axis=-1).reshape(-1, 4)


def gather_valid_semantic(m: VoxelMap, cfg: TsdfConfig):
    """(x, y, z, tsdf, prob) float32 rows (reference
    `GatherValidSemantic`, `voxel_tsdf.cu:504-530`) — the format consumed
    unchanged by the ScanNet eval harness (`scanneteval.py:148-162`)."""
    import numpy as np

    active = np.asarray(m.active)
    idx = np.nonzero(active)[0]
    coords = np.asarray(unpack_block_coords(m.block_key[idx])) * BLOCK_LEN
    offs = np.asarray(voxel_offsets())
    grid = coords[:, None, :] + offs[None]
    pos = grid.astype(np.float32) * cfg.voxel_size
    tsdf = np.asarray(m.tsdf[idx])[..., None]
    prob = np.asarray(m.prob[idx])[..., None]
    return np.concatenate([pos, tsdf, prob], axis=-1).reshape(-1, 5)


def query_tsdf(m: VoxelMap, cfg: TsdfConfig, lo, hi):
    """Voxels inside the world-space AABB [lo, hi] as (x, y, z, tsdf)
    rows — the planner query `TSDFSystem::Query`/`GatherVoxels`
    (`/root/reference/modules/tsdf_module.cc:38-43`). Host-side."""
    import numpy as np

    rows = gather_valid(m, cfg)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    keep = np.all((rows[:, :3] >= lo) & (rows[:, :3] <= hi), axis=-1)
    return rows[keep]


def dump_semantic_tsdf(m: VoxelMap, cfg: TsdfConfig, path: str) -> int:
    """Write all active voxels as packed (x, y, z, tsdf, prob) float32
    rows — byte-identical to `TSDFSystem::DownloadAll`
    (`/root/reference/modules/tsdf_module.cc:57-64`), the input of the
    ScanNet eval harness. Returns the number of rows written."""
    rows = gather_valid_semantic(m, cfg)
    rows.astype("<f4").tofile(path)
    return len(rows)
