"""Raycast rendering of the TSDF map.

Capability parity with the reference's `ray_cast_kernel`
(`/root/reference/utils/tsdf/voxel_tsdf.cu:278-374`): depth, shaded
RGBA with a semantic red-alpha overlay, and surface normals from a
virtual camera.

Redesign — **splatting, not marching**. The reference sphere-marches
every ray with an adaptive step and per-step hash lookups; rays are
independent so a GPU warp tolerates the divergence. Expressed in XLA,
the long data-dependent loop is a problem: a 640x480 render costs 200
serial steps x 3 gathers over 307k rays and minutes of XLA compile for
the unrolled lookup chain. (A plain per-ray march has not been
measured against this design on a GPU.)

Here the data flow is inverted into dense, batched ops — the same move
as the integrate kernel (map/voxel_map.py): instead of rays *searching*
for the surface, every voxel of every frustum-visible block *reports*
where it is:

  1. frustum-cull + compact active blocks (cumsum-scatter, shared with
     the integrate path), then a **shell prefilter** keeps only blocks
     holding any renderable voxel (|tsdf| < shell and enough weight) —
     measured ~70% of visible blocks are interior/unobserved and
     contribute no splat, so every downstream stage shrinks 3-4x;
  2. project the surviving [V2, 512] voxel centers into the camera —
     one dense matmul + elementwise pass (payloads arrive by fast
     whole-block row gathers, never element gathers);
  3. every near-surface voxel splats a *TSDF-corrected* depth: the
     range-scaled SDF stored by the integrator localizes the zero
     crossing along the ray, so z_surf = z_voxel + tsdf * trunc/d2r.
     Every splat in the 2x-truncation shell lands on the surface
     itself — sub-voxel accuracy without the reference's trilinear
     refinement loop;
  4. the z-buffer is a **device sort, not a scatter-min**: one
     `lax.sort` over (pixel, depth, packed-attr) ranks every splat
     behind its pixel's nearest (measured 2.7 ms for 1M splats vs
     ~28 ms for the scatter-min + packed attr scatter-max cascade it
     replaces); the first run element per pixel is the winner and
     carries its own attributes, so depth AND color resolve from the
     same sort with two cheap unique-index scatters (~1.8 ms each).
     Nothing is dropped — there is no per-block splat budget to
     overflow (the round-3 one-hot compaction dropped half the splats
     of dense blocks at K=128);
  5. normals come from central differences of the *depth image*
     (screen-space), replacing the reference's 6 extra trilinear
     map lookups per hit with shifted dense slices.

Outputs match the reference renderer: RGBA image (shaded color +
semantic overlay), normal image, depth map, hit mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map.blocks import BLOCK_LEN, unpack_block_coords, voxel_offsets
from ra_slam_tpu.map.voxel_map import VoxelMap, visible_blocks


def _screen_space_normals(
    depth: jax.Array, hit: jax.Array, cam: PinholeCamera
) -> jax.Array:
    """Camera-frame normals from the depth image: central
    differences of back-projected points (replaces the reference's
    6-lookup central-difference TSDF gradient, voxel_tsdf.cu:334-345).
    Returns [H, W, 3] camera-frame unit normals (0 where invalid)."""
    H, W = depth.shape
    u = jnp.arange(W, dtype=jnp.float32)[None, :]
    v = jnp.arange(H, dtype=jnp.float32)[:, None]
    X = (u - cam.cx) / cam.fx * depth
    Y = (v - cam.cy) / cam.fy * depth
    P = jnp.stack([X, Y, depth], axis=-1)  # [H, W, 3]

    def shift(a, du, dv):
        return jnp.roll(a, shift=(-dv, -du), axis=(0, 1))

    ok = hit
    okr, okl = shift(ok, 1, 0), shift(ok, -1, 0)
    okd, oku = shift(ok, 0, 1), shift(ok, 0, -1)
    dPdu = shift(P, 1, 0) - shift(P, -1, 0)
    dPdv = shift(P, 0, 1) - shift(P, 0, -1)
    n = jnp.cross(dPdv, dPdu)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(nn, 1e-9)
    # orient toward the camera (reference flips by ray direction too)
    flip = jnp.sum(n * P, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    valid = (ok & okr & okl & okd & oku)[..., None]
    return jnp.where(valid, n, 0.0)


def raycast(
    m: VoxelMap,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    shell: float = 0.5,
    splats_per_block: int | None = None,
    max_shell_blocks: int | None = None,
) -> dict:
    """Render the map from a virtual camera by TSDF splatting.

    Returns dict with 'depth' [H,W] (z-depth, 0 = miss), 'rgba' [H,W,4]
    (uint8-range float, shaded + semantic overlay), 'normal' [H,W,3]
    (camera-frame), 'hit' [H,W] bool.

    `splats_per_block` is accepted for back-compat and ignored: the
    sort-based z-buffer has no per-block splat budget. The only
    capacity is `max_shell_blocks` (default: half of
    cfg.max_visible_blocks), the number of *blocks* that may carry
    shell voxels at once; overflow is counted in 'dropped_splats'
    (conservatively 512 per dropped block, 0 in healthy renders).

    `shell` sensitivity, measured on the bench map (60-pose orbit sweep
    on the real chip, round 5): fps and depth accuracy are FLAT across
    the band (42.9/43.1/43.1 f/s and 2.61/2.60/2.62 mm MAE at
    0.3/0.5/0.7 — the sort/scatter cost scales with the static
    max_shell_blocks cap, not band occupancy), while pixel coverage
    rises with the band (hit rate 0.80/0.92/0.95). Widening the band is
    free until shell blocks overflow the cap.
    """
    del splats_per_block  # no per-block budget in the sort design
    H, W = cam.height, cam.width
    n_pix = H * W
    if max_shell_blocks is None:
        max_shell_blocks = getattr(cfg, "max_shell_blocks", 0)

    vis_idx, vis_mask, _count = visible_blocks(m, cam, cam_T_world, cfg)

    # --- shell prefilter + block compaction ------------------------------
    tsdf_vis = m.tsdf[vis_idx]  # [V, 512] fast row gathers
    w_vis = m.weight[vis_idx]
    shell_voxel = (jnp.abs(tsdf_vis) < shell) & (
        w_vis >= cfg.raycast_min_weight
    )
    has = vis_mask & jnp.any(shell_voxel, axis=1)  # [V]
    n_has = jnp.sum(has.astype(jnp.int32))
    V2 = max_shell_blocks or max(1, cfg.max_visible_blocks // 2)
    rank = jnp.cumsum(has.astype(jnp.int32)) - 1
    dest = jnp.where(has & (rank < V2), rank, V2)
    sel = jnp.full((V2,), -1, jnp.int32).at[dest].set(vis_idx, mode="drop")
    # vis-row (not pool-row) selection so the [V,512] gathers above are
    # reused instead of re-gathered from the pool
    vrow = jnp.full((V2,), 0, jnp.int32).at[dest].set(
        jnp.arange(vis_idx.shape[0], dtype=jnp.int32), mode="drop"
    )
    bmask = sel >= 0
    selc = jnp.maximum(sel, 0)
    dropped = jnp.maximum(n_has - V2, 0) * 512

    tsdf = tsdf_vis[vrow]  # [V2, 512]
    weight = w_vis[vrow]
    rgb = m.rgb[selc]  # [V2, 3, 512] channel-major
    prob = m.prob[selc]

    # --- project voxel centers of shell blocks --------------------------
    base = unpack_block_coords(m.block_key[selc])  # [V2, 3]
    offs = voxel_offsets()  # [512, 3]
    pts = (
        base[:, None, :].astype(jnp.float32) * BLOCK_LEN
        + offs[None].astype(jnp.float32)
        + 0.5
    ) * cfg.voxel_size
    q = cam_T_world.apply(pts)  # [V2, 512, 3] camera frame
    uv, z = cam.project(q)
    r = jnp.linalg.norm(q, axis=-1)
    d2r = r / jnp.maximum(z, 1e-9)  # range per unit depth

    # TSDF-corrected surface depth along this pixel's ray
    z_surf = z + tsdf * cfg.truncation / d2r

    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    valid = (
        bmask[:, None]
        & (weight >= cfg.raycast_min_weight)
        & (jnp.abs(tsdf) < shell)
        & (z > 0.0)
        & (z_surf > cfg.min_depth)
        & (z_surf <= cfg.max_depth)
        & (ui >= 0)
        & (ui < W)
        & (vi >= 0)
        & (vi < H)
    )

    # --- sort-based z-buffer ---------------------------------------------
    pix = jnp.where(valid, vi * W + jnp.clip(ui, 0, W - 1), n_pix).reshape(-1)
    z_flat = jnp.where(valid, z_surf, jnp.inf).reshape(-1)

    # ONE uint32 sort key instead of a two-key (pixel, depth) sort: the
    # pixel id in the top bits (VGA needs 19; a capacity assert guards
    # larger sensors) and the depth quantized to 13 bits over
    # [min_depth, max_depth] below it. The winner per pixel is then the
    # minimum key; its EXACT f32 depth and attributes ride along as
    # sort values, so quantization only affects which of two splats
    # closer than (max-min)/8192 (~0.7 mm at the 6 m default) wins the
    # pixel — below splat noise. Measured: the two-key sort was ~35% of
    # the whole render at VGA.
    ZBITS = 13
    assert n_pix << ZBITS <= (1 << 32) - (1 << ZBITS), (
        "pixel+depth sort key overflows 32 bits; lower resolution"
    )
    zq = jnp.clip(
        ((z_flat - cfg.min_depth)
         * ((1 << ZBITS) - 1) / (cfg.max_depth - cfg.min_depth)),
        0, (1 << ZBITS) - 1,
    ).astype(jnp.uint32)
    key = (pix.astype(jnp.uint32) << ZBITS) | jnp.where(
        jnp.isfinite(z_flat), zq, (1 << ZBITS) - 1
    )

    def q8(a):
        return jnp.clip(a, 0, 255).astype(jnp.uint32)

    # channel packing as a weighted sublane reduction over the
    # channel-major [V2, 3, 512] rgb rows (mid-axis lane slices like
    # rgb[:, 0, :] relayout per channel — measured 2.4x whole-render
    # cost after the rgb layout change)
    mult = jnp.asarray([1 << 24, 1 << 16, 1 << 8], jnp.uint32)[None, :, None]
    attr = (
        jnp.sum(q8(rgb) * mult, axis=1, dtype=jnp.uint32)
        | q8(prob * 255.0)
    ).reshape(-1)

    key_s, z_s, attr_s = jax.lax.sort((key, z_flat, attr), num_keys=1)
    pix_s = (key_s >> ZBITS).astype(jnp.int32)
    first = (
        jnp.concatenate([jnp.array([True]), pix_s[1:] != pix_s[:-1]])
        & (pix_s < n_pix)
    )
    widx = jnp.where(first, pix_s, n_pix)
    depth_min = (
        jnp.full((n_pix,), jnp.inf, jnp.float32)
        .at[widx]
        .set(z_s, mode="drop", unique_indices=True)
    )
    attr_img = (
        jnp.zeros((n_pix,), jnp.uint32)
        .at[widx]
        .set(attr_s, mode="drop", unique_indices=True)
    )
    hit = jnp.isfinite(depth_min)
    depth = jnp.where(hit, depth_min, 0.0)

    red = ((attr_img >> jnp.uint32(24)) & jnp.uint32(0xFF)).astype(jnp.float32)
    green = ((attr_img >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.float32)
    blue = ((attr_img >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32)
    pr = (attr_img & jnp.uint32(0xFF)).astype(jnp.float32) / 255.0

    depth_img = depth.reshape(H, W)
    hit_img = hit.reshape(H, W)
    normal = _screen_space_normals(depth_img, hit_img, cam)

    # diffuse shading + semantic red-alpha overlay (voxel_tsdf.cu:346-360)
    u = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    v = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    dirs = jnp.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, jnp.ones((H, W))],
        axis=-1,
    )
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    diffuse = jnp.abs(jnp.sum(normal * dirs, axis=-1))
    # flat fallback where normals are unavailable (isolated splats)
    diffuse = jnp.where(hit_img & (diffuse == 0), 1.0, diffuse)

    color = jnp.stack(
        [red.reshape(H, W), green.reshape(H, W), blue.reshape(H, W)], axis=-1
    )
    shaded = color * diffuse[..., None]
    alpha = jnp.clip((pr.reshape(H, W) - 0.5) * 2.0, 0.0, 1.0)[..., None]
    red_col = jnp.array([255.0, 0.0, 0.0])
    overlaid = shaded * (1 - alpha) + red_col * alpha

    hitf = hit_img.astype(jnp.float32)[..., None]
    rgba = jnp.concatenate([overlaid * hitf, hitf * 255.0], axis=-1)

    return {
        "depth": depth_img,
        "rgba": rgba,
        "normal": normal * hitf,
        "hit": hit_img,
        # shell blocks beyond max_shell_blocks (x512, conservative);
        # 0 in healthy renders — nonzero means whole blocks went
        # unrendered, raise max_shell_blocks
        "dropped_splats": dropped,
    }
