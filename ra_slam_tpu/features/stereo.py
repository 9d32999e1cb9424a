"""Stereo keypoint depth from rectified image pairs.

The reference gets stereo depth inside OpenVSLAM's tracker (per-keypoint
epipolar patch matching on rectified pairs; SURVEY.md §2.8). Batched
formulation: gather one left patch and one right epipolar strip per
keypoint in a single batched gather, compute all candidate ZNCC scores
as one [F, D] tensor contraction (no per-ray loops),
take the arg-best with subpixel parabola refinement, and convert
disparity to depth with fx*baseline. All shapes static.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _gather_patches(img: jax.Array, vi: jax.Array, ui: jax.Array, dy, dx):
    """img [H, W]; vi/ui [F]; dy [P]; dx [Q] -> patches [F, P, Q]."""
    H, W = img.shape
    vv = jnp.clip(vi[:, None, None] + dy[None, :, None], 0, H - 1)
    uu = jnp.clip(ui[:, None, None] + dx[None, None, :], 0, W - 1)
    return img[vv, uu]


def stereo_keypoint_depth(
    gray_l: jax.Array,  # [H, W] float32 rectified left
    gray_r: jax.Array,  # [H, W] float32 rectified right
    uv: jax.Array,  # [F, 2] left keypoint pixels
    valid: jax.Array,  # [F] bool
    focal_x_baseline: float,  # fx * baseline (pixel * meters)
    max_disparity: int = 64,
    patch: int = 7,
    min_zncc: float = 0.6,
    min_depth: float = 0.1,
    max_depth: float = 40.0,
    min_texture: float = 2.0,  # mean |horizontal gradient| gate
) -> Tuple[jax.Array, jax.Array]:
    """Per-keypoint depth by epipolar ZNCC matching.

    Returns (depth [F] float32 — 0 where invalid, valid [F] bool).
    """
    H, W = gray_l.shape
    F = uv.shape[0]
    P = patch
    D = max_disparity
    half = P // 2

    ui = jnp.round(uv[:, 0]).astype(jnp.int32)
    vi = jnp.round(uv[:, 1]).astype(jnp.int32)
    dy = jnp.arange(-half, half + 1)
    dx = jnp.arange(-half, half + 1)

    left = _gather_patches(gray_l, vi, ui, dy, dx)  # [F, P, P]
    # right strip covers disparities 0..D-1: u' = u - d
    strip_dx = jnp.arange(-half - (D - 1), half + 1)  # [P + D - 1]
    strip = _gather_patches(gray_r, vi, ui, dy, strip_dx)  # [F, P, P+D-1]

    # candidate windows: strip column of offset (dx - d) is
    # dx - d + half + (D-1); window d covers [D-1-d, D-1-d+P)
    cols = (D - 1) + half + dx[None, :] - jnp.arange(D)[:, None]  # [D, P]
    wins = strip[:, :, cols]  # [F, P, D, P]
    wins = jnp.moveaxis(wins, 2, 1)  # [F, D, P, P]

    # ZNCC over the patch
    lf = left.reshape(F, 1, P * P)
    rf = wins.reshape(F, D, P * P)
    lm = lf - lf.mean(-1, keepdims=True)
    rm = rf - rf.mean(-1, keepdims=True)
    num = jnp.sum(lm * rm, -1)
    den = jnp.sqrt(
        jnp.sum(lm * lm, -1) * jnp.sum(rm * rm, -1) + 1e-9
    )
    zncc = num / den  # [F, D]

    best = jnp.argmax(zncc, axis=-1)  # [F]
    score = jnp.take_along_axis(zncc, best[:, None], -1)[:, 0]

    # subpixel parabola around the best integer disparity
    bm1 = jnp.clip(best - 1, 0, D - 1)
    bp1 = jnp.clip(best + 1, 0, D - 1)
    y0 = jnp.take_along_axis(zncc, bm1[:, None], -1)[:, 0]
    y2 = jnp.take_along_axis(zncc, bp1[:, None], -1)[:, 0]
    denom = y0 - 2 * score + y2
    delta = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (y0 - y2) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    disp = best.astype(jnp.float32) + delta

    depth = focal_x_baseline / jnp.maximum(disp, 1e-3)
    # aperture gate: without horizontal texture every shift matches
    # equally well (zncc stays high on a horizontal-only edge)
    h_grad = jnp.mean(jnp.abs(left[:, :, 1:] - left[:, :, :-1]), axis=(1, 2))
    ok = (
        valid
        & (h_grad >= min_texture)
        & (score >= min_zncc)
        & (best > 0)
        & (best < D - 1)
        & (depth > min_depth)
        & (depth < max_depth)
        # strip must not have been clipped at the image border
        & (ui - (best + half) >= 0)
        & (ui + half < W)
        & (vi - half >= 0)
        & (vi + half < H)
    )
    return jnp.where(ok, depth, 0.0), ok


def sparse_depth_image(
    uv: jax.Array,  # [F, 2]
    depth: jax.Array,  # [F]
    valid: jax.Array,  # [F] bool
    height: int,
    width: int,
) -> jax.Array:
    """Scatter per-keypoint depths into a [H, W] image (0 elsewhere) so
    stereo frames reuse the RGB-D landmark-creation path (depth is only
    read at keypoint pixels, `slam/tracker.py:insert_keyframe_landmarks`)."""
    ui = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, width - 1)
    vi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, height - 1)
    flat = jnp.where(valid, vi * width + ui, height * width)
    img = jnp.zeros((height * width,), jnp.float32)
    img = img.at[flat].set(depth, mode="drop")
    return img.reshape(height, width)


# ---------------------------------------------------------------------------
# Dense stereo depth (the ZED-SDK dense-disparity role)
# ---------------------------------------------------------------------------


def census_transform(img: jax.Array, radius: int = 2) -> jax.Array:
    """[H, W] -> [H, W] uint32 census descriptor: bit k set iff the k-th
    neighbor (in a (2r+1)^2 window, center excluded) is darker than the
    center. Illumination-invariant; the standard real-time stereo
    matching transform."""
    H, W = img.shape
    bits = jnp.zeros((H, W), jnp.uint32)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = jnp.roll(img, (-dy, -dx), axis=(0, 1))
            bits = bits | ((shifted < img).astype(jnp.uint32) << jnp.uint32(k))
            k += 1
    return bits


def dense_stereo_depth(
    gray_l: jax.Array,  # [H, W] float32 rectified left
    gray_r: jax.Array,  # [H, W] float32 rectified right
    focal_x_baseline: float,  # fx * baseline (pixel * meters)
    max_disparity: int = 64,
    block: int = 9,
    census_radius: int = 2,
    min_depth: float = 0.1,
    max_depth: float = 40.0,
    uniqueness: float = 1.1,
) -> Tuple[jax.Array, jax.Array]:
    """Dense disparity -> depth map for a rectified stereo pair.

    The capability the reference buys from the ZED SDK
    (`/root/reference/cameras/zed.h:9-42`: SDK-computed dense depth fed
    to the TSDF from a stereo-only rig). Dense formulation: census
    transform both images, build the full [D, H, W] Hamming cost volume
    with one gather + popcount, box-aggregate it with a single
    `reduce_window` over the volume, then winner-take-all with a
    left-right consistency check, uniqueness ratio, and subpixel
    parabola — all dense vector ops, no per-pixel loops.

    Returns (depth [H, W] float32, valid [H, W] bool); depth is 0 where
    invalid. Subpixel accuracy is the usual ~1/4 px of census WTA +
    parabola (slant bias of box aggregation); good enough for TSDF
    fusion, not for calibration.
    """
    H, W = gray_l.shape
    D = max_disparity
    cl = census_transform(gray_l, census_radius)
    cr = census_transform(gray_r, census_radius)

    u = jnp.arange(W, dtype=jnp.int32)
    d = jnp.arange(D, dtype=jnp.int32)
    # right-image column for (disparity, column): u - d, clamped
    uc = jnp.clip(u[None, :] - d[:, None], 0, W - 1)  # [D, W]
    cr_shift = cr[:, uc]  # [H, D, W]
    cost = jax.lax.population_count(cl[:, None, :] ^ cr_shift).astype(
        jnp.float32
    )  # [H, D, W]
    inb = (u[None, :] - d[:, None]) >= 0  # [D, W]
    big = jnp.float32(1e9)
    cost = jnp.where(inb[None], cost, big)

    # block aggregation over the spatial window (one fused reduce_window)
    agg = jax.lax.reduce_window(
        cost, 0.0, jax.lax.add, (block, 1, block), (1, 1, 1), "SAME"
    )  # [H, D, W]

    best_d = jnp.argmin(agg, axis=1).astype(jnp.int32)  # [H, W]
    ar = jnp.moveaxis(agg, 1, -1)  # [H, W, D]
    c0 = jnp.take_along_axis(ar, best_d[..., None], axis=-1)[..., 0]
    # uniqueness: best must beat the best-outside-±1 by the ratio
    near = jnp.abs(d[None, None, :] - best_d[..., None]) <= 1
    second = jnp.min(jnp.where(near, big, ar), axis=-1)
    uniq_ok = c0 * uniqueness < second

    # left-right consistency: the matched right pixel's best disparity
    # must agree (occlusion rejection, the SDK's LR check)
    aggT = jnp.moveaxis(agg, 1, 0)  # [D, H, W]
    ur = jnp.clip(u[None, :] - best_d, 0, W - 1)
    # right-view cost at (d, v, u_r): cost of left pixel u_r + d vs right u_r
    ul = jnp.clip(u[None, None, :] + d[:, None, None], 0, W - 1)  # [D,1,W]
    v = jnp.arange(H, dtype=jnp.int32)
    right_cost = aggT[d[:, None, None], v[None, :, None], ul]  # [D, H, W]
    best_r = jnp.argmin(right_cost, axis=0).astype(jnp.int32)  # [H, W]
    lr_ok = (
        jnp.abs(jnp.take_along_axis(best_r, ur, axis=1) - best_d) <= 1
    )

    # subpixel parabola on the aggregated cost
    dm = jnp.clip(best_d, 1, D - 2)
    lo = jnp.take_along_axis(ar, (dm - 1)[..., None], -1)[..., 0]
    hi = jnp.take_along_axis(ar, (dm + 1)[..., None], -1)[..., 0]
    cc = jnp.take_along_axis(ar, dm[..., None], -1)[..., 0]
    denom = lo + hi - 2.0 * cc
    off = jnp.where(
        jnp.abs(denom) > 1e-6, 0.5 * (lo - hi) / jnp.maximum(denom, 1e-6), 0.0
    )
    disp = best_d.astype(jnp.float32) + jnp.clip(off, -0.5, 0.5)

    depth = focal_x_baseline / jnp.maximum(disp, 1e-6)
    valid = (
        (best_d > 0)
        & uniq_ok
        & lr_ok
        & (depth > min_depth)
        & (depth < max_depth)
        & (u[None, :] >= D)  # full search range available
    )
    return jnp.where(valid, depth, 0.0), valid
