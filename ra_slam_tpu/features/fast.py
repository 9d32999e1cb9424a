"""FAST-9/16 corner detection, fully vectorized.

The reference consumes OpenVSLAM's per-cell FAST with a two-threshold
fallback (SURVEY.md §2.8: ini 20 / min 7). GPU FAST walks the 16-pixel
Bresenham circle per thread with early exits; here we instead build 16
*shifted copies* of the whole image and evaluate every pixel's circle
simultaneously — dense vector ops, no divergence, one pass.

Segment test: a corner needs >= 9 *contiguous* circle pixels all
brighter (or all darker) than center +- t. Contiguity over a circular
window is a rolling AND of 9 rotations of the 16-lane mask.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (the standard FAST-16 ring, clockwise).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9
BORDER = 3


def _ring_stack(img: jax.Array) -> jax.Array:
    """[16, H, W]: circle pixel k of every center (zero-padded borders)."""
    rings = []
    for dx, dy in _CIRCLE:
        rings.append(jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)))
    return jnp.stack(rings, axis=0)


def fast_score(img: jax.Array, threshold: float) -> jax.Array:
    """[H, W] corner score: 0 for non-corners, else the sum-of-absolute
    -differences-beyond-threshold strength (OpenCV-style V score)."""
    H, W = img.shape
    ring = _ring_stack(img)  # [16, H, W]
    center = img[None]
    bright = ring > center + threshold
    dark = ring < center - threshold

    def has_arc(mask):
        run = mask
        for k in range(1, ARC):
            run = run & jnp.roll(mask, -k, axis=0)
        return jnp.any(run, axis=0)

    is_corner = has_arc(bright) | has_arc(dark)

    db = jnp.where(bright, ring - center - threshold, 0.0)
    dd = jnp.where(dark, center - threshold - ring, 0.0)
    score = jnp.maximum(jnp.sum(db, axis=0), jnp.sum(dd, axis=0))

    # zero the 3-pixel border (circle would wrap)
    u = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    inb = (u >= BORDER) & (u < W - BORDER) & (v >= BORDER) & (v < H - BORDER)
    return jnp.where(is_corner & inb, score, 0.0)


def _nms3(score: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression (keep strict local maxima)."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def _cell_select(s: jax.Array, max_corners: int, cell: int) -> Tuple[jax.Array, jax.Array]:
    """Spatially-binned candidate selection: per-cell top-k, then global
    top-k over the per-cell survivors. Caps how many keypoints one
    textured region can claim (the reference's per-cell search +
    quadtree distribution, SURVEY.md §2.8) while staying a pair of
    static top_k ops. Returns (vals [K], flat_idx [K])."""
    H, W = s.shape
    Hp = ((H + cell - 1) // cell) * cell
    Wp = ((W + cell - 1) // cell) * cell
    sp = jnp.zeros((Hp, Wp), s.dtype).at[:H, :W].set(s)
    gy, gx = Hp // cell, Wp // cell
    ncells = gy * gx
    # [gy, cell, gx, cell] -> [ncells, cell*cell]
    cells = sp.reshape(gy, cell, gx, cell).transpose(0, 2, 1, 3).reshape(
        ncells, cell * cell
    )
    k_cell = min(max(4 * max_corners // max(ncells, 1), 1), cell * cell)
    cv, ci = jax.lax.top_k(cells, k_cell)  # [ncells, k_cell]
    # cell-local index -> padded-image flat index -> original flat index
    cy = jnp.arange(ncells, dtype=jnp.int32)[:, None] // gx
    cx = jnp.arange(ncells, dtype=jnp.int32)[:, None] % gx
    py = cy * cell + ci // cell
    px = cx * cell + ci % cell
    inb = (py < H) & (px < W)
    flat = jnp.where(inb, py * W + px, 0)
    cv = jnp.where(inb, cv, 0.0)
    # rank-major selection: the best corner of EVERY cell outranks any
    # cell's second-best, so dense texture cannot crowd out sparse cells
    # (per-cell quota guarantee); score breaks ties within a rank.
    rank = jnp.broadcast_to(
        jnp.arange(k_cell, dtype=jnp.float32)[None], cv.shape
    )
    key = jnp.where(cv > 0.0, cv - rank * 1e7, -jnp.inf)
    keyvals, order = jax.lax.top_k(key.reshape(-1), max_corners)
    vals = jnp.where(
        jnp.isfinite(keyvals), cv.reshape(-1)[order], 0.0
    )
    return vals, flat.reshape(-1)[order]


def fast_corners(
    img: jax.Array,
    threshold: float,
    max_corners: int,
    min_threshold: float = 0.0,
    cell_size: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Detect up to `max_corners` FAST corners on one image.

    Returns (uv [K, 2] float32, score [K], valid [K] bool) — fixed K.
    With `min_threshold` > 0, cells (of `cell_size`, or the whole image)
    that yield no corner at `threshold` fall back to the lower threshold
    — OpenVSLAM's ini 20 / min 7 two-threshold semantics (SURVEY.md
    §2.8), evaluated as two dense passes + a per-cell select instead of
    per-cell control flow. With `cell_size` > 0, selection is spatially
    binned (per-cell top-k) to avoid keypoint clumping.
    """
    H, W = img.shape
    raw = fast_score(img, threshold)
    if min_threshold > 0.0 and min_threshold < threshold:
        raw_min = fast_score(img, min_threshold)
        cell = cell_size if cell_size > 0 else max(H, W)
        # per-cell "any ini-threshold corner?" via max-pool over the cell
        has_ini = jax.lax.reduce_window(
            raw, 0.0, jax.lax.max,
            (cell, cell), (cell, cell), "SAME",
        )  # [ceil(H/c), ceil(W/c)]
        has_ini = jnp.repeat(
            jnp.repeat(has_ini > 0.0, cell, axis=0), cell, axis=1
        )[:H, :W]
        raw = jnp.where(has_ini, raw, raw_min)
    s = _nms3(raw)
    if cell_size > 0:
        vals, idx = _cell_select(s, max_corners, cell_size)
    else:
        vals, idx = jax.lax.top_k(s.reshape(-1), max_corners)
    ui = (idx % W).astype(jnp.int32)
    vi = (idx // W).astype(jnp.int32)
    valid = vals > 0.0

    # Subpixel localization: 1-D parabola fits on the raw corner score in
    # u and v. Integer-pixel corners cost ~0.5 px of reprojection noise
    # (= centimeters of pose error at SLAM working depths); the fit
    # recovers most of it for free.
    uc = jnp.clip(ui, 1, W - 2)
    vc = jnp.clip(vi, 1, H - 2)
    c = raw[vc, uc]
    left, right = raw[vc, uc - 1], raw[vc, uc + 1]
    up, down = raw[vc - 1, uc], raw[vc + 1, uc]
    du = _parabola_offset(left, c, right)
    dv = _parabola_offset(up, c, down)
    u = ui.astype(jnp.float32) + jnp.where(valid, du, 0.0)
    v = vi.astype(jnp.float32) + jnp.where(valid, dv, 0.0)
    return jnp.stack([u, v], axis=-1), vals, valid


def _parabola_offset(lo: jax.Array, c: jax.Array, hi: jax.Array) -> jax.Array:
    """Vertex offset in [-0.5, 0.5] of the parabola through (-1,lo),(0,c),(1,hi)."""
    denom = 2.0 * c - lo - hi
    off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (hi - lo) / jnp.maximum(denom, 1e-6), 0.0)
    return jnp.clip(off, -0.5, 0.5)
