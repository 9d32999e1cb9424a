"""Image pyramid + separable Gaussian blur.

The reference delegates pyramid construction to OpenVSLAM's ORB
extractor (SURVEY.md §2.8: 8 levels, scale factor 1.2,
`/root/reference/configs/TUM_RGBD_rgbd_1.yaml:31-37`). Here each level
is a fixed static shape (ceil division by the scale), built with
`jax.image.resize` — XLA lowers that to dense gathers/convs that run on
the vector units.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp


def gaussian_blur(img: jax.Array, sigma: float = 2.0, radius: int = 3) -> jax.Array:
    """Separable Gaussian blur of a [H, W] float image (reflect padding).

    Used to smooth images before BRIEF sampling (standard ORB practice;
    OpenVSLAM blurs with a 7x7 sigma-2 kernel before describing).
    """
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)
    # Full f32 precision: a default-precision contraction (bf16 passes
    # or TF32) costs ~0.5 intensity levels of noise, which shifts FAST subpixel fits by
    # tenths of a pixel and measurably degrades pose accuracy.
    hi = jax.lax.Precision.HIGHEST
    pad = [(radius, radius), (0, 0)]
    v = jnp.pad(img, pad, mode="reflect")
    v = jax.vmap(
        lambda col: jnp.convolve(col, k, mode="valid", precision=hi),
        in_axes=1, out_axes=1,
    )(v)
    h = jnp.pad(v, [(0, 0), (radius, radius)], mode="reflect")
    h = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid", precision=hi))(h)
    return h


def pyramid_shapes(
    height: int, width: int, num_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    shapes = []
    for lvl in range(num_levels):
        s = scale_factor**lvl
        shapes.append((max(int(round(height / s)), 16), max(int(round(width / s)), 16)))
    return shapes


def build_pyramid(
    img: jax.Array, num_levels: int = 8, scale_factor: float = 1.2
) -> List[jax.Array]:
    """[H, W] float32 grayscale -> list of progressively downscaled levels.

    Level shapes are static (computed from Python ints), so the whole
    pyramid jits into one program.
    """
    H, W = img.shape
    levels = [img]
    for h, w in pyramid_shapes(H, W, num_levels, scale_factor)[1:]:
        levels.append(
            jax.image.resize(
                img, (h, w), method="linear",
                precision=jax.lax.Precision.HIGHEST,
            )
        )
    return levels


def rgb_to_gray(rgb: jax.Array) -> jax.Array:
    """[H, W, 3] (0..255) -> [H, W] float32 grayscale."""
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(jnp.float32)
