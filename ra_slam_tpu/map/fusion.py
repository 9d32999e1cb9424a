"""Per-voxel sample resolve + fusion over the visible blocks.

One fusion rule, `fuse_voxels` (the reference's `tsdf_integrate_kernel`
math, its `utils/tsdf/voxel_tsdf.cu:170-251`), fed one of
two ways, chosen by the platform the step is compiled for:

  - GPU: `_resolve_fuse_triton`, a Pallas kernel (Triton route) with
    one program per visible block, like the reference's one thread
    block per voxel block. It reads the block's image tile, index row
    and old pool rows, gathers each voxel's sample in registers, fuses
    in float32 and writes the new rows plus the block's min |tsdf|
    (the carving decision). On an H100 (400 W limit) at the bench
    shapes it fuses a frame in 1.54 ms against 1.64 ms for the XLA
    form below, with bit-identical maps.
  - any other platform: `_resolve_fuse_xla`, the same rule on a
    `take_along_axis` gather — also the reference the kernel is tested
    against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ra_slam_tpu.core.config import TsdfConfig

BLOCK_VOLUME = 512
TILE_PIX = 256  # 16 x 16 mip tile, flattened (dv * 16 + du)


def fuse_voxels(
    d, ht, lt, c_in, z_cam, d2r, gate, t_old, w_old, p_old, c_old,
    truncation: float, max_depth: float, max_weight: float,
):
    """Range-scaled SDF, weighted running averages for tsdf and colour
    (weight `(1 - d/max_depth) * 4`, clamped), and Bayesian semantic
    fusion, on resolved samples. Every argument is [..., 512] except the
    colour channels `c_in` and `c_old`, sequences of three such arrays.
    Returns (t, w, p, c) with c a tuple of three channels."""
    sdf = d2r * (d - z_cam)
    update = (gate > 0) & (d > 1e-6) & (d <= max_depth) & (sdf > -truncation)
    tsdf_obs = jnp.minimum(1.0, sdf / truncation)
    w_new = (1.0 - d / max_depth) * 4.0

    w_comb = w_old + w_new
    inv_w = 1.0 / jnp.maximum(w_comb, 1e-9)
    t_new = (t_old * w_old + tsdf_obs * w_new) * inv_w
    w_upd = jnp.minimum(w_comb, max_weight)

    # Bayesian semantic fusion in log-odds space (equivalent to the
    # reference's weighted geometric mean of pos/neg evidence,
    # voxel_tsdf.cu:241-248, but without exp/log cancellation issues).
    p_c = jnp.clip(p_old, 1e-6, 1.0 - 1e-6)
    lo_old = jnp.log(p_c) - jnp.log1p(-p_c)
    lo_obs = jnp.log(jnp.clip(ht, 1e-6, 1.0)) - jnp.log(jnp.clip(lt, 1e-6, 1.0))
    lo_new = (lo_old * w_old + lo_obs * w_new) * inv_w
    p_new = jax.nn.sigmoid(lo_new)

    c = tuple(
        jnp.where(update, (co * w_old + ci * w_new) * inv_w, co)
        for ci, co in zip(c_in, c_old)
    )
    return (
        jnp.where(update, t_new, t_old),
        jnp.where(update, w_upd, w_old),
        jnp.where(update, p_new, p_old),
        c,
    )


def _resolve_fuse_xla(tsdf, weight, prob, rgb, vis_idx, patch, idx,
                      z_cam, d2r, gate, cfg: TsdfConfig):
    vals = jnp.take_along_axis(patch, idx[:, None, :], axis=2)  # [V, 6, 512]
    rgb_old = rgb[vis_idx]  # [V, 3, 512] channel-major
    t, w, p, c = fuse_voxels(
        vals[:, 0], vals[:, 4], vals[:, 5], [vals[:, 1 + k] for k in range(3)],
        z_cam, d2r, gate, tsdf[vis_idx], weight[vis_idx], prob[vis_idx],
        [rgb_old[:, k] for k in range(3)],
        cfg.truncation, cfg.max_depth, cfg.max_weight,
    )
    return t, w, p, jnp.stack(c, axis=1), jnp.min(jnp.abs(t), axis=-1)


def _fuse_kernel(vis_ref, patch_ref, idx_ref, z_ref, d2r_ref, gate_ref,
                 tsdf_ref, w_ref, p_ref, rgb_ref,
                 t_out, w_out, p_out, c_out, min_out, *, fuse):
    """One visible block: its tile [1, 6, 256], index/geometry rows
    [1, 512], and the whole pool, read at row `vis_ref[0]`."""
    row = vis_ref[0]
    idx = idx_ref[0, :]
    lane = jnp.arange(BLOCK_VOLUME)
    sample = lambda ch: plgpu.load(patch_ref.at[0, ch, idx])  # in-tile gather
    c_old = [plgpu.load(rgb_ref.at[row, ch, lane]) for ch in range(3)]
    t, w, p, c = fuse(
        sample(0), sample(4), sample(5), [sample(1 + ch) for ch in range(3)],
        z_ref[0, :], d2r_ref[0, :], gate_ref[0, :],
        plgpu.load(tsdf_ref.at[row, lane]), plgpu.load(w_ref.at[row, lane]),
        plgpu.load(p_ref.at[row, lane]), c_old,
    )
    t_out[0, :] = t
    w_out[0, :] = w
    p_out[0, :] = p
    for ch in range(3):
        plgpu.store(c_out.at[0, ch, lane], c[ch])
    min_out[0] = jnp.min(jnp.abs(t))


def _resolve_fuse_triton(tsdf, weight, prob, rgb, vis_idx, patch, idx,
                         z_cam, d2r, gate, cfg: TsdfConfig, interpret=False):
    V, N = idx.shape[0], tsdf.shape[0]
    kernel = functools.partial(_fuse_kernel, fuse=functools.partial(
        fuse_voxels, truncation=cfg.truncation, max_depth=cfg.max_depth,
        max_weight=cfg.max_weight,
    ))
    per_block = lambda *shape: pl.BlockSpec(
        shape, lambda i: (i,) + (0,) * (len(shape) - 1)
    )
    whole = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    row = jax.ShapeDtypeStruct((V, BLOCK_VOLUME), jnp.float32)
    t, w, p, c, minabs = pl.pallas_call(
        kernel,
        grid=(V,),
        in_specs=[
            per_block(1), per_block(1, 6, TILE_PIX),
            per_block(1, BLOCK_VOLUME), per_block(1, BLOCK_VOLUME),
            per_block(1, BLOCK_VOLUME), per_block(1, BLOCK_VOLUME),
            whole(N, BLOCK_VOLUME), whole(N, BLOCK_VOLUME),
            whole(N, BLOCK_VOLUME), whole(N, 3, BLOCK_VOLUME),
        ],
        out_specs=[
            per_block(1, BLOCK_VOLUME), per_block(1, BLOCK_VOLUME),
            per_block(1, BLOCK_VOLUME), per_block(1, 3, BLOCK_VOLUME),
            per_block(1),
        ],
        out_shape=[row, row, row,
                   jax.ShapeDtypeStruct((V, 3, BLOCK_VOLUME), jnp.float32),
                   jax.ShapeDtypeStruct((V,), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="tsdf_fuse",
    )(vis_idx, patch, idx, z_cam, d2r, gate, tsdf, weight, prob, rgb)
    return t, w, p, c, minabs


def resolve_fuse(tsdf, weight, prob, rgb, vis_idx, patch, idx,
                 z_cam, d2r, gate, cfg: TsdfConfig):
    """Fused rows of the visible blocks: (t, w, p [V, 512], rgb
    [V, 3, 512], min |t| [V]), from the pool payload, the visible row
    ids, and `voxel_map._integrate_prep`'s tiles and per-voxel
    geometry."""
    args = (tsdf, weight, prob, rgb, vis_idx, patch, idx, z_cam, d2r, gate)
    return jax.lax.platform_dependent(
        *args,
        cuda=functools.partial(_resolve_fuse_triton, cfg=cfg),
        default=functools.partial(_resolve_fuse_xla, cfg=cfg),
    )
