"""Integrate + carve against an independent per-voxel numpy reference, and
the GPU fusion kernel (Pallas, Triton route) in interpret mode against
the XLA form it replaces on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map import fusion
from ra_slam_tpu.map.blocks import unpack_block_coords, voxel_offsets
from ra_slam_tpu.map.voxel_map import (
    _integrate_prep,
    create_map,
    integrate,
    integrate_frame,
    num_active,
    visible_blocks,
)

H, W = 48, 64
CFG = TsdfConfig(
    voxel_size=0.02, truncation=0.12, max_depth=3.0,
    log2_num_blocks=11, log2_hash_size=13, max_visible_blocks=1024,
    width=W, height=H,
)
# a principal point off the half-pixel grid: voxel projections rarely
# land on a rounding tie
CAM = PinholeCamera.create(40.0, 40.0, 31.37, 23.61, W, H)


def _frame(seed, base_depth):
    """A tilted, rippled wall ~1.5 m away (every block's footprint stays
    under 8 px, so each voxel samples its own rounded pixel) with
    per-pixel colours and semantics."""
    rng = np.random.default_rng(seed)
    vs, us = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = base_depth + 0.004 * us + 0.03 * np.sin(vs / 5.0)
    depth[:4, :6] = 0.0  # dropout: no measurement
    rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    ht = rng.uniform(0.05, 0.95, (H, W)).astype(np.float32)
    return rgb, depth.astype(np.float32), ht, (1.0 - ht).astype(np.float32)


def _reference_step(m, frame, cfg):
    """numpy float64 fusion + carving of every active block, one voxel
    at a time in vector form: the sample is the voxel's own rounded
    pixel (identity pose). Also returns which blocks hold a voxel within
    1e-4 px of a rounding tie, where float32 may round either way."""
    rgb, depth, ht, lt = (np.asarray(x, np.float64) for x in frame)
    active = np.nonzero(np.asarray(m.active))[0]
    coords = np.asarray(unpack_block_coords(m.block_key[active])) * 8
    p = (coords[:, None, :] + np.asarray(voxel_offsets())[None]) * cfg.voxel_size
    z = p[..., 2]
    u = p[..., 0] / z * float(CAM.fx) + float(CAM.cx)
    v = p[..., 1] / z * float(CAM.fy) + float(CAM.cy)
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    tie = lambda x: np.abs(x - np.floor(x) - 0.5) < 1e-4
    ambiguous = np.any(tie(u) | tie(v), axis=1)
    # every footprint fits the integrate's finest tile level
    span = lambda a: np.where(inb, a, -1e9).max(1) - np.where(inb, a, 1e9).min(1)
    assert (np.maximum(span(ui), span(vi))[inb.any(1)] <= 7).all()
    uc, vc = np.clip(ui, 0, W - 1), np.clip(vi, 0, H - 1)
    d = depth[vc, uc]
    d2r = np.sqrt(((uc - float(CAM.cx)) / float(CAM.fx)) ** 2
                  + ((vc - float(CAM.cy)) / float(CAM.fy)) ** 2 + 1.0)
    sdf = d2r * (d - z)
    upd = inb & (d > 1e-6) & (d <= cfg.max_depth) & (sdf > -cfg.truncation)
    w_new = (1.0 - d / cfg.max_depth) * 4.0

    t0 = np.asarray(m.tsdf[active], np.float64)
    w0 = np.asarray(m.weight[active], np.float64)
    p0 = np.asarray(m.prob[active], np.float64)
    c0 = np.asarray(m.rgb[active], np.float64)  # [K, 3, 512]
    wc = w0 + w_new
    t = np.where(upd, (t0 * w0 + np.minimum(1.0, sdf / cfg.truncation) * w_new) / wc, t0)
    w = np.where(upd, np.minimum(wc, cfg.max_weight), w0)
    c_in = np.moveaxis(rgb[vc, uc], -1, 1)  # [K, 3, 512]
    c = np.where(upd[:, None], (c0 * w0[:, None] + c_in * w_new[:, None]) / wc[:, None], c0)
    pc = np.clip(p0, 1e-6, 1 - 1e-6)
    lo = (np.log(pc / (1 - pc)) * w0
          + np.log(np.clip(ht[vc, uc], 1e-6, 1) / np.clip(lt[vc, uc], 1e-6, 1)) * w_new) / wc
    prob = np.where(upd, 1.0 / (1.0 + np.exp(-lo)), p0)
    carve = np.abs(t).min(axis=1) >= cfg.carve_threshold
    return active, t, w, c, prob, carve, ambiguous


def test_integrate_and_carve_match_numpy_reference():
    f1, f2 = _frame(0, 1.5), _frame(1, 1.53)
    step = jax.jit(functools.partial(integrate_frame, cfg=CFG))
    m, _ = step(create_map(CFG), *map(jnp.asarray, f1), CAM, SE3.identity())
    # every 3rd block as if long observed empty (|tsdf| = 1 at high
    # weight): one more frame cannot pull it below the carve threshold
    empty = np.nonzero(np.asarray(m.active))[0][::3]
    m = m._replace(tsdf=m.tsdf.at[empty].set(1.0), weight=m.weight.at[empty].set(30.0))
    # the second frame sees far behind the surface on the left third
    f2[1][:, : W // 3] = 2.5
    vis_idx, vis_mask, count = visible_blocks(m, CAM, SE3.identity(), CFG)
    assert int(count) == int(num_active(m)) <= CFG.max_visible_blocks

    out = jax.jit(functools.partial(integrate, cfg=CFG, carve=True))(
        m, vis_idx, vis_mask, *map(jnp.asarray, f2), CAM, SE3.identity()
    )
    rows, t, w, c, p, carve, ambiguous = _reference_step(m, f2, CFG)
    assert ambiguous.mean() < 0.02
    sure = ~ambiguous
    kept, gone = rows[sure & ~carve], rows[sure & carve]
    assert len(gone) > 0 and len(kept) > len(gone)

    np.testing.assert_array_equal(np.asarray(out.active)[gone], False)
    np.testing.assert_array_equal(np.asarray(out.active)[kept], True)
    np.testing.assert_array_equal(np.asarray(out.tsdf)[gone], -1.0)
    np.testing.assert_array_equal(np.asarray(out.prob)[gone], 0.5)
    np.testing.assert_array_equal(np.asarray(out.rgb)[gone], 0.0)
    released = int(np.sum(np.asarray(m.active) & ~np.asarray(out.active)))
    assert int(out.free_top) == int(m.free_top) + released
    k = sure & ~carve
    np.testing.assert_allclose(np.asarray(out.tsdf)[kept], t[k], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.weight)[kept], w[k], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.prob)[kept], p[k], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.rgb)[kept], c[k], atol=1e-3)


def test_fusion_kernel_interpret_matches_xla_form():
    f = _frame(2, 1.5)
    step = jax.jit(functools.partial(integrate_frame, cfg=CFG))
    m, _ = step(create_map(CFG), *map(jnp.asarray, f), CAM, SE3.identity())
    f2 = _frame(3, 1.52)
    pose = SE3.identity()._replace(t=jnp.asarray([0.03, -0.02, 0.0], jnp.float32))
    vis_idx, vis_mask, _ = visible_blocks(m, CAM, pose, CFG)
    prep = _integrate_prep(m, vis_idx, vis_mask, *map(jnp.asarray, f2), CAM, pose, CFG)
    args = (m.tsdf, m.weight, m.prob, m.rgb, vis_idx) + tuple(prep)
    ref = jax.jit(functools.partial(fusion._resolve_fuse_xla, cfg=CFG))(*args)
    out = jax.jit(functools.partial(
        fusion._resolve_fuse_triton, cfg=CFG, interpret=True))(*args)
    # same float32 rule; XLA may contract the two forms' multiply-adds
    # differently, so allow a few ulps
    for name, r, o in zip(("tsdf", "weight", "prob", "rgb", "min|tsdf|"), ref, out):
        assert r.shape == o.shape, name
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_resolve_fuse_takes_the_xla_form_off_gpu():
    """On the CPU the platform switch lowers the XLA form (the Triton
    kernel has no CPU lowering, so compiling it here would fail)."""
    f = _frame(4, 1.5)
    m, _ = jax.jit(functools.partial(integrate_frame, cfg=CFG))(
        create_map(CFG), *map(jnp.asarray, f), CAM, SE3.identity()
    )
    vis_idx, vis_mask, _ = visible_blocks(m, CAM, SE3.identity(), CFG)
    prep = _integrate_prep(m, vis_idx, vis_mask, *map(jnp.asarray, f), CAM,
                           SE3.identity(), CFG)
    args = (m.tsdf, m.weight, m.prob, m.rgb, vis_idx) + tuple(prep)
    hlo = jax.jit(functools.partial(fusion.resolve_fuse, cfg=CFG)).lower(*args).as_text()
    assert "tsdf_fuse" not in hlo
    out = jax.jit(functools.partial(fusion.resolve_fuse, cfg=CFG))(*args)
    ref = jax.jit(functools.partial(fusion._resolve_fuse_xla, cfg=CFG))(*args)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))


@pytest.mark.gpu
def test_fusion_kernel_compiled_on_gpu(gpu_device):
    """The compiled kernel against the XLA form on the same card (also
    phase (b) of chip_smoke.py, at the bench's shapes)."""
    f = _frame(5, 1.5)
    with jax.default_device(gpu_device):
        m, _ = jax.jit(functools.partial(integrate_frame, cfg=CFG))(
            create_map(CFG), *map(jnp.asarray, f), CAM, SE3.identity()
        )
        vis_idx, vis_mask, _ = visible_blocks(m, CAM, SE3.identity(), CFG)
        prep = _integrate_prep(m, vis_idx, vis_mask, *map(jnp.asarray, f), CAM,
                               SE3.identity(), CFG)
        args = (m.tsdf, m.weight, m.prob, m.rgb, vis_idx) + tuple(prep)
        ref = jax.jit(functools.partial(fusion._resolve_fuse_xla, cfg=CFG))(*args)
        out = jax.jit(functools.partial(fusion._resolve_fuse_triton, cfg=CFG))(*args)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))
