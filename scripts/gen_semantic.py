"""Train the segmentation UNet on the synthetic labeled scene and score
it — 2D and through the full fusion pipeline.

Random weights make IoU meaningless, and the reference evaluates
semantic maps against GT (its
`python_utils/scannet_eval/scanneteval.py:94-146`).
The synthetic box room has exact semantic ground truth (the +x wall and
a subset of clutter boxes are high-touch — `io/synthetic.py:25-29`), so:

  1. train the UNet on orbit frames (labels = GT ht maps),
  2. score held-out-frame 2D IoU (prob > 0.5, both classes),
  3. fuse TWO maps with identical GT poses — one fed the NET's ht/lt,
     one fed the GT maps — and score voxel-level high-touch IoU over
     surface voxels (|tsdf| < 0.1, p_cutoff 0.5: the reference's
     thresholds), i.e. the net's error as the *map* sees it.

Saves the trained weights to ra_slam_tpu/models/demo_seg.npz (used by
tests, demos and chip_smoke.py as a real non-fake model) and the scores
to the path given as the first argument (default `semantic.json`):

    python scripts/gen_semantic.py [out.json]
"""

import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp


def log(m):
    print(f"[+{time.monotonic()-T0:6.1f}s] {m}", flush=True)


T0 = time.monotonic()
H, W = 240, 320
PH = 256  # height padded to /32 (width 320 already is)


def _frames(seed, n, clutter=4):
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    ds = SyntheticBoxDataset(
        num_frames=n,
        cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                                width=W, height=H),
        radius=1.0, seed=seed, clutter=clutter,
    )
    return ds, [ds.frame(i) for i in range(n)]


def main():
    import optax

    from ra_slam_tpu.models.segmentation import (
        init_unet, make_train_step, save_params, unet_apply,
    )

    params = init_unet(jax.random.PRNGKey(0), widths=(16, 32, 64))
    opt = optax.adam(3e-4)
    opt_state = opt.init(params)
    step = make_train_step(opt)

    _, train = _frames(seed=0, n=48)

    def prep(fs):
        x = np.stack([f.rgb for f in fs]).astype(np.float32) / 255.0
        y = np.where(np.stack([f.ht for f in fs]) > 0.5, 0, 1).astype(np.int32)
        xpad = np.zeros((len(fs), PH, W, 3), np.float32)
        xpad[:, :H] = x
        ypad = np.full((len(fs), PH, W), -1, np.int32)  # pad rows masked
        ypad[:, :H] = y
        return jnp.asarray(xpad), jnp.asarray(ypad)

    xs, ys = prep(train)
    n_steps, bs = 300, 4
    order = np.random.default_rng(0).integers(0, len(train), (n_steps, bs))
    t0 = time.perf_counter()
    loss0 = loss = None
    for s in range(n_steps):
        idx = jnp.asarray(order[s])
        params, opt_state, loss = step(params, opt_state, xs[idx], ys[idx])
        if s == 0:
            loss0 = float(loss)
    train_s = time.perf_counter() - t0
    log(f"trained {n_steps} steps: loss {loss0:.3f} -> {float(loss):.3f} "
        f"({train_s:.0f}s)")

    # --- held-out 2D IoU (different seed => different clutter layout) ---
    _, test = _frames(seed=3, n=16)
    xt, yt = prep(test)

    @jax.jit
    def infer(params, x):
        return jax.nn.softmax(unet_apply(params, x), axis=-1)[..., 0]

    probs = np.asarray(infer(params, xt))[:, :H]  # [N, H, W] ht prob
    gt_ht = np.stack([f.ht for f in test]) > 0.5
    pred = probs > 0.5
    inter = (pred & gt_ht).sum()
    union = (pred | gt_ht).sum()
    iou_ht = inter / max(union, 1)
    iou_lt = ((~pred & ~gt_ht).sum()) / max((~pred | ~gt_ht).sum(), 1)
    acc = (pred == gt_ht).mean()
    log(f"2D held-out: IoU(ht) {iou_ht:.3f} IoU(lt) {iou_lt:.3f} acc {acc:.3f}")

    # --- pipeline voxel IoU: net-fed map vs GT-fed map ------------------
    from ra_slam_tpu.core.config import TsdfConfig
    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.map.voxel_map import create_map, integrate_frame

    cfg = TsdfConfig(
        voxel_size=0.02, truncation=0.12, max_depth=6.0,
        log2_num_blocks=15, log2_hash_size=17,
        max_visible_blocks=1 << 12, max_new_blocks=1 << 13,
        width=W, height=H,
    )
    ds, fuse_frames = _frames(seed=3, n=40)
    cam = ds.camera
    istep = jax.jit(
        functools.partial(integrate_frame, cfg=cfg, alloc_stride=2),
        donate_argnums=(0,),
    )

    def fuse(use_net):
        m = create_map(cfg)
        for i, f in enumerate(fuse_frames):
            if use_net:
                p = infer(params, xt_one(f))[0, :H]
                ht = p
                lt = 1.0 - p
            else:
                ht = jnp.asarray(f.ht)
                lt = jnp.asarray(f.lt)
            m, st = istep(m, jnp.asarray(f.rgb, jnp.float32),
                          jnp.asarray(f.depth), ht, lt, cam,
                          SE3.from_matrix(jnp.asarray(f.cam_T_world)))
        return jax.block_until_ready(m)

    def xt_one(f):
        x = np.zeros((1, PH, W, 3), np.float32)
        x[0, :H] = np.asarray(f.rgb, np.float32) / 255.0
        return jnp.asarray(x)

    m_net = fuse(True)
    m_gt = fuse(False)
    log("maps fused")

    def surface_ht(m):
        valid = (np.asarray(m.weight) > 1.5) & (
            np.abs(np.asarray(m.tsdf)) < 0.1
        ) & np.asarray(m.active)[:, None]
        ht = np.asarray(m.prob) > 0.5
        return valid, ht

    v1, h1 = surface_ht(m_net)
    v2, h2 = surface_ht(m_gt)
    both = v1 & v2
    p_net = h1 & both
    p_gt = h2 & both
    vox_iou = (p_net & p_gt).sum() / max((p_net | p_gt).sum(), 1)
    vox_acc = (h1[both] == h2[both]).mean()
    log(f"voxel: IoU(ht, net vs GT-fed map) {vox_iou:.3f} acc {vox_acc:.3f} "
        f"({int(both.sum())} mutual surface voxels)")

    save_params(os.path.join(REPO, "ra_slam_tpu/models/demo_seg.npz"), params)

    out = {
        "description": (
            "Semantic net trained on the synthetic labeled scene (48 "
            "frames, seed 0) and scored held-out (seed 3: different "
            "clutter): 2D IoU at prob>0.5, plus PIPELINE voxel IoU — a "
            "net-fed fused map vs a GT-fed fused map over mutual "
            "surface voxels (|tsdf|<0.1, p_cutoff 0.5, the reference "
            "thresholds). Backend: " + jax.default_backend() + "."
        ),
        "train_steps": n_steps,
        "train_loss_first_last": [round(loss0, 4), round(float(loss), 4)],
        "train_wall_s": round(train_s, 1),
        "iou_2d_high_touch": round(float(iou_ht), 4),
        "iou_2d_low_touch": round(float(iou_lt), 4),
        "pixel_acc_2d": round(float(acc), 4),
        "voxel_iou_high_touch": round(float(vox_iou), 4),
        "voxel_acc": round(float(vox_acc), 4),
        "mutual_surface_voxels": int(both.sum()),
        "weights": "ra_slam_tpu/models/demo_seg.npz",
    }
    with open(sys.argv[1] if len(sys.argv) > 1 else "semantic.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
