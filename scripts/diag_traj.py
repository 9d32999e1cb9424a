"""Diagnostic run of the trajectory_bench sequence with per-frame dumps.

Env-var ablation knobs: FUSE_HAM (fuse_hamming_max, 0 disables fusion),
BA_EVERY (0 disables BA), TRACK_AGE (track_max_age), DSIG (BA depth
sigma override via ra_slam_tpu.slam.ba._DEPTH_SIGMA), NOISE (depth).
"""
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from ra_slam_tpu.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.eval.ate import ate_rmse, rpe_rmse
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.slam.system import SlamSystem

n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 150
width, height = 320, 240
f = width / 2.0
spec = SyntheticCameraSpec(fx=f, fy=f, cx=width / 2 - 0.5, cy=height / 2 - 0.5,
                           width=width, height=height)
ds = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0,
                         depth_noise=float(os.environ.get("NOISE", 0.005)),
                         seed=0)
slam = SlamSystem(
    ds.camera,
    fcfg=FeatureConfig(max_num_keypoints=600, num_levels=4),
    tcfg=TrackingConfig(
        min_inliers=15, match_radius=30.0,
        fuse_hamming_max=int(os.environ.get("FUSE_HAM", 22)),
        track_max_age=int(os.environ.get("TRACK_AGE", 8)),
    ),
    ba_window=6, ba_max_points=2048, ba_iterations=5,
    ba_every_kf=int(os.environ.get("BA_EVERY", 0)),
    loop_every_kf=1, loop_min_inliers=20,
    loop_min_gap=15,
    gba_after_loop=bool(int(os.environ.get("GBA", 1))),
)

gt = []
infos = []
t0 = time.perf_counter()
for i in range(n_frames):
    fr = ds.frame(i)
    hint = SE3.from_matrix(jnp.asarray(fr.cam_T_world)) if i == 0 else None
    info = slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i,
                                pose_hint=hint)
    infos.append(info)
    gt.append((i, np.asarray(fr.cam_T_world)[:3, :4]))
    if i == 0:
        print(f"first frame done at {time.perf_counter()-t0:.0f}s", flush=True)
    if i % 25 == 24:
        print(f"frame {i+1} at {time.perf_counter()-t0:.0f}s", flush=True)
infos[-1].block()
dt = time.perf_counter() - t0
print(f"total {dt:.1f}s ({n_frames/dt:.2f} f/s)")

# batch-pull every frame's device scalars in ONE transfer instead of
# one lazy pull per row
hosts = jax.device_get([inf._dev for inf in infos])
for inf, h in zip(infos, hosts):
    inf._host = h

# per-frame diagnostic table
print("frm trk rel kf  match inl  trmse jmp_t jmp_r  ba_rmse bash  drp  lcand linl lrmse  ldt   ldr   pgo_s  err_t  live_t")
est_poses = {}
for fid, p34 in slam.trajectory():
    est_poses[fid] = p34
for i, inf in enumerate(infos):
    h = inf._pull()
    gt34 = gt[i][1]
    Rg, tg = gt34[:, :3], gt34[:, 3]
    Cg = -Rg.T @ tg
    # live error: the pose the system believed AT THE TIME (info.R/t),
    # before any later BA/PGO refinement re-wrote its keyframe
    Rl, tl = np.asarray(h.R), np.asarray(h.t)
    live = np.linalg.norm(-Rl.T @ tl - Cg)
    if i in est_poses:
        # translation error of camera center: C = -R^T t
        R, t = est_poses[i][:, :3], est_poses[i][:, 3]
        err = np.linalg.norm(-R.T @ t - Cg)
    else:
        err = float("nan")
    flag = ""
    if bool(h.loop_closed):
        flag += " LOOP"
    if bool(h.relocalized):
        flag += " RELOC"
    print(f"{i:3d}  {int(h.tracked)}  {int(h.relocalized)}  "
          f"{int(h.inserted_keyframe)}  {int(h.num_matches):4d} "
          f"{int(h.num_inliers):4d}  {float(h.track_rmse):5.2f} "
          f"{float(h.jump_t):5.3f} {float(h.jump_r):5.3f}  "
          f"{float(h.ba_rmse):7.3f} {float(h.ba_shift):5.3f} {int(h.ba_dropped):3d} "
          f"{int(h.loop_cand):4d} {int(h.loop_inliers):4d} "
          f"{float(h.loop_rmse):6.2f} {float(h.loop_delta_t):5.2f} "
          f"{float(h.loop_delta_r):5.2f} {float(h.pgo_shift):5.3f} "
          f"{err:6.3f} {live:6.3f}{flag}")

# --- landmark map quality vs the analytic box: every true surface
# point lies on a wall plane (|x|=3, |y|=2, or |z|=3); distance to the
# nearest wall measures absolute landmark error, bucketed by creation
# keyframe to localize where corruption enters.
lms = slam.state.track.lms
pos = np.asarray(lms.pos)
valid = np.asarray(lms.valid)
anchor = np.asarray(lms.anchor)
he = np.array([3.0, 2.0, 3.0])
wd = np.min(np.abs(np.abs(pos) - he[None]), axis=1)
print("\nlandmark wall-distance by anchor keyframe (m):")
print(" anc    n   mean    p50     p90    max")
for a in range(int(slam.state.track.kf_counter)):
    sel = valid & (anchor == a)
    if sel.sum() == 0:
        continue
    d = wd[sel]
    print(f"{a:4d} {sel.sum():4d}  {d.mean():.3f}  {np.median(d):.3f} "
          f" {np.percentile(d, 90):.3f}  {d.max():.3f}")

est = slam.trajectory()
m = ate_rmse(est, gt)
print(json.dumps({
    "ate_rmse_m": round(float(m["ate_rmse"]), 4),
    "matched": int(m["matched_frames"]),
    "kfs": int(slam.state.track.kf_counter),
    "loops": slam.num_loop_closures,
    "relocs": slam.num_relocalizations,
    "lost": sum(0 if inf.tracked else 1 for inf in infos),
}))
