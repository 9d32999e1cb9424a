"""Offline reconstruction / evaluation entry point.

The primary metric path (reference `main/offline_eval.cc:37-150` and the
headless `examples/scannet_evaluation/eval_one.cc`): replay a `.sens`
or logged-folder dataset, segment each frame (trained model or fake
mode), fuse into the semantic TSDF with GT poses — or track with the
native SLAM system (`--use-slam`) — then optionally dump the semantic
voxels + mesh and score against a labeled GT mesh.

    python -m ra_slam_tpu.pipeline.offline_eval --sens scene.sens \
        --download out/ --max-frames 200
    python -m ra_slam_tpu.pipeline.offline_eval --folder capture/ \
        --use-slam --eval-gt scene_vh_clean_2.labels.ply
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sens", help=".sens sequence path")
    src.add_argument("--folder", help="logged folder dataset path")
    src.add_argument("--synthetic", action="store_true",
                     help="synthetic box-room orbit (smoke test)")
    p.add_argument("--model", default=None,
                   help="segmentation checkpoint (absent -> fake all-ones maps)")
    p.add_argument("--use-slam", action="store_true",
                   help="track with the native SLAM system instead of GT poses")
    p.add_argument("--download", default=None,
                   help="output dir for tsdf.bin + mesh dumps")
    p.add_argument("--eval-gt", default=None,
                   help="ScanNet *_vh_clean_2.labels.ply for IoU scoring")
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--truncation", type=float, default=0.06)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--log2-blocks", type=int, default=17)
    p.add_argument("--render-every", type=int, default=0,
                   help="dump a raycast PNG every N frames into --download")
    p.add_argument("--trajectory-out", default=None,
                   help="save the (SLAM) trajectory in id + 3x4 format")
    p.add_argument("--native-io", action="store_true",
                   help="use the C++ .sens decoder + threaded prefetcher")
    return p


def load_dataset(args):
    if args.sens:
        if getattr(args, "native_io", False):
            from ra_slam_tpu.native import NativeSensReader

            return NativeSensReader(args.sens)
        from ra_slam_tpu.io import SensReader

        return SensReader(args.sens)
    if args.folder:
        from ra_slam_tpu.io import FolderReader

        return FolderReader(args.folder)
    from ra_slam_tpu.io import SyntheticBoxDataset, SyntheticCameraSpec

    spec = SyntheticCameraSpec(
        fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
    )
    # 120-frame orbit: 3 deg/frame keeps the tracker's constant-velocity
    # + gating assumptions valid (60 frames = 6 deg/frame loses frame 1)
    return SyntheticBoxDataset(
        num_frames=120, cam=spec, half_extents=(3.0, 2.0, 3.0), radius=1.0
    )


def run(argv=None):
    """Parse `argv`, replay the dataset through `RaSlamSystem` and return
    (result dict, the system) — `main` without the printing."""
    args = build_parser().parse_args(argv)

    from ra_slam_tpu.core.config import (
        CameraConfig,
        SystemConfig,
        TsdfConfig,
    )
    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.pipeline.system import RaSlamSystem

    ds = load_dataset(args)
    cam = ds.camera
    n = len(ds) if args.max_frames == 0 else min(args.max_frames, len(ds))

    cfg = SystemConfig(
        camera=CameraConfig(
            fx=float(cam.fx), fy=float(cam.fy),
            cx=float(cam.cx), cy=float(cam.cy),
            width=cam.width, height=cam.height,
        ),
        tsdf=TsdfConfig(
            voxel_size=args.voxel_size,
            truncation=args.truncation,
            max_depth=args.max_depth,
            log2_num_blocks=args.log2_blocks,
            log2_hash_size=args.log2_blocks + 2,
            max_visible_blocks=1 << 14,
            max_new_blocks=1 << 15,
            width=cam.width,
            height=cam.height,
        ),
    )
    sys_ = RaSlamSystem(
        cfg, segmentation_model=args.model, enable_tracking=args.use_slam
    )

    if args.sens and args.native_io:
        # C++ prefetcher: decode overlaps device compute
        import itertools

        frames_iter = itertools.islice(ds.prefetch(num_threads=2, capacity=8), n)
    else:
        frames_iter = (ds.frame(i) for i in range(n))

    t_int = t_track = 0.0
    n_frames = n_tracked = 0
    gt_traj = []  # (frame_id, 3x4) GT rows for ATE scoring
    t0 = time.perf_counter()
    for i, fr in enumerate(frames_iter):
        n_frames += 1
        if fr.cam_T_world is not None:
            gt_traj.append((fr.frame_id, np.asarray(fr.cam_T_world)[:3, :4]))
        pose = None
        if args.use_slam:
            ts = time.perf_counter()
            info = sys_.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp)
            t_track += time.perf_counter() - ts
            if not info.tracked:
                continue
            n_tracked += 1
            pose = info.pose
        else:
            assert fr.cam_T_world is not None, "dataset lacks GT poses"
            pose = SE3.from_matrix(jnp.asarray(fr.cam_T_world))

        ts = time.perf_counter()
        ht, lt = (fr.ht, fr.lt) if fr.ht is not None else (None, None)
        stats = sys_.feed_rgbd_frame(
            fr.rgb, fr.depth, fr.timestamp, pose=pose, ht=ht, lt=lt
        )
        t_int += time.perf_counter() - ts

        if (
            args.render_every
            and args.download
            and i % args.render_every == 0
        ):
            import cv2

            os.makedirs(args.download, exist_ok=True)
            out = sys_.render(pose)
            rgba = np.asarray(out["rgba"], np.uint8)
            cv2.imwrite(
                os.path.join(args.download, f"render_{i:05d}.png"),
                cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA),
            )
    jax.block_until_ready(sys_.map)
    wall = time.perf_counter() - t0

    result = {
        "frames_in": n_frames,
        "frames": sys_.num_integrated,
        "fps": sys_.num_integrated / max(wall, 1e-9),
        "wall_s": wall,
        "track_s": t_track,
        "integrate_s": t_int,
        **sys_.last_stats,
    }

    if args.download:
        os.makedirs(args.download, exist_ok=True)
        tsdf_path = os.path.join(args.download, "tsdf.bin")
        result["tsdf_rows"] = sys_.download_all(tsdf_path)
        nv, nt = sys_.download_all_mesh(
            os.path.join(args.download, "mesh_vertices.bin"),
            os.path.join(args.download, "mesh_indices.bin"),
            os.path.join(args.download, "mesh_vertices_prob.bin"),
        )
        result["mesh_vertices"], result["mesh_triangles"] = nv, nt

        if args.eval_gt:
            from ra_slam_tpu.eval import ScannetEval

            result["eval"] = ScannetEval(tsdf_path, args.eval_gt).summary()

    if args.use_slam:
        result["tracked"] = n_tracked
        est_traj = sys_.slam.trajectory()
        if args.trajectory_out:
            from ra_slam_tpu.io import save_trajectory

            save_trajectory(args.trajectory_out, est_traj)
        if len(gt_traj) >= 3 and len(est_traj) >= 3:
            # the quantitative acceptance test the reference leaves to
            # its paper: ATE of tracked vs GT trajectory (BASELINE.md #1)
            from ra_slam_tpu.eval.ate import ate_rmse, rpe_rmse

            try:
                result["ate"] = ate_rmse(est_traj, gt_traj)
                result["rpe"] = rpe_rmse(est_traj, gt_traj, delta=1)
            except ValueError as e:
                result["ate_error"] = str(e)
    return result, sys_


def main(argv=None) -> dict:
    result, _ = run(argv)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
