"""Offline map viewer: raycast render sequences from a fused map.

The reference's `ImageRenderer` (`/root/reference/modules/
renderer_module.cc`) is an OpenGL/ImGui window with mouse orbit/zoom,
a follow-cam offset slider, and RGB/normal texture toggle, fed by
`TSDFGrid::RayCast` through CUDA-GL interop. On a headless host the
equivalent is this module: the same raycast op rendered along
parameterized virtual-camera paths (orbit, follow-trajectory with an
offset — the slider's role) and written as PNG sequences, usable from
scripts or notebooks.

    python -m ra_slam_tpu.pipeline.viewer --checkpoint ckpt/ --orbit 24 \
        --out renders/
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map.raycast import raycast
from ra_slam_tpu.map.voxel_map import VoxelMap


def shade_normal(normal: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Normal-shaded uint8 image (the reference's second GL texture)."""
    img = ((normal * 0.5 + 0.5) * 255.0).clip(0, 255).astype(np.uint8)
    return np.where(hit[..., None], img, 0)


def orbit_poses(
    center: np.ndarray,
    radius: float,
    height: float,
    n: int,
    up=(0.0, -1.0, 0.0),
) -> List[np.ndarray]:
    """n world_T_cam orbit poses looking at `center` (mouse-orbit analog)."""
    from ra_slam_tpu.io.synthetic import look_at

    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = center + np.array(
            [radius * np.cos(a), height, radius * np.sin(a)]
        )
        out.append(look_at(eye, center, up))
    return out


def follow_poses(
    trajectory: Iterable[np.ndarray],  # cam_T_world 4x4 per frame
    offset: np.ndarray = np.array([0.0, -0.3, -1.0]),
) -> List[np.ndarray]:
    """Virtual follow-cam: each pose pulled back by `offset` in the
    camera frame (the reference's follow-cam offset slider,
    `renderer_module.cc:124-191`). Input cam_T_world per frame;
    returns world_T_cam (what `render_path` consumes)."""
    out = []
    off = SE3(jnp.eye(3, dtype=jnp.float32), jnp.asarray(offset, jnp.float32))
    for m in trajectory:
        cam_T_world = SE3.from_matrix(jnp.asarray(m, jnp.float32))
        virt = off @ cam_T_world
        out.append(np.asarray(virt.inverse().as_matrix()))
    return out


class MapViewer:
    """Renders RGB + normal-shaded views of a VoxelMap."""

    def __init__(self, m: VoxelMap, cfg: TsdfConfig,
                 cam: Optional[PinholeCamera] = None):
        self.m = m
        self.cfg = cfg
        self.cam = cam or PinholeCamera.create(
            cfg.width * 0.8, cfg.width * 0.8,
            (cfg.width - 1) / 2.0, (cfg.height - 1) / 2.0,
            cfg.width, cfg.height,
        )
        self._render = jax.jit(
            functools.partial(raycast, cam=self.cam, cfg=cfg)
        )

    def render(self, cam_T_world: SE3) -> dict:
        out = self._render(self.m, cam_T_world=cam_T_world)
        rgba = np.asarray(out["rgba"], np.uint8)
        hit = np.asarray(out["hit"])
        return {
            "rgba": rgba,
            "normal": shade_normal(np.asarray(out["normal"]), hit),
            "depth": np.asarray(out["depth"]),
            "hit": hit,
        }

    def render_path(
        self,
        world_T_cam_list: Iterable[np.ndarray],
        out_dir: str,
        save_normal: bool = True,
    ) -> int:
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for i, w_T_c in enumerate(world_T_cam_list):
            pose = SE3.from_matrix(
                jnp.asarray(np.linalg.inv(np.asarray(w_T_c, np.float64)),
                            jnp.float32)
            )
            out = self.render(pose)
            cv2.imwrite(
                os.path.join(out_dir, f"rgb_{i:05d}.png"),
                cv2.cvtColor(out["rgba"], cv2.COLOR_RGBA2BGRA),
            )
            if save_normal:
                cv2.imwrite(
                    os.path.join(out_dir, f"normal_{i:05d}.png"),
                    cv2.cvtColor(out["normal"], cv2.COLOR_RGB2BGR),
                )
            n += 1
        return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="system checkpoint dir (utils/checkpoint.py)")
    p.add_argument("--out", required=True)
    p.add_argument("--orbit", type=int, default=0, help="N orbit views")
    p.add_argument("--trajectory", default=None,
                   help="trajectory.txt to follow (with --follow-offset)")
    p.add_argument("--follow-offset", type=float, nargs=3,
                   default=[0.0, -0.3, -1.0])
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--truncation", type=float, default=0.06)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--log2-blocks", type=int, default=17)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    args = p.parse_args(argv)

    from ra_slam_tpu.map.voxel_map import create_map, gather_valid
    from ra_slam_tpu.utils.checkpoint import load_pytree

    cfg = TsdfConfig(
        voxel_size=args.voxel_size, truncation=args.truncation,
        max_depth=args.max_depth, log2_num_blocks=args.log2_blocks,
        log2_hash_size=args.log2_blocks + 2,
        width=args.width, height=args.height,
    )
    m = load_pytree(os.path.join(args.checkpoint, "map.npz"), create_map(cfg))
    viewer = MapViewer(m, cfg)

    poses = []
    if args.orbit:
        rows = gather_valid(m, cfg)
        center = rows[:, :3].mean(0) if len(rows) else np.zeros(3)
        extent = np.ptp(rows[:, :3], axis=0).max() if len(rows) else 2.0
        poses += orbit_poses(center, 0.8 * extent, -0.3 * extent, args.orbit)
    if args.trajectory:
        from ra_slam_tpu.io import load_trajectory

        traj = [m_ for _, m_ in load_trajectory(args.trajectory)]
        poses += follow_poses(traj, np.array(args.follow_offset))

    n = viewer.render_path(poses, args.out)
    print(f"rendered {n} views into {args.out}")


if __name__ == "__main__":
    main()
