"""Application facade: tracking + segmentation + dense semantic fusion.

The `DISINFSystem` equivalent
(`/root/reference/disinfect_slam/disinfect_slam.h:27-55`): one object
constructed from a `SystemConfig` that owns the sparse SLAM system, the
segmentation engine, the TSDF voxel map, and the timestamped pose
buffer, and exposes the robot-facing API:

    feed_tracking_frame()  — tracking camera -> SLAM -> pose buffer
                             (the reference's `feed_stereo_frame`; here
                             the tracking camera is RGB-D until the
                             stereo frontend lands)
    feed_rgbd_frame()      — depth camera -> segment -> TSDF integrate
                             with the timestamp-interpolated pose
                             (`disinfect_slam.cc:33-43`)
    query_tsdf()           — AABB voxel query for the planner
    query_camera_pose()    — pose at timestamp
    render()               — raycast virtual view
    download_all*()        — reference-format binary dumps

Where the reference bridges two free-running camera threads with a
mutex-guarded queue + integration thread (`modules/tsdf_module.cc`),
here each feed is one jitted device step and XLA's async dispatch
provides the overlap; host threads are only needed for IO (see
`io/prefetch`).
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import SystemConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map.meshing import extract_mesh, save_mesh
from ra_slam_tpu.map.raycast import raycast
from ra_slam_tpu.map.voxel_map import (
    create_map,
    dump_semantic_tsdf,
    gather_valid_semantic,
    integrate_frame,
    query_tsdf,
)
from ra_slam_tpu.models.segmentation import InferenceEngine
from ra_slam_tpu.slam.system import SlamSystem


class RaSlamSystem:
    """One-stop semantic SLAM + reconstruction system."""

    def __init__(
        self,
        cfg: SystemConfig,
        segmentation_model: Optional[str] = None,
        enable_tracking: bool = True,
        alloc_stride: int = 2,
    ):
        self.cfg = cfg
        tsdf = cfg.tsdf
        self.tsdf_cam = PinholeCamera.create(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
            cfg.camera.width, cfg.camera.height,
        ).resized(tsdf.width, tsdf.height)

        # depth-camera -> tracking-camera extrinsics (applied to queried
        # poses like modules/tsdf_module.cc:29,33)
        self.extrinsics: Optional[SE3] = None
        if cfg.extrinsics is not None:
            m = jnp.asarray(np.array(cfg.extrinsics, np.float32).reshape(4, 4))
            self.extrinsics = SE3.from_matrix(m)

        self.seg = InferenceEngine(
            segmentation_model, width=tsdf.width, height=tsdf.height
        )
        self.map = create_map(tsdf)
        self._integrate = jax.jit(
            functools.partial(integrate_frame, cfg=tsdf, alloc_stride=alloc_stride),
            donate_argnums=(0,),
        )
        # raycast output shapes depend on the virtual camera -> one jitted
        # instance per camera geometry, cached by intrinsics
        self._raycast_cache: dict = {}

        self.slam: Optional[SlamSystem] = None
        if enable_tracking:
            from ra_slam_tpu.core.config import TrackingConfig

            track_cam = PinholeCamera.create(
                cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
                cfg.camera.width, cfg.camera.height,
            )
            # untouched default gates are calibrated at 320-wide images;
            # scale them (and the loop/reloc rmse gates) to this camera
            # as angular windows. Explicit user configs pass unscaled.
            tcfg = cfg.tracking
            scale = 1.0
            if tcfg == TrackingConfig():
                scale = cfg.camera.width / 320.0
                tcfg = tcfg.scaled(scale)
            self.slam = SlamSystem(
                track_cam, fcfg=cfg.feature, tcfg=tcfg,
                loop_max_rmse=3.0 * scale,
                reloc_max_rmse=3.0 * scale,
                focal_x_baseline=cfg.camera.focal_x_baseline,
            )

        self.last_stats: dict = {}
        self.num_integrated = 0
        # serializes jitted-step dispatch between camera threads — the
        # reference's mutex-guarded queue role (modules/tsdf_module.cc);
        # device execution is serialized by JAX anyway, threads overlap IO
        self._lock = threading.RLock()

    # -- tracking camera path -------------------------------------------------
    def feed_tracking_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        timestamp: float,
        pose_hint: Optional[SE3] = None,
    ):
        """Feed the tracking camera (reference `feed_stereo_frame` role,
        `disinfect_slam.cc:45-51`): track, and register the pose in the
        buffer only when tracking succeeded."""
        assert self.slam is not None, "tracking disabled"
        with self._lock:
            return self.slam.feed_rgbd_frame(
                rgb, depth, timestamp, pose_hint=pose_hint
            )

    def feed_stereo_frame(
        self,
        left: np.ndarray,
        right: np.ndarray,
        timestamp: float,
        pose_hint: Optional[SE3] = None,
    ):
        """Rectified stereo tracking-camera path (the reference's
        `feed_stereo_frame`, `disinfect_slam.cc:45-51`)."""
        assert self.slam is not None, "tracking disabled"
        with self._lock:
            return self.slam.feed_stereo_frame(
                left, right, timestamp, pose_hint=pose_hint
            )

    # -- depth camera path ----------------------------------------------------
    def feed_rgbd_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        timestamp: float,
        pose: Optional[SE3] = None,
        ht: Optional[np.ndarray] = None,
        lt: Optional[np.ndarray] = None,
    ) -> dict:
        """Segment + integrate one depth-camera frame
        (`disinfect_slam.cc:33-43`). `pose` (cam_T_world) overrides the
        pose-buffer query (GT-pose replay); returns integrate stats."""
        tsdf = self.cfg.tsdf
        if pose is None:
            assert self.slam is not None, "no pose source"
            if self.slam.lost:
                # pause integration while tracking is lost (closes the
                # reference's own TODO, /root/reference/README.md:43 —
                # fusing with a stale nearest pose corrupts the map)
                return {"skipped": "tracking lost"}
            pose = self.slam.query_pose(timestamp)
            if pose is None:
                return {"skipped": "no pose"}
            if self.extrinsics is not None:
                pose = self.extrinsics @ pose

        if rgb.shape[:2] != (tsdf.height, tsdf.width):
            import cv2

            rgb = cv2.resize(np.asarray(rgb), (tsdf.width, tsdf.height))
            depth = cv2.resize(
                np.asarray(depth), (tsdf.width, tsdf.height),
                interpolation=cv2.INTER_NEAREST,
            )
        if ht is None or lt is None:
            ht, lt = self.seg.infer_one(rgb)

        with self._lock:
            return self._integrate_locked(rgb, depth, ht, lt, pose)

    def _integrate_locked(self, rgb, depth, ht, lt, pose) -> dict:
        self.map, stats = self._integrate(
            self.map,
            jnp.asarray(rgb, jnp.float32),
            jnp.asarray(depth, jnp.float32),
            jnp.asarray(ht, jnp.float32),
            jnp.asarray(lt, jnp.float32),
            self.tsdf_cam,
            pose,
        )
        self.num_integrated += 1
        self.last_stats = {k: int(v) for k, v in stats.items()}
        return self.last_stats

    # -- queries ----------------------------------------------------------------
    def query_camera_pose(self, timestamp: float) -> Optional[SE3]:
        assert self.slam is not None
        return self.slam.query_pose(timestamp)

    def query_tsdf(self, lo, hi) -> np.ndarray:
        """(x, y, z, tsdf) rows inside the AABB (planner API)."""
        with self._lock:
            return query_tsdf(self.map, self.cfg.tsdf, lo, hi)

    def render(
        self, cam_T_world: SE3, cam: Optional[PinholeCamera] = None
    ) -> dict:
        """Raycast a virtual view; returns depth/rgba/normal arrays
        (the renderer module's data source, `renderer_module.cc:56`)."""
        cam = cam or self.tsdf_cam
        key = (
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            cam.width, cam.height,
        )
        if key not in self._raycast_cache:
            self._raycast_cache[key] = jax.jit(
                functools.partial(raycast, cam=cam, cfg=self.cfg.tsdf)
            )
        # lock: a concurrent integrate donates (invalidates) map buffers
        with self._lock:
            return self._raycast_cache[key](self.map, cam_T_world=cam_T_world)

    # -- export -----------------------------------------------------------------
    def download_all(self, path: str) -> int:
        with self._lock:
            return dump_semantic_tsdf(self.map, self.cfg.tsdf, path)

    def download_all_mesh(
        self, vertices_path: str, indices_path: str, prob_path: str
    ) -> Tuple[int, int]:
        with self._lock:
            verts, idx, probs = extract_mesh(self.map, self.cfg.tsdf)
        save_mesh(verts, idx, probs, vertices_path, indices_path, prob_path)
        return len(verts), len(idx)

    def semantic_voxels(self) -> np.ndarray:
        with self._lock:
            return gather_valid_semantic(self.map, self.cfg.tsdf)
