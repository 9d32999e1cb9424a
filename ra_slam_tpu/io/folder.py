"""TUM-style logged-folder dataset: reader, writer, trajectory format.

Replay format produced by the reference's capture loop and consumed by
its `folder_reader` (`/root/reference/utils/offline_data_provider/
folder_reader.cc:9-105`):

    <dir>/camera_config.yaml      Camera.fx/fy/cx/cy, depthmap_factor,
                                  optional Extrinsics (4x4 row-major list)
    <dir>/trajectory.txt          per line: id + 12 floats (3x4 row-major
                                  cam_T_world, last row implied 0 0 0 1)
    <dir>/{id}_rgb.png            8-bit color
    <dir>/{id}_depth.png          16-bit raw depth (units/depthmap_factor m)
    <dir>/{id}_ht.png, {id}_no_ht.png   optional 8-bit probability maps
                                  (examples/tsdf/offline.cc replay input)

The trajectory text format doubles as the output of
`SLAMSystem::SaveMatchedTrajectory` (`modules/slam_module.cc:20-66`), so
`save_trajectory` here is the native trajectory exporter too.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.io.dataset import Frame, RGBDDataset


def save_trajectory(path: str, entries: Sequence[Tuple[int, np.ndarray]]) -> None:
    """Write (frame_id, 3x4-or-4x4 cam_T_world) rows as `id r00 ... r23`."""
    with open(path, "w") as f:
        for fid, pose in entries:
            p = np.asarray(pose, np.float64)[:3, :4].reshape(-1)
            f.write(str(int(fid)) + " " + " ".join(f"{v:.9g}" for v in p) + "\n")


def load_trajectory(path: str) -> List[Tuple[int, np.ndarray]]:
    """Parse `trajectory.txt` rows into (id, 4x4 cam_T_world) pairs
    (`folder_reader::parse_log_entries`, `folder_reader.cc:86-105`)."""
    entries: List[Tuple[int, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 13:
                continue
            fid = int(vals[0])
            m = np.eye(4, dtype=np.float32)
            m[:3, :4] = np.array([float(v) for v in vals[1:]], np.float32).reshape(3, 4)
            entries.append((fid, m))
    return entries


class FolderReader(RGBDDataset):
    """Deterministic replay of a logged folder (the reference's offline
    integration-test fixture, SURVEY.md §4)."""

    def __init__(self, folder: str):
        self.folder = folder
        import yaml

        with open(os.path.join(folder, "camera_config.yaml")) as f:
            self._cfg = yaml.safe_load(f) or {}

        extr = self._cfg.get("Extrinsics")
        self.extrinsics = (
            np.array(extr, np.float32).reshape(4, 4)
            if extr
            else np.eye(4, dtype=np.float32)
        )
        # extrinsics compose onto every trajectory pose (folder_reader.cc:101)
        self._entries = [
            (fid, (self.extrinsics @ pose).astype(np.float32))
            for fid, pose in load_trajectory(os.path.join(folder, "trajectory.txt"))
        ]
        self._depth_factor = float(self._cfg.get("depthmap_factor", 1000.0))

        d0 = self._imread_depth(self._entries[0][0])
        self._h, self._w = d0.shape

    def _imread_depth(self, fid: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.folder, f"{fid}_depth.png")
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def _imread_rgb(self, fid: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.folder, f"{fid}_rgb.png")
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _imread_prob(self, fid: int, suffix: str) -> Optional[np.ndarray]:
        import cv2

        path = os.path.join(self.folder, f"{fid}_{suffix}.png")
        if not os.path.exists(path):
            return None
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        return img.astype(np.float32) / 255.0

    # -- RGBDDataset interface ------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def camera(self) -> PinholeCamera:
        c = self._cfg
        return PinholeCamera.create(
            fx=float(c["Camera.fx"]),
            fy=float(c["Camera.fy"]),
            cx=float(c["Camera.cx"]),
            cy=float(c["Camera.cy"]),
            width=self._w,
            height=self._h,
        )

    @property
    def depth_factor(self) -> float:
        return self._depth_factor

    def frame(self, idx: int) -> Frame:
        fid, pose = self._entries[idx]
        depth = self._imread_depth(fid).astype(np.float32) / self._depth_factor
        return Frame(
            frame_id=fid,
            timestamp=float(fid),
            rgb=self._imread_rgb(fid),
            depth=depth,
            cam_T_world=pose,
            ht=self._imread_prob(fid, "ht"),
            lt=self._imread_prob(fid, "no_ht"),
        )


def write_folder_dataset(
    folder: str,
    frames: Sequence[Frame],
    cam: PinholeCamera,
    depth_factor: float = 1000.0,
    extrinsics: Optional[np.ndarray] = None,
) -> None:
    """Log frames to the replay-folder layout (the role of the reference's
    `DepthLogger`/`SemanticSLAMLogger` capture subclasses,
    `/root/reference/examples/visual_slam/run_zed_native_l515.cc:39-58`)."""
    import cv2
    import yaml

    os.makedirs(folder, exist_ok=True)
    cfg = {
        "Camera.fx": float(cam.fx),
        "Camera.fy": float(cam.fy),
        "Camera.cx": float(cam.cx),
        "Camera.cy": float(cam.cy),
        "depthmap_factor": float(depth_factor),
    }
    if extrinsics is not None:
        cfg["Extrinsics"] = [float(v) for v in np.asarray(extrinsics).reshape(-1)]
    with open(os.path.join(folder, "camera_config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)

    entries = []
    for fr in frames:
        fid = fr.frame_id
        cv2.imwrite(
            os.path.join(folder, f"{fid}_rgb.png"),
            cv2.cvtColor(np.asarray(fr.rgb, np.uint8), cv2.COLOR_RGB2BGR),
        )
        depth_raw = np.clip(
            np.asarray(fr.depth, np.float32) * depth_factor, 0, 65535
        ).astype(np.uint16)
        cv2.imwrite(os.path.join(folder, f"{fid}_depth.png"), depth_raw)
        if fr.ht is not None:
            cv2.imwrite(
                os.path.join(folder, f"{fid}_ht.png"),
                (np.clip(fr.ht, 0, 1) * 255).astype(np.uint8),
            )
        if fr.lt is not None:
            cv2.imwrite(
                os.path.join(folder, f"{fid}_no_ht.png"),
                (np.clip(fr.lt, 0, 1) * 255).astype(np.uint8),
            )
        if fr.cam_T_world is not None:
            entries.append((fid, fr.cam_T_world))
    save_trajectory(os.path.join(folder, "trajectory.txt"), entries)
