"""Live camera drivers (import-gated; no camera SDKs in CI).

Parity with `/root/reference/cameras/`: RealSense RGB-D (L515 at
1280x720 color + 640x480 depth aligned to color, SR300 at 640x480 —
`l515.cc:11-66`, `sr300.h:6-28`) and ZED-as-UVC stereo with
side-by-side split + rectification (`zed_native.cc:11-40`). Drivers
raise a clear error when the backing SDK (pyrealsense2 / a V4L2 device)
is absent, so headless replay via `io/folder.py` / `io/sens.py` remains
the default path.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ra_slam_tpu.core.rectify import StereoRectifier


def get_timestamp() -> float:
    """Monotonic seconds (reference `GetTimestamp`, `utils/time.hpp:11`)."""
    return time.monotonic()


def get_system_timestamp() -> float:
    """Wall-clock seconds (reference `GetSystemTimestamp`)."""
    return time.time()


class RealSenseCamera:
    """L515 / SR300-style RGB-D capture via pyrealsense2.

    `get_rgbd_frame()` returns (rgb [H,W,3] uint8, depth [H,W] float32
    meters, timestamp) with depth aligned to color, matching
    `L515::GetRGBDFrame` (`l515.cc:24-47`).
    """

    def __init__(
        self,
        color_size: Tuple[int, int] = (1280, 720),
        depth_size: Tuple[int, int] = (640, 480),
        fps: int = 30,
    ):
        try:
            import pyrealsense2 as rs
        except ImportError as e:  # pragma: no cover - no SDK in CI
            raise RuntimeError(
                "pyrealsense2 not available; use the offline readers"
            ) from e
        self._rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(
            rs.stream.color, color_size[0], color_size[1], rs.format.rgb8, fps
        )
        cfg.enable_stream(
            rs.stream.depth, depth_size[0], depth_size[1], rs.format.z16, fps
        )
        profile = self.pipeline.start(cfg)
        sensor = profile.get_device().first_depth_sensor()
        self.depth_scale = float(sensor.get_depth_scale())
        self.align = rs.align(rs.stream.color)

    def get_rgbd_frame(self) -> Tuple[np.ndarray, np.ndarray, float]:
        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asanyarray(frames.get_color_frame().get_data())
        depth_raw = np.asanyarray(frames.get_depth_frame().get_data())
        depth = depth_raw.astype(np.float32) * self.depth_scale
        ts = frames.get_timestamp() * 1e-3  # ms -> s
        return color, depth, ts

    def close(self) -> None:
        self.pipeline.stop()


class ZedNativeCamera:
    """ZED as a UVC webcam: side-by-side stereo split + rectification
    (reference `ZEDNative`, `zed_native.cc:11-40`)."""

    def __init__(
        self,
        rectifier: Optional[StereoRectifier],
        device_id: int = 0,
        width: int = 1344,  # side-by-side 2x672
        height: int = 376,
        fps: int = 60,
    ):
        import cv2

        self.cap = cv2.VideoCapture(device_id)
        if not self.cap.isOpened():  # pragma: no cover - no camera in CI
            raise RuntimeError(f"cannot open video device {device_id}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.cap.set(cv2.CAP_PROP_FPS, fps)
        self.rectifier = rectifier

    def get_stereo_frame(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(left, right, timestamp) — rectified when a rectifier is set."""
        import cv2

        ok, frame = self.cap.read()
        ts = get_timestamp()
        if not ok:  # pragma: no cover
            raise RuntimeError("frame grab failed")
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        half = frame.shape[1] // 2
        left, right = frame[:, :half], frame[:, half:]
        if self.rectifier is not None:
            left, right = self.rectifier.rectify(left, right)
        return left, right, ts

    def close(self) -> None:
        self.cap.release()


class ZedDepthCamera:
    """ZED-SDK-style stereo RGB-D: raw UVC stereo capture + on-device
    dense census disparity, returning (stereo pair, RGB-D frame) like
    `ZED::GetStereoAndRGBDFrame` (`/root/reference/cameras/zed.h:9-42`)
    — with `features/stereo.dense_stereo_depth` playing the SDK's depth
    engine on the accelerator, in JAX instead of the SDK's CUDA.
    """

    def __init__(
        self,
        rectifier,
        focal_x_baseline: float,
        device_id: int = 0,
        width: int = 1344,
        height: int = 376,
        fps: int = 60,
        max_disparity: int = 64,
        max_depth: float = 10.0,
    ):
        import functools

        import jax

        from ra_slam_tpu.features.pyramid import rgb_to_gray
        from ra_slam_tpu.features.stereo import dense_stereo_depth

        self.cam = ZedNativeCamera(rectifier, device_id, width, height, fps)

        def _depth(left_rgb, right_rgb):
            gl = rgb_to_gray(left_rgb)
            gr = rgb_to_gray(right_rgb)
            d, ok = dense_stereo_depth(
                gl, gr, focal_x_baseline,
                max_disparity=max_disparity, max_depth=max_depth,
            )
            return d

        self._depth = jax.jit(_depth)

    def get_stereo_and_rgbd_frame(self):
        """((left, right, t_stereo), (rgb, depth, t_rgbd)): the stereo
        pair feeds tracking, left+dense-depth feeds the TSDF."""
        import numpy as np

        left, right, ts = self.cam.get_stereo_frame()
        l32 = np.asarray(left, np.float32)
        r32 = np.asarray(right, np.float32)
        depth = np.asarray(self._depth(l32, r32))
        return (left, right, ts), (left, depth, ts)

    def close(self) -> None:
        self.cam.close()
