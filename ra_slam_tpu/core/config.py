"""Configuration system.

Two-tier like the reference (`/root/reference/utils/config_reader.hpp:13-42`
+ popl CLI flags): YAML files describing cameras/datasets, plus dataclass
configs for every subsystem. Unlike the reference — which hard-codes TSDF
voxel size / truncation / max-depth at call sites
(`/root/reference/main/offline_eval.cc:54-55`) — all map parameters live in
`TsdfConfig`.

The YAML schema is compatible with the reference's `configs/*.yaml`
(Camera.fx/fy/cx/cy, `depthmap_factor`, `tsdf.width/height`, Feature.*).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    width: int = 640
    height: int = 480
    fps: float = 30.0
    depthmap_factor: float = 5000.0  # raw depth units per meter
    # stereo only:
    focal_x_baseline: float = 0.0


@dataclass(frozen=True)
class TsdfConfig:
    """Dense map parameters.

    Defaults mirror the reference call sites: voxel 0.01 m, truncation
    6x voxel, max depth 6 m (`/root/reference/main/offline_eval.cc:54-55`),
    weight clamp 40 and carving threshold 0.9
    (`/root/reference/utils/tsdf/voxel_tsdf.cu:238,880`).
    """

    voxel_size: float = 0.01
    truncation: float = 0.06
    max_depth: float = 6.0
    min_depth: float = 0.1
    max_weight: float = 40.0
    carve_threshold: float = 0.9
    raycast_min_weight: float = 10.0
    # capacities (static shapes; reference uses 2^18 blocks / 2^22 hash
    # entries, `/root/reference/utils/tsdf/voxel_mem.cuh:11-13`)
    log2_num_blocks: int = 16
    log2_hash_size: int = 18
    max_visible_blocks: int = 8192
    max_new_blocks: int = 8192  # per-frame allocation cap (overflow counted)
    # raycast: cap on visible blocks holding renderable shell voxels
    # (0 = max_visible_blocks // 2); overflow counted in dropped_splats
    max_shell_blocks: int = 0
    # image feed size (reference `tsdf.width/height` yaml keys)
    width: int = 640
    height: int = 480

    @property
    def num_blocks(self) -> int:
        return 1 << self.log2_num_blocks

    @property
    def hash_size(self) -> int:
        return 1 << self.log2_hash_size


@dataclass(frozen=True)
class FeatureConfig:
    """ORB frontend parameters (reference Feature.* yaml keys,
    `/root/reference/configs/TUM_RGBD_rgbd_1.yaml:31-37`)."""

    max_num_keypoints: int = 1000
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_fast_threshold: int = 20
    min_fast_threshold: int = 7
    # spatial-binning cell (px) for keypoint distribution; 0 = global
    # top-k only (the reference's per-cell search, SURVEY.md §2.8)
    cell_size: int = 32


@dataclass(frozen=True)
class TrackingConfig:
    gn_iterations: int = 10
    huber_delta: float = 5.0  # pixels
    match_hamming_max: int = 64
    match_ratio: float = 0.8
    match_radius: float = 20.0  # projective gating radius (pixels)
    min_inliers: int = 20  # below this -> tracking lost
    min_depth: float = 0.1  # meters, for landmark creation
    max_depth: float = 8.0
    keyframe_min_interval: int = 3
    keyframe_translation: float = 0.15  # meters
    keyframe_rotation: float = 0.25  # radians
    keyframe_min_inliers: int = 60  # weak tracking forces a keyframe
    max_map_points: int = 20000
    max_keyframes: int = 256
    # pose-acceptance gates: a Gauss-Newton result that technically
    # clears `min_inliers` can still be a degenerate fit — reject it on
    # residual size, on an implausible single-frame jump, or when most
    # matches were outliers (self-similar-texture aliasing). A rejected
    # frame keeps the predicted pose and flags `lost` (-> relocalizer)
    # instead of poisoning the map with a garbage keyframe.
    max_track_rmse: float = 3.0  # px, inlier reprojection rmse
    # jump gates sized ~3-4x a brisk inter-frame motion: a repeating-
    # texture cell shift shows up as a whole extra frame of motion in
    # one step (measured 0.41 m accepted at 0.5, instantly baked into a
    # keyframe half a meter off); genuine corrections bigger than this
    # arrive via reloc/loop paths that bypass these gates
    max_pose_jump_t: float = 0.2  # m per frame vs prediction
    max_pose_jump_r: float = 0.15  # rad per frame vs prediction
    min_inlier_ratio: float = 0.5  # inliers / matches
    # stage-2 re-match gate (px) around the stage-1 refined pose's
    # reprojections (OpenVSLAM's second, tight local-map search) — wide
    # enough for measurement noise, narrower than the texture cell pitch
    # so a one-cell population shift cannot survive re-matching
    rematch_radius: float = 8.0
    # consecutive soft gate failures before tracking escalates to lost
    # (hard inlier collapse escalates immediately)
    reloc_after: int = 2
    # relative weight of the per-keypoint pixel-scaled depth residual in
    # the stage-2 motion-only solve (0 disables)
    track_depth_weight: float = 0.5
    # landmark-fusion gates (OpenVSLAM's local-mapping "fuse" step):
    # at keyframe insertion an unmatched feature re-binds to an existing
    # landmark instead of spawning a duplicate when one agrees in
    # descriptor, image position, and depth. The gate dedups TRUE
    # duplicates only — bridging drift is loop closure's job (a wide
    # 35 px gate mis-bound repeating-texture cells; those weight-1
    # observations crept the converged BA window rmse to ~2 px and
    # pushed every post-keyframe pose ~0.1-0.2 m off the landmark map)
    fuse_radius: float = 12.0  # px
    fuse_hamming_max: int = 22
    fuse_depth_ratio: float = 0.06  # |z_lm - d| <= ratio * d + 0.05 m
    # no new landmark spawns within this pixel radius of an existing
    # depth-consistent landmark (duplicate-sheet suppression; see
    # tracker.insert_keyframe_landmarks)
    spawn_suppress_radius: float = 6.0
    # landmark culling cadence (per keyframe)
    cull_min_obs: int = 2
    cull_max_age: int = 40
    # local-map gate for frame-to-map matching: only landmarks seen
    # within this many keyframes are match candidates (OpenVSLAM tracks
    # the covisible LOCAL map, not the global one). Without it a drifted
    # revisit offers two landmark sheets (old map + duplicated new map)
    # inside the projective gate; the mixed match set splits the inlier
    # count and tracking dies exactly when loop closure needs it alive.
    # The old sheet rejoins through keyframe fusion once a loop
    # correction aligns it. <= 0 disables (global matching).
    track_max_age: int = 8


    def scaled(self, width_scale: float) -> "TrackingConfig":
        """Pixel thresholds are ANGULAR quantities calibrated at a
        320-wide image; scale them for another resolution so gates cover
        the same field-of-view cone (a VGA run with QVGA gates silently
        tightens every window 2x — measured: the offline_eval synthetic
        orbit tracked 8/40 frames at VGA with unscaled defaults)."""
        import dataclasses as _dc

        return _dc.replace(
            self,
            match_radius=self.match_radius * width_scale,
            rematch_radius=self.rematch_radius * width_scale,
            max_track_rmse=self.max_track_rmse * width_scale,
            fuse_radius=self.fuse_radius * width_scale,
            spawn_suppress_radius=self.spawn_suppress_radius * width_scale,
        )


@dataclass(frozen=True)
class BAConfig:
    window_size: int = 8
    iterations: int = 8
    huber_delta: float = 2.0
    damping: float = 1e-4


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    # extrinsics: 4x4 row-major depth-cam -> tracking-cam transform
    extrinsics: Optional[list] = None


def _get(node: dict, key: str, default):
    return node[key] if node and key in node else default


def load_yaml_config(path: str) -> SystemConfig:
    """Parse a reference-style YAML config into a SystemConfig.

    Accepts both flat reference keys (`Camera.fx`, `depthmap_factor`,
    `tsdf.width`) and nested native keys (`tsdf: {voxel_size: ...}`).
    """
    import yaml

    with open(path) as f:
        node = yaml.safe_load(f) or {}

    cam_node = node.get("Camera", node.get("camera", {})) or {}
    if not cam_node:
        # reference flat style: Camera.fx etc.
        cam_node = {
            k.split(".", 1)[1]: v for k, v in node.items() if k.startswith("Camera.")
        }
    cam = CameraConfig(
        fx=float(_get(cam_node, "fx", 525.0)),
        fy=float(_get(cam_node, "fy", 525.0)),
        cx=float(_get(cam_node, "cx", 319.5)),
        cy=float(_get(cam_node, "cy", 239.5)),
        width=int(_get(cam_node, "cols", _get(cam_node, "width", 640))),
        height=int(_get(cam_node, "rows", _get(cam_node, "height", 480))),
        fps=float(_get(cam_node, "fps", 30.0)),
        depthmap_factor=float(
            node.get("depthmap_factor", cam_node.get("depthmap_factor", 5000.0))
        ),
        focal_x_baseline=float(_get(cam_node, "focal_x_baseline", 0.0)),
    )

    tsdf_node = node.get("tsdf", {}) or {}
    tsdf_kwargs = {}
    for f_ in dataclasses.fields(TsdfConfig):
        if f_.name in tsdf_node:
            tsdf_kwargs[f_.name] = type(f_.default)(tsdf_node[f_.name])
    # reference flat keys tsdf.width/tsdf.height
    for k in ("width", "height"):
        flat = node.get(f"tsdf.{k}")
        if flat is not None:
            tsdf_kwargs[k] = int(flat)
    tsdf = TsdfConfig(**tsdf_kwargs)

    feat_node = node.get("Feature", node.get("feature", {})) or {}
    feat = FeatureConfig(
        max_num_keypoints=int(_get(feat_node, "max_num_keypoints", 1000)),
        scale_factor=float(_get(feat_node, "scale_factor", 1.2)),
        num_levels=int(_get(feat_node, "num_levels", 8)),
        ini_fast_threshold=int(_get(feat_node, "ini_fast_threshold", 20)),
        min_fast_threshold=int(_get(feat_node, "min_fast_threshold", 7)),
    )

    extrinsics = node.get("Extrinsics", node.get("extrinsics"))

    return SystemConfig(camera=cam, tsdf=tsdf, feature=feat, extrinsics=extrinsics)
