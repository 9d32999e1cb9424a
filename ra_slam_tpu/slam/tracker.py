"""Frame-to-map RGB-D/stereo tracking.

The per-frame tracking loop the reference outsources to OpenVSLAM's
`tracker_->track_RGBD_image` (`/root/reference/modules/slam_module.cc:133`):
constant-velocity pose prediction, projective descriptor matching
against the landmark map, motion-only Gauss-Newton, keyframe policy.

Dense formulation: the match step is a dense Hamming matrix (one
matmul) between the frame's features and ALL landmarks, gated by
projected pixel distance — replacing OpenVSLAM's per-cell reprojection
search with a single batched op. Everything is static-shape and jit-able
end to end; keyframe/new-landmark decisions come back as scalars the
host acts on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera, bilinear_sample, nearest_sample
from ra_slam_tpu.core.config import TrackingConfig
from ra_slam_tpu.core.se3 import SE3, exp_se3, log_se3
from ra_slam_tpu.features.matching import hamming_matrix
from ra_slam_tpu.features.orb import NUM_PAIRS, Keypoints
from ra_slam_tpu.slam.landmarks import (
    Landmarks,
    add_landmarks,
    cull_landmarks,
    record_observations,
)
from ra_slam_tpu.slam.pnp import motion_only_gn


class TrackState(NamedTuple):
    """Tracker pytree state threaded through frames."""

    pose: SE3  # cam_T_world of the last tracked frame
    velocity: jax.Array  # [6] twist: pose_k ~ exp(velocity) @ pose_{k-1}
    lms: Landmarks
    kf_counter: jax.Array  # int32 number of keyframes so far
    frames_since_kf: jax.Array  # int32
    last_kf_pose: SE3
    initialized: jax.Array  # bool
    lost: jax.Array  # bool
    # consecutive soft acceptance-gate failures; a single over-threshold
    # frame keeps the motion-model pose and does NOT trigger reloc
    bad_streak: jax.Array  # int32


def create_track_state(max_landmarks: int) -> TrackState:
    from ra_slam_tpu.slam.landmarks import create_landmarks

    return TrackState(
        pose=SE3.identity(),
        velocity=jnp.zeros(6, jnp.float32),
        lms=create_landmarks(max_landmarks),
        kf_counter=jnp.int32(0),
        frames_since_kf=jnp.int32(0),
        last_kf_pose=SE3.identity(),
        initialized=jnp.array(False),
        lost=jnp.array(False),
        bad_streak=jnp.int32(0),
    )


def keypoint_depth(
    depth: jax.Array,  # [H, W] float32 meters (0 = invalid)
    kp: Keypoints,
    tcfg: TrackingConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Edge-aware per-keypoint depth: bilinear where the 2x2 neighborhood
    is depth-continuous (subpixel accuracy to match the subpixel
    corners), nearest at discontinuities (bilinear would smear foreground
    and background into a phantom point). Returns (d [F], valid [F])."""
    d_near, dvalid = nearest_sample(depth, kp.uv)
    d_bil, bvalid = bilinear_sample(depth, kp.uv)
    smooth = bvalid & (jnp.abs(d_bil - d_near) < 0.05 * jnp.maximum(d_near, 0.1))
    d = jnp.where(smooth, d_bil, d_near)
    return d, dvalid & (d > tcfg.min_depth) & (d < tcfg.max_depth)


def _gated_match(
    dist: jax.Array,  # [F, M] precomputed Hamming distances
    kp: Keypoints,
    lms: Landmarks,
    pose: SE3,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    radius: float,
    kf_counter: jax.Array | None,
) -> Tuple[jax.Array, jax.Array]:
    """Apply a projective gate at `pose`/`radius` to a precomputed
    Hamming matrix and pick best matches with a ratio test."""
    p_cam = pose.apply(lms.pos)  # [M, 3]
    uv_lm, z = cam.project(p_cam)
    proj_ok = lms.valid & (z > 0.05) & cam.in_bounds(uv_lm)
    if tcfg.track_max_age > 0 and kf_counter is not None:
        # local-map gate (OpenVSLAM covisibility semantics): only
        # recently-seen landmarks are candidates, so a drifted revisit
        # tracks one consistent sheet instead of a mix of old and new
        proj_ok = proj_ok & (
            kf_counter - lms.last_seen <= tcfg.track_max_age
        )

    d2 = jnp.sum(
        (kp.uv[:, None, :] - uv_lm[None, :, :]) ** 2, axis=-1
    )  # [F, M] pixel distance^2
    gate = proj_ok[None, :] & (d2 <= float(radius) ** 2)
    dist = jnp.where(gate, dist, jnp.inf)

    # best + second-best via two min/argmin passes: lax.top_k over
    # [F, 20000] measured 19 ms/call on this chip (it lowers near a full
    # row sort) vs ~1 ms for three reduction passes
    best = jnp.min(dist, axis=1)
    bidx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    col = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    second = jnp.min(
        jnp.where(col == bidx[:, None], jnp.inf, dist), axis=1
    )
    ok = (
        kp.valid
        & jnp.isfinite(best)
        & (best <= tcfg.match_hamming_max)
        & (best < tcfg.match_ratio * jnp.minimum(second, float(NUM_PAIRS)))
    )
    return jnp.where(ok, bidx, -1).astype(jnp.int32), ok


def match_frame_to_map(
    kp: Keypoints,
    lms: Landmarks,
    pose_pred: SE3,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    kf_counter: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Projective-gated dense matching: feature i -> landmark idx (or -1).

    Returns (lm_idx [F] int32, valid [F] bool).
    """
    dist = hamming_matrix(kp.desc, lms.desc)  # [F, M] float32
    return _gated_match(
        dist, kp, lms, pose_pred, cam, tcfg, tcfg.match_radius, kf_counter
    )


class TrackResult(NamedTuple):
    num_matches: jax.Array
    num_inliers: jax.Array
    rmse: jax.Array
    need_keyframe: jax.Array
    lm_idx: jax.Array  # [F] matched landmark per feature (-1 none)
    inlier: jax.Array  # [F] bool
    # acceptance-gate observability: the refined pose's deviation from
    # the motion-model prediction (meters / radians)
    jump_t: jax.Array  # float32
    jump_r: jax.Array  # float32


def track_frame(
    state: TrackState,
    kp: Keypoints,
    depth: jax.Array,  # [H, W] float32 meters (0 = invalid)
    cam: PinholeCamera,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, TrackResult]:
    """Track one frame against the landmark map (pure, jit-able).

    Two-stage like OpenVSLAM's tracking module: (1) match inside a wide
    gate at the motion-model pose and optimize, then (2) re-match inside
    a TIGHT gate around the refined pose's reprojections and re-optimize.
    On repeating texture, stage 1 alone can converge to a whole-population
    one-cell shift (every match moved to the neighboring texture cell —
    measured 0.2 m accepted jumps on the orbit bench); the tight re-match
    keeps only the landmark sheet consistent with the stage-1 majority.
    Both stages reuse ONE Hamming matrix — only the projective gate moves.
    The per-keypoint measured depth adds a pixel-scaled depth residual
    to the stage-2 solve (see `pnp._depth_residuals`).
    """
    pose_pred = exp_se3(state.velocity) @ state.pose
    d_kp, has_depth = keypoint_depth(depth, kp, tcfg)
    d_obs = jnp.where(has_depth, d_kp, 0.0)

    dist = hamming_matrix(kp.desc, state.lms.desc)  # [F, M]
    lm_idx1, mvalid1 = _gated_match(
        dist, kp, state.lms, pose_pred, cam, tcfg,
        tcfg.match_radius, state.kf_counter,
    )
    res1 = motion_only_gn(
        pose_pred,
        state.lms.pos[jnp.maximum(lm_idx1, 0)],
        kp.uv,
        mvalid1.astype(jnp.float32),
        cam,
        iterations=tcfg.gn_iterations,
        huber_delta=tcfg.huber_delta,
    )

    lm_idx, mvalid = _gated_match(
        dist, kp, state.lms, res1.pose, cam, tcfg,
        tcfg.rematch_radius, state.kf_counter,
    )
    pts = state.lms.pos[jnp.maximum(lm_idx, 0)]
    n_match = jnp.sum(mvalid.astype(jnp.int32))
    res = motion_only_gn(
        res1.pose,
        pts,
        kp.uv,
        mvalid.astype(jnp.float32),
        cam,
        iterations=tcfg.gn_iterations,
        huber_delta=tcfg.huber_delta,
        depth_obs=d_obs,
        depth_weight=tcfg.track_depth_weight,
    )

    # acceptance gates (see TrackingConfig): hard failure = inlier
    # collapse; soft failure = residual size / implausible single-frame
    # jump / outlier-dominated match set
    jump = log_se3(res.pose @ pose_pred.inverse())
    collapsed = (res.num_inliers < tcfg.min_inliers) | (
        res.num_inliers.astype(jnp.float32)
        < tcfg.min_inlier_ratio * jnp.maximum(n_match, 1).astype(jnp.float32)
    )
    soft_bad = (
        (res.rmse > tcfg.max_track_rmse)
        | (jnp.linalg.norm(jump[3:]) > tcfg.max_pose_jump_t)
        | (jnp.linalg.norm(jump[:3]) > tcfg.max_pose_jump_r)
    )
    ok = ~collapsed & ~soft_bad
    # a single soft failure keeps the motion-model pose (the map is
    # usually fine and the next frame recovers); only a persistent
    # streak or a hard collapse escalates to lost -> relocalization
    streak = jnp.where(ok, 0, state.bad_streak + 1)
    lost = state.initialized & (
        collapsed | (streak >= tcfg.reloc_after)
    )

    pose_new = jax.tree.map(
        lambda a, b: jnp.where(ok, a, b), res.pose, pose_pred
    )
    # soft-bad keeps the velocity (prediction continues along the motion
    # model); hard loss zeroes it
    vel_new = jnp.where(
        ok,
        log_se3(pose_new @ state.pose.inverse()),
        jnp.where(lost, jnp.zeros_like(state.velocity), state.velocity),
    )

    inlier = res.inliers & mvalid
    lms = record_observations(
        state.lms, lm_idx, inlier & ok, state.kf_counter
    )

    # keyframe policy (reference config semantics: min interval + motion
    # or weak tracking)
    rel = pose_new @ state.last_kf_pose.inverse()
    xi = log_se3(rel)
    moved = (
        (jnp.linalg.norm(xi[3:]) > tcfg.keyframe_translation)
        | (jnp.linalg.norm(xi[:3]) > tcfg.keyframe_rotation)
        | (res.num_inliers < tcfg.keyframe_min_inliers)
    )
    need_kf = state.initialized & ok & (
        (state.frames_since_kf >= tcfg.keyframe_min_interval) & moved
    )

    new_state = TrackState(
        pose=pose_new,
        velocity=vel_new,
        lms=lms,
        kf_counter=state.kf_counter,
        frames_since_kf=state.frames_since_kf + 1,
        last_kf_pose=state.last_kf_pose,
        initialized=state.initialized,
        lost=lost,
        bad_streak=streak,
    )
    return new_state, TrackResult(
        num_matches=n_match,
        num_inliers=res.num_inliers,
        rmse=res.rmse,
        need_keyframe=need_kf,
        lm_idx=lm_idx,
        inlier=inlier,
        jump_t=jnp.linalg.norm(jump[3:]),
        jump_r=jnp.linalg.norm(jump[:3]),
    )


def insert_keyframe_landmarks(
    state: TrackState,
    kp: Keypoints,
    depth: jax.Array,  # [H, W] float32 meters (0 = invalid)
    lm_idx: jax.Array,  # [F] from TrackResult (-1 = unmatched)
    cam: PinholeCamera,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, jax.Array, jax.Array]:
    """Keyframe insertion: unmatched keypoints with valid depth become
    new landmarks (RGB-D initialization — OpenVSLAM's stereo/depth
    keyframe landmark triangulation, simplified to direct unprojection).

    Returns (new state, per-feature landmark index [F] for the keyframe
    observation record: existing match or freshly inserted id or -1,
    per-feature measured depth [F] in meters, 0 = none — stored with
    the keyframe so BA gets its RGB-D depth residual).
    """
    d, has_depth = keypoint_depth(depth, kp, tcfg)

    # Landmark fusion (OpenVSLAM local-mapping "fuse"): before spawning a
    # landmark for an unmatched feature, re-search the whole map with a
    # WIDE pixel gate + descriptor + depth agreement. Without this, every
    # revisit of a drifted region duplicates its landmarks into a second
    # inconsistent sheet that splits future inlier sets.
    p_cam_lm = state.pose.apply(state.lms.pos)  # [M, 3]
    uv_lm, z_lm = cam.project(p_cam_lm)
    hd = hamming_matrix(kp.desc, state.lms.desc)  # [F, M]
    d2 = jnp.sum((kp.uv[:, None, :] - uv_lm[None, :, :]) ** 2, axis=-1)
    depth_ok = (
        jnp.abs(z_lm[None, :] - d[:, None])
        <= tcfg.fuse_depth_ratio * d[:, None] + 0.05
    )
    gate = (
        state.lms.valid[None, :]
        & (z_lm[None, :] > 0.05)
        & (d2 <= float(tcfg.fuse_radius) ** 2)
        & depth_ok
    )
    hd = jnp.where(gate, hd, jnp.inf)
    fuse_best = jnp.argmin(hd, axis=1).astype(jnp.int32)
    fuse_ok = (
        has_depth
        & kp.valid
        & (jnp.min(hd, axis=1) <= tcfg.fuse_hamming_max)
    )
    eff_idx = jnp.where(
        lm_idx >= 0, lm_idx, jnp.where(fuse_ok, fuse_best, -1)
    )

    # spawn suppression: an unmatched feature whose pixel/depth
    # neighborhood already holds ANY valid landmark spawns nothing —
    # even when the descriptor diverged past the fuse gate. Without it,
    # every keyframe re-spawns a drift-displaced duplicate of each
    # landmark whose ORB descriptor decorrelated with viewpoint, and
    # the next frame tracks a two-sheet mix (measured: post-keyframe
    # rmse spikes to 3.5-4 px the moment drift exceeds the match gate).
    occupied = jnp.any(
        gate & (d2 <= float(tcfg.spawn_suppress_radius) ** 2), axis=1
    )
    new_mask = kp.valid & (eff_idx < 0) & has_depth & ~occupied
    p_cam = cam.unproject(kp.uv, d)
    p_world = state.pose.inverse().apply(p_cam)

    lms, new_ids = add_landmarks(
        state.lms, p_world, kp.desc, new_mask, state.kf_counter
    )
    # fused re-observations count as sightings (keeps them from culling)
    lms = record_observations(
        lms, eff_idx, (eff_idx >= 0) & kp.valid, state.kf_counter
    )
    # representative-descriptor refresh (OpenVSLAM's
    # compute_descriptor on new observations): a landmark's spawn-time
    # ORB descriptor decorrelates after ~20-30 deg of viewpoint change;
    # re-observed landmarks adopt this keyframe's descriptor so the
    # whole map stays matchable across the trajectory instead of only
    # its newest sheet.
    upd = jnp.where((eff_idx >= 0) & kp.valid, eff_idx, lms.capacity)
    lms = lms._replace(
        desc=lms.desc.at[upd].set(kp.desc, mode="drop")
    )
    lms = cull_landmarks(
        lms, state.kf_counter,
        min_obs=tcfg.cull_min_obs, max_age=tcfg.cull_max_age,
    )
    obs_lm = jnp.where(eff_idx >= 0, eff_idx, new_ids)

    new_state = state._replace(
        lms=lms,
        kf_counter=state.kf_counter + 1,
        frames_since_kf=jnp.int32(0),
        last_kf_pose=state.pose,
        initialized=jnp.array(True),
    )
    obs_z = jnp.where(has_depth & kp.valid, d, 0.0)
    return new_state, obs_lm, obs_z


def initialize_from_frame(
    state: TrackState,
    kp: Keypoints,
    depth: jax.Array,
    cam: PinholeCamera,
    pose: SE3,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, jax.Array, jax.Array]:
    """Bootstrap the map from the first frame at a known (or identity)
    pose: every valid-depth keypoint becomes a landmark."""
    state = state._replace(pose=pose, last_kf_pose=pose)
    lm_idx = jnp.full((kp.capacity,), -1, jnp.int32)
    return insert_keyframe_landmarks(state, kp, depth, lm_idx, cam, tcfg)
