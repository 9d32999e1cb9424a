"""Loop-closure detection: embedding retrieval + geometric verification.

The reference gets loop closure from OpenVSLAM's DBoW2 vocabulary index
plus g2o optimization (SURVEY.md §2.8: `--vocab` flags,
`INSTALL.md:36-38`). Redesign (SURVEY.md §7.1): keyframe
descriptors are embedded as mean ±1 vectors so candidate retrieval is
ONE [1, 256] x [256, K] matmul against the whole keyframe database
(monotone in expected Hamming distance), followed by
batched mutual descriptor matching and a robust PnP solve against the
candidate's landmark observations for geometric verification — the
DBoW2 + RANSAC role, with fixed shapes throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TrackingConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.features.matching import mutual_match, unpack_pm1
from ra_slam_tpu.slam.keyframes import Keyframes
from ra_slam_tpu.slam.landmarks import Landmarks
from ra_slam_tpu.slam.pnp import motion_only_gn

_HIGH = jax.lax.Precision.HIGHEST


class LoopCandidate(NamedTuple):
    cand: jax.Array  # int32 candidate keyframe slot (-1 = none)
    score: jax.Array  # float32 embedding similarity
    rel_pose: SE3  # query_T_cand (cam_i_T_cam_j with i=query)
    num_inliers: jax.Array  # int32 verified inliers
    rmse: jax.Array  # float32 inlier reprojection rmse (px)
    accepted: jax.Array  # bool


def retrieve_candidate(
    kfs: Keyframes,
    query_slot: jax.Array,
    kf_counter: jax.Array,
    min_gap: int = 30,
    min_score: float = 0.05,
) -> tuple[jax.Array, jax.Array]:
    """Best loop candidate for `query_slot` by embedding similarity.

    Temporal gating mirrors DBoW2 practice: keyframes within `min_gap`
    of the query (covisible neighborhood) are excluded. Returns
    (slot, score); slot = -1 when nothing clears `min_score`.
    """
    q = kfs.embed[query_slot]  # [256]
    scores = jnp.matmul(kfs.embed, q, precision=_HIGH)  # [K] retrieval op
    # cosine normalization: identical appearance -> 1.0 regardless of
    # per-keyframe descriptor count/diversity
    norms = jnp.linalg.norm(kfs.embed, axis=-1)
    scores = scores / jnp.maximum(norms * jnp.maximum(norms[query_slot], 1e-9), 1e-9)
    ok = (
        kfs.valid
        & (jnp.arange(kfs.capacity) < kf_counter)
        & (jnp.abs(jnp.arange(kfs.capacity) - query_slot) >= min_gap)
    )
    scores = jnp.where(ok, scores, -jnp.inf)
    best = jnp.argmax(scores).astype(jnp.int32)
    best_score = scores[best]
    found = best_score > min_score
    return jnp.where(found, best, -1), jnp.where(found, best_score, 0.0)


def verify_candidate(
    kfs: Keyframes,
    lms: Landmarks,
    query_slot: jax.Array,
    cand_slot: jax.Array,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_inliers: int = 25,
    iterations: int = 10,
    max_rmse: float = 2.0,
) -> LoopCandidate:
    """Geometric verification: match query->candidate descriptors, solve
    the query pose against the candidate's landmark positions (robust
    motion-only GN — the batched stand-in for PnP RANSAC), and accept on
    inlier count AND inlier reprojection rmse (a self-similar scene can
    buy inliers on a wrong candidate, but not a tight residual).
    All shapes static; call under jit."""
    safe_cand = jnp.maximum(cand_slot, 0)
    q_desc = kfs.desc[query_slot]
    q_w = kfs.obs_w[query_slot]
    q_uv = kfs.obs_uv[query_slot]
    c_desc = kfs.desc[safe_cand]
    c_w = kfs.obs_w[safe_cand]
    c_lm = kfs.obs_lm[safe_cand]

    matches = mutual_match(
        q_desc,
        q_w > 0,
        c_desc,
        (c_w > 0) & (c_lm >= 0),
        max_distance=tcfg.match_hamming_max,
        ratio=tcfg.match_ratio,
    )
    lm_idx = c_lm[matches.idx]  # [F] landmark of the matched candidate obs
    ok = matches.valid & (lm_idx >= 0) & lms.valid[jnp.maximum(lm_idx, 0)]
    pts = lms.pos[jnp.maximum(lm_idx, 0)]

    # seed from the candidate pose (drift-free side of the loop)
    seed = SE3(kfs.R[safe_cand], kfs.t[safe_cand])
    res = motion_only_gn(
        seed,
        pts,
        q_uv,
        ok.astype(jnp.float32),
        cam,
        iterations=iterations,
        huber_delta=tcfg.huber_delta,
    )

    cand_pose = SE3(kfs.R[safe_cand], kfs.t[safe_cand])
    rel = res.pose @ cand_pose.inverse()  # Z_qc = T_q_corrected · T_c^-1
    accepted = (
        (cand_slot >= 0)
        & (res.num_inliers >= min_inliers)
        & (res.rmse <= max_rmse)
    )
    return LoopCandidate(
        cand=cand_slot,
        score=jnp.float32(0.0),
        rel_pose=rel,
        num_inliers=res.num_inliers,
        rmse=res.rmse,
        accepted=accepted,
    )


class RelocResult(NamedTuple):
    pose: SE3  # recovered cam_T_world
    cand: jax.Array  # int32 keyframe the pose was recovered against
    score: jax.Array  # float32 retrieval similarity
    num_inliers: jax.Array  # int32
    accepted: jax.Array  # bool


def relocalize(
    kfs: Keyframes,
    lms: Landmarks,
    desc: jax.Array,  # [F, 8] uint32 query-frame descriptors
    valid: jax.Array,  # [F] bool
    uv: jax.Array,  # [F, 2] float32 query-frame pixels
    kf_counter: jax.Array,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_inliers: int = 20,
    iterations: int = 10,
    max_rmse: float = 3.0,
    min_score: float = 0.1,
) -> RelocResult:
    """Re-acquire the camera pose after tracking loss.

    The reference consumes OpenVSLAM's relocalizer through the tracking
    state of `feed_*_w_feedback` (`/root/reference/modules/slam_module.cc:154-160`).
    Native redesign: the lost frame is embedded exactly like a keyframe
    (mean ±1 descriptor), retrieved against the whole keyframe database
    with one matmul (no temporal gating — any keyframe may match),
    then verified by mutual descriptor matching + robust motion-only GN
    against the candidate's landmarks. Pure and jit-able.
    """
    pm1 = unpack_pm1(desc)  # [F, 256]
    w = valid.astype(jnp.float32)
    q = jnp.sum(pm1 * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    norms = jnp.linalg.norm(kfs.embed, axis=-1)
    qn = jnp.maximum(jnp.linalg.norm(q), 1e-9)
    scores = jnp.matmul(kfs.embed, q, precision=_HIGH) / jnp.maximum(
        norms * qn, 1e-9
    )
    ok = kfs.valid & (jnp.arange(kfs.capacity) < kf_counter)
    scores = jnp.where(ok, scores, -jnp.inf)
    cand = jnp.argmax(scores).astype(jnp.int32)

    c_desc = kfs.desc[cand]
    c_w = kfs.obs_w[cand]
    c_lm = kfs.obs_lm[cand]
    matches = mutual_match(
        desc,
        valid,
        c_desc,
        (c_w > 0) & (c_lm >= 0),
        max_distance=tcfg.match_hamming_max,
        ratio=tcfg.match_ratio,
    )
    lm_idx = c_lm[matches.idx]
    okm = matches.valid & (lm_idx >= 0) & lms.valid[jnp.maximum(lm_idx, 0)]
    pts = lms.pos[jnp.maximum(lm_idx, 0)]

    seed = SE3(kfs.R[cand], kfs.t[cand])
    res = motion_only_gn(
        seed,
        pts,
        uv,
        okm.astype(jnp.float32),
        cam,
        iterations=iterations,
        huber_delta=tcfg.huber_delta,
    )
    # rmse gate: a wrong keyframe on a self-similar scene can collect
    # `min_inliers` matches, but they do not form a tight reprojection
    accepted = (
        jnp.any(ok)
        & (res.num_inliers >= min_inliers)
        & (res.rmse <= max_rmse)
        & (scores[cand] >= min_score)
    )
    return RelocResult(
        pose=res.pose,
        cand=cand,
        score=scores[cand],
        num_inliers=res.num_inliers,
        accepted=accepted,
    )


def detect_loop(
    kfs: Keyframes,
    lms: Landmarks,
    query_slot: jax.Array,
    kf_counter: jax.Array,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_gap: int = 30,
    min_score: float = 0.05,
    min_inliers: int = 25,
    max_rmse: float = 2.0,
) -> LoopCandidate:
    """retrieve + verify in one jittable step."""
    cand, score = retrieve_candidate(kfs, query_slot, kf_counter, min_gap, min_score)
    out = verify_candidate(
        kfs, lms, query_slot, cand, cam, tcfg,
        min_inliers=min_inliers, max_rmse=max_rmse,
    )
    return out._replace(score=score, accepted=out.accepted & (cand >= 0))
