"""Local bundle adjustment: batched sparse Gauss-Newton with Schur trick.

The reference outsources local/global BA to g2o inside OpenVSLAM
(SURVEY.md §2.8; `/root/reference/INSTALL.md:36-38`). g2o is a
pointer-graph CPU solver — this formulation instead treats the whole
window as dense batched tensors with static shapes:

- All residuals/Jacobians for every (keyframe, feature-slot) observation
  are computed in one vmapped pass: ``r [N,2], J_pose [N,2,6],
  J_point [N,2,3]`` with per-observation robust weights.
- The landmark (3x3) diagonal of the normal equations is inverted in
  batch, and the pose-landmark coupling blocks are scattered into a
  dense ``[L, W, 6, 3]`` tensor so the reduced camera system
  ``S = H_pp - H_pl H_ll^-1 H_pl^T`` is a single einsum.
- The reduced ``[6W, 6W]`` system is solved densely (W is the local
  window, typically 4-16 keyframes) and landmark updates come from
  back-substitution.

Everything is fixed-iteration, fixed-shape, jit-able; the same machinery
runs per-shard under `shard_map` with a `psum` over the reduced camera
system for distributed BA (SURVEY.md §2.9).

Gauge freedom is fixed by a large diagonal prior on the oldest window
pose (and on any keyframe marked fixed), mirroring g2o's `set_fixed`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.se3 import SE3, exp_se3, log_se3
from ra_slam_tpu.slam.keyframes import Keyframes
from ra_slam_tpu.slam.landmarks import Landmarks

_HIGH = jax.lax.Precision.HIGHEST
_FIX_PRIOR = 1e8  # diagonal prior that pins a pose (g2o set_fixed analog)
_INT_MAX = jnp.iinfo(jnp.int32).max


class BAWindow(NamedTuple):
    """Compact static-shape view of the active BA problem."""

    kf_slot: jax.Array  # [W] int32 keyframe-db slot per window row
    kf_free: jax.Array  # [W] bool — pose is optimized (False = fixed/pad)
    poses: SE3  # [W] cam_T_world
    loc2glob: jax.Array  # [L] int32 global landmark id (INT_MAX = unused)
    points: jax.Array  # [L, 3] world positions
    point_ok: jax.Array  # [L] bool slot holds a real landmark
    obs_k: jax.Array  # [N] int32 window row of each observation
    obs_l: jax.Array  # [N] int32 local landmark index
    obs_uv: jax.Array  # [N, 2] float32
    obs_w: jax.Array  # [N] float32 (0 = invalid)
    obs_z: jax.Array  # [N] float32 measured depth (0 = none)
    # unique window landmarks that did NOT fit max_points: their
    # observations are dropped AND their positions stay stale while the
    # window poses move — a nonzero value here silently shears the map,
    # so it must be observable (repo principle: count, don't truncate)
    points_dropped: jax.Array  # int32


class BAStats(NamedTuple):
    num_poses: jax.Array
    num_points: jax.Array
    num_obs: jax.Array
    rmse_before: jax.Array
    rmse_after: jax.Array
    points_dropped: jax.Array  # unique landmarks beyond max_points


def gather_window(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter: jax.Array,
    window: int,
    max_points: int,
    start: jax.Array | None = None,
    n_fixed: int = 0,
) -> BAWindow:
    """Extract a `window` of keyframes + their landmarks (static shapes).

    Keyframe slots are insertion-ordered (slot == keyframe counter at
    insert time), so a window is a contiguous slot range. By default the
    newest `window` keyframes (local BA); pass `start` to window an
    arbitrary range (global-BA sweeps). The oldest row is marked fixed
    to anchor the gauge.

    `n_fixed` (local BA only) prepends that many older keyframes as
    pose-FIXED rows that still contribute their observations — the
    fixed-observer constraints of a proper local BA (OpenVSLAM keeps
    every keyframe observing a local landmark in the problem as a fixed
    vertex; SURVEY.md §2.8). Without them the landmark update fits only
    the newest (drifted) views, and the map drifts with the odometry —
    measured on the orbit benchmark this tripled ATE (0.072 -> 0.297 m)
    and destabilized post-keyframe tracking.
    """
    W, L = window + n_fixed, max_points
    F = kfs.num_features
    if start is None:
        free_start = jnp.maximum(kf_counter - window, 0)
        start = jnp.maximum(free_start - n_fixed, 0)
    else:
        free_start = start + 1  # GBA chunk: oldest row anchors
    slot = start + jnp.arange(W, dtype=jnp.int32)
    kf_ok = slot < kf_counter
    slot_c = jnp.minimum(slot, kfs.capacity - 1)

    poses = SE3(kfs.R[slot_c], kfs.t[slot_c])
    # fixed observers + keyframe 0 anchor the gauge; padding never free
    kf_free = kf_ok & (slot >= free_start) & (slot > 0)

    # --- local landmark set: sorted-unique of the window's observed ids
    gid = jnp.where(kf_ok[:, None], kfs.obs_lm[slot_c], -1).reshape(-1)  # [W*F]
    w_obs = jnp.where(kf_ok[:, None], kfs.obs_w[slot_c], 0.0).reshape(-1)
    gid = jnp.where((gid >= 0) & (w_obs > 0), gid, _INT_MAX)
    sorted_gid = jnp.sort(gid)
    is_first = jnp.concatenate(
        [jnp.array([True]), sorted_gid[1:] != sorted_gid[:-1]]
    ) & (sorted_gid < _INT_MAX)
    rank = jnp.cumsum(is_first.astype(jnp.int32)) - 1  # unique rank
    n_unique = jnp.sum(is_first.astype(jnp.int32))
    # over capacity: keep the NEWEST L landmarks (highest ids). Landmark
    # ids are allocation-ordered, so the newest are the ones the tracker
    # is actively matching — dropping those (the old keep-lowest rule)
    # left them stale while BA moved the window poses, shearing pose
    # against the live local map: measured on the orbit bench, the frame
    # after every keyframe spiked to 3.3-4.0 px track rmse (gate: 3.0)
    # the moment the window's landmark union first exceeded max_points,
    # costing a fake lost+reloc cycle every keyframe.
    shift = jnp.maximum(n_unique - L, 0)
    rank = rank - shift
    points_dropped = shift
    dest = jnp.where(is_first & (rank >= 0) & (rank < L), rank, L)
    loc2glob = jnp.full((L,), _INT_MAX, jnp.int32)
    loc2glob = loc2glob.at[dest].set(sorted_gid, mode="drop")
    point_ok = loc2glob < _INT_MAX

    glob_c = jnp.minimum(loc2glob, lms.capacity - 1)
    points = lms.pos[glob_c]
    point_ok = point_ok & lms.valid[glob_c]

    # --- flat observations with local landmark indices (binary search)
    obs_gid = jnp.where(kf_ok[:, None], kfs.obs_lm[slot_c], -1).reshape(-1)
    obs_l = jnp.searchsorted(loc2glob, jnp.maximum(obs_gid, 0)).astype(jnp.int32)
    obs_l = jnp.minimum(obs_l, L - 1)
    hit = (obs_gid >= 0) & (loc2glob[obs_l] == obs_gid) & point_ok[obs_l]
    obs_k = jnp.repeat(jnp.arange(W, dtype=jnp.int32), F)
    obs_uv = kfs.obs_uv[slot_c].reshape(-1, 2)
    obs_w = jnp.where(hit, w_obs, 0.0)
    obs_z = kfs.obs_z[slot_c].reshape(-1)

    return BAWindow(
        kf_slot=slot_c,
        kf_free=kf_free,
        poses=poses,
        loc2glob=loc2glob,
        points=points,
        point_ok=point_ok,
        obs_k=obs_k,
        obs_l=obs_l,
        obs_uv=obs_uv,
        obs_w=obs_w,
        obs_z=obs_z,
        points_dropped=points_dropped,
    )


def _robust_weight(r2: jax.Array, delta: float) -> jax.Array:
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def clamp_twist(dxi: jax.Array, max_r: float = 0.5, max_t: float = 0.5):
    """Trust-region step clamp on [..., 6] twists [w, v].

    The solvers run fixed-damping GN (no LM lambda adaptation); a
    near-singular window or a batch of inconsistent observations can
    otherwise produce an unbounded step that detonates the keyframe DB
    (g2o's adaptive lambda plays this role in the reference's backend)."""
    r, t = dxi[..., :3], dxi[..., 3:]
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    tn = jnp.linalg.norm(t, axis=-1, keepdims=True)
    r = r * jnp.minimum(1.0, max_r / jnp.maximum(rn, 1e-9))
    t = t * jnp.minimum(1.0, max_t / jnp.maximum(tn, 1e-9))
    return jnp.concatenate([r, t], axis=-1)


_DEPTH_SIGMA = 0.01  # relative depth noise: sigma_z = _DEPTH_SIGMA * z


def _residuals(
    poses: SE3, points: jax.Array, win: BAWindow, cam: PinholeCamera
):
    """Flat RGB-D residuals + Jacobians for every observation.

    Rows are [r_u, r_v, r_d]: 2D reprojection (px) plus the measured-
    depth residual normalized to pixel-comparable sigma,
    ``r_d = (z_pred - z_meas) / (_DEPTH_SIGMA * z_meas)`` — OpenVSLAM's
    RGB-D/stereo constraint (SURVEY.md §2.8). Observations without
    depth get a zero row (not zero weight — the 2D rows still count).

    Returns r [N,3], J_p [N,3,6] (wrt left-mult pose twist), J_x [N,3,3]
    (wrt world point), ok [N].
    """
    pose_n = jax.tree.map(lambda a: a[win.obs_k], poses)  # [N] SE3
    pts_n = points[win.obs_l]  # [N, 3]
    p = pose_n.apply(pts_n)  # [N, 3] camera frame
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = z > 1e-6
    zs = jnp.where(ok, z, 1.0)
    inv_z = 1.0 / zs
    u = x * inv_z * cam.fx + cam.cx
    v = y * inv_z * cam.fy + cam.cy
    has_z = (win.obs_z > 1e-6).astype(p.dtype)
    zm = jnp.where(win.obs_z > 1e-6, win.obs_z, 1.0)
    dscale = has_z / (_DEPTH_SIGMA * zm)
    r = jnp.stack(
        [
            u - win.obs_uv[..., 0],
            v - win.obs_uv[..., 1],
            (zs - zm) * dscale,
        ],
        axis=-1,
    )  # [N, 3]

    fx, fy = cam.fx, cam.fy
    zero = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
            jnp.stack([zero, zero, dscale], -1),
        ],
        -2,
    )  # [N, 3, 3] d(residual)/d(p_cam)

    # dp/dxi for left-multiplied exp(xi) T: dp = -[p]x w + v
    px = jnp.stack(
        [
            jnp.stack([zero, z, -y], -1),
            jnp.stack([-z, zero, x], -1),
            jnp.stack([y, -x, zero], -1),
        ],
        -2,
    )  # [N, 3, 3] = -[p]_x
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), px.shape)
    J_pxi = jnp.concatenate([px, eye], axis=-1)  # [N, 3, 6]
    J_p = jnp.matmul(J_proj, J_pxi, precision=_HIGH)  # [N, 3, 6]
    # dp/dX = R (camera-point wrt world-point)
    J_x = jnp.matmul(J_proj, pose_n.R, precision=_HIGH)  # [N, 3, 3]
    return r, J_p, J_x, ok


def _weighted_rmse(r: jax.Array, w: jax.Array) -> jax.Array:
    r2 = jnp.sum(r * r, -1)
    n = jnp.maximum(jnp.sum((w > 0).astype(r2.dtype)), 1.0)
    return jnp.sqrt(jnp.sum(jnp.where(w > 0, r2, 0.0)) / n)


def solve_window(
    win: BAWindow,
    cam: PinholeCamera,
    iterations: int = 8,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
    chi2_prune: float = 36.0,  # px^2; observations beyond are REMOVED
    pose_prior: float = 2e3,  # odometry prior toward the pre-BA pose
) -> Tuple[SE3, jax.Array, BAStats]:
    """Run Schur-complement GN on a gathered window.

    Two-phase like OpenVSLAM's local BA (optimize → remove chi2
    outliers → re-optimize): Huber only *down-weights* a wrong data
    association, so a population of mis-bound observations (descriptor
    aliasing through the fusion gate) still drags the compromise —
    measured on the orbit bench the converged window rmse crept from
    0.5 px to 1.8-2.1 px and every post-keyframe frame tracked 0.1-0.2 m
    off the landmark map. After the first half of the iterations, any
    observation with squared residual above `chi2_prune` is zeroed out
    of the problem for the second half.

    Returns (optimized poses [W], optimized points [L, 3], stats).
    """
    W = win.kf_free.shape[0]
    L = win.points.shape[0]

    def make_iteration(obs_w):
      def iteration(_, carry):
        poses, points = carry
        r, J_p, J_x, ok = _residuals(poses, points, win, cam)
        r2 = jnp.sum(r * r, -1)
        w = obs_w * ok * _robust_weight(r2, huber_delta)  # [N]

        # zero the pose Jacobian of fixed rows so their update is exactly 0
        free_n = win.kf_free[win.obs_k]
        J_p_f = J_p * free_n[:, None, None]

        Jw_p = J_p_f * w[:, None, None]
        Jw_x = J_x * w[:, None, None]

        # block-diagonal pose and landmark Hessians + gradients
        Hpp = jax.ops.segment_sum(
            jnp.einsum("nri,nrj->nij", Jw_p, J_p_f, precision=_HIGH),
            win.obs_k, num_segments=W)  # [W, 6, 6]
        gp = jax.ops.segment_sum(
            jnp.einsum("nri,nr->ni", Jw_p, r, precision=_HIGH),
            win.obs_k, num_segments=W)  # [W, 6]
        Hll = jax.ops.segment_sum(
            jnp.einsum("nri,nrj->nij", Jw_x, J_x, precision=_HIGH),
            win.obs_l, num_segments=L)  # [L, 3, 3]
        gl = jax.ops.segment_sum(
            jnp.einsum("nri,nr->ni", Jw_x, r, precision=_HIGH),
            win.obs_l, num_segments=L)  # [L, 3]

        # pose-landmark coupling blocks, scattered dense: U[l, k] = H_pl^T
        A = jnp.einsum("nri,nrj->nij", Jw_p, J_x, precision=_HIGH)  # [N,6,3]
        U = jnp.zeros((L, W, 6, 3), A.dtype).at[win.obs_l, win.obs_k].add(A)

        # damped landmark-block inverse (Levenberg diagonal)
        eye3 = jnp.eye(3, dtype=Hll.dtype)
        Hll_d = Hll + (damping + 1e-8) * eye3 + damping * Hll * eye3
        # guard empty landmark slots (singular blocks)
        occupied = win.point_ok & (jnp.einsum("lii->l", Hll) > 1e-12)
        with jax.default_matmul_precision("highest"):
            # default-precision f32 linalg may run its matmuls in
            # reduced precision — keep the factorizations exact
            Hinv = jnp.linalg.inv(
                jnp.where(occupied[:, None, None], Hll_d, eye3)
            )
        Hinv = jnp.where(occupied[:, None, None], Hinv, 0.0)

        # reduced camera system S = Hpp - U^T Hinv U  (one einsum)
        S_off = jnp.einsum(
            "lkab,lbc,ljdc->kajd", U, Hinv, U, precision=_HIGH
        )  # [W, 6, W, 6]
        S = -S_off
        diag = jnp.arange(W)
        S = S.at[diag, :, diag, :].add(Hpp)
        # gauge + padding prior, plus LM damping on the pose blocks,
        # plus a weak ABSOLUTE prior toward each free pose's pre-BA
        # estimate. The newest keyframes' landmarks are often observed
        # by no fixed-observer row (the camera moved on), so that
        # sub-block's gauge is otherwise pinned only by step damping
        # and can slide coherently several cm per solve (measured:
        # ~2-4 cm of systematic per-keyframe drift injection on the
        # orbit bench). The per-frame depth-anchored odometry that
        # produced the estimate is good to ~mm, so trusting it softly
        # pins exactly the null-space modes.
        prior = jnp.where(win.kf_free, damping + pose_prior, _FIX_PRIOR)
        S = S.at[diag, :, diag, :].add(
            prior[:, None, None] * jnp.eye(6, dtype=S.dtype)
        )
        # prior residual: deviation from the pre-BA pose accumulated so
        # far (zero at the first iteration)
        dev = jax.vmap(lambda a, b: log_se3(a @ b.inverse()))(
            poses, win.poses
        )  # [W, 6]
        rhs = gp - jnp.einsum(
            "lkab,lbc,lc->ka", U, Hinv, gl, precision=_HIGH
        ) + pose_prior * dev * win.kf_free[:, None]  # [W, 6]

        with jax.default_matmul_precision("highest"):
            dxi = -jnp.linalg.solve(
                S.reshape(W * 6, W * 6), rhs.reshape(W * 6)
            ).reshape(W, 6)
        dxi = jnp.where(jnp.all(jnp.isfinite(dxi)), dxi, jnp.zeros_like(dxi))
        dxi = clamp_twist(dxi) * win.kf_free[:, None]

        # back-substitute landmark updates: dl = -Hinv (gl + U dxi)
        Ud = jnp.einsum("lkab,ka->lb", U, dxi, precision=_HIGH)  # [L, 3]
        dx = -jnp.einsum("lab,lb->la", Hinv, gl + Ud, precision=_HIGH)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        dxn = jnp.linalg.norm(dx, axis=-1, keepdims=True)
        dx = dx * jnp.minimum(1.0, 0.5 / jnp.maximum(dxn, 1e-9))
        dx = dx * occupied[:, None]

        return exp_se3(dxi) @ poses, points + dx

      return iteration

    r0, _, _, ok0 = _residuals(win.poses, win.points, win, cam)
    rmse0 = _weighted_rmse(r0, win.obs_w * ok0)

    n1 = max(iterations // 2, 1)
    poses, points = jax.lax.fori_loop(
        0, n1, make_iteration(win.obs_w), (win.poses, win.points),
        unroll=True,
    )
    # chi2 outlier removal between phases (g2o two-stage optimize)
    rp, _, _, okp = _residuals(poses, points, win, cam)
    obs_w2 = jnp.where(
        okp & (jnp.sum(rp * rp, -1) <= chi2_prune), win.obs_w, 0.0
    )
    poses, points = jax.lax.fori_loop(
        0, max(iterations - n1, 0), make_iteration(obs_w2),
        (poses, points), unroll=True,
    )

    r1, _, _, ok1 = _residuals(poses, points, win, cam)
    rmse1 = _weighted_rmse(r1, obs_w2 * ok1)

    stats = BAStats(
        num_poses=jnp.sum(win.kf_free.astype(jnp.int32)),
        num_points=jnp.sum(win.point_ok.astype(jnp.int32)),
        num_obs=jnp.sum((win.obs_w > 0).astype(jnp.int32)),
        rmse_before=rmse0,
        rmse_after=rmse1,
        points_dropped=win.points_dropped,
    )
    return poses, points, stats


def scatter_window(
    kfs: Keyframes,
    lms: Landmarks,
    win: BAWindow,
    poses: SE3,
    points: jax.Array,
) -> Tuple[Keyframes, Landmarks]:
    """Write optimized poses/points back into the keyframe/landmark DBs."""
    # fixed rows keep their pose values anyway; write-through is harmless
    kfs = kfs._replace(
        R=kfs.R.at[win.kf_slot].set(poses.R, mode="drop"),
        t=kfs.t.at[win.kf_slot].set(poses.t, mode="drop"),
    )
    gidx = jnp.where(win.point_ok, win.loc2glob, lms.capacity)
    lms = lms._replace(pos=lms.pos.at[gidx].set(points, mode="drop"))
    return kfs, lms


def global_bundle_adjustment(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter: jax.Array,
    cam: PinholeCamera,
    window: int = 16,
    stride: int | None = None,
    max_points: int = 4096,
    iterations: int = 4,
    sweeps: int = 2,
    huber_delta: float = 3.0,
    pose_prior: float = 2e3,
) -> Tuple[Keyframes, Landmarks, BAStats]:
    """Map-wide structure+pose refinement (the reference's background
    global BA, provided there by g2o inside OpenVSLAM — SURVEY.md §2.8).

    A single dense Schur solve over *all* keyframes would need a
    [L, K, 6, 3] coupling tensor (gigabytes at full capacity), so the
    formulation here is overlapping block-Gauss-Seidel sweeps: slide a
    `window`-keyframe Schur solve over the whole insertion-ordered
    range with 50% overlap, each window anchored on its oldest pose
    (already refined by the previous, overlapping window), repeated
    `sweeps` times. Corrections — e.g. from a pose-graph loop update —
    propagate map-wide while every solve stays at the fixed local-BA
    shape. Fully jit-able: the chunk loop is a `fori_loop` with a
    dynamic trip count derived from `kf_counter`.
    """
    stride_ = stride if stride is not None else max(window // 2, 1)
    last_start = jnp.maximum(kf_counter - window, 0)
    # ceil division: when last_start is not a stride multiple the extra
    # chunk lands exactly on last_start (the min() below clamps it), so
    # the newest keyframes are always covered by a window
    n_chunks = (last_start + stride_ - 1) // stride_ + 1  # dynamic; >= 1

    def chunk_step(c, carry):
        kfs_c, lms_c, sq, n = carry
        start = jnp.minimum(c * stride_, last_start)
        win = gather_window(
            kfs_c, lms_c, kf_counter, window, max_points, start=start
        )
        poses, points, st = solve_window(
            win, cam, iterations=iterations, huber_delta=huber_delta,
            pose_prior=pose_prior,
        )
        kfs_c, lms_c = scatter_window(kfs_c, lms_c, win, poses, points)
        nf = st.num_obs.astype(jnp.float32)
        return (
            kfs_c, lms_c,
            sq + jnp.stack([st.rmse_before**2, st.rmse_after**2]) * nf,
            n + nf,
        )

    def sweep(_, carry):
        return jax.lax.fori_loop(0, n_chunks, chunk_step, carry)

    zero = jnp.zeros(2, jnp.float32)
    kfs, lms, sq, n = jax.lax.fori_loop(
        0, sweeps, sweep, (kfs, lms, zero, jnp.float32(0.0))
    )
    # aggregate over all chunk solves (overlap double-counts some
    # observations; fine for a monitoring stat)
    rmse = jnp.sqrt(sq / jnp.maximum(n, 1.0))
    stats = BAStats(
        num_poses=jnp.minimum(kf_counter, kfs.capacity),
        num_points=jnp.int32(0),
        num_obs=(n / jnp.float32(sweeps)).astype(jnp.int32),
        rmse_before=rmse[0],
        rmse_after=rmse[1],
        points_dropped=jnp.int32(0),
    )
    return kfs, lms, stats


def local_bundle_adjustment(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter: jax.Array,
    cam: PinholeCamera,
    window: int = 8,
    max_points: int = 4096,
    iterations: int = 8,
    huber_delta: float = 3.0,
    n_fixed: int = 4,
    pose_prior: float = 2e3,
) -> Tuple[Keyframes, Landmarks, BAStats]:
    """Gather → solve → scatter: the full local BA step (jit-able)."""
    win = gather_window(
        kfs, lms, kf_counter, window, max_points, n_fixed=n_fixed
    )
    poses, points, stats = solve_window(
        win, cam, iterations=iterations, huber_delta=huber_delta,
        pose_prior=pose_prior,
    )
    kfs, lms = scatter_window(kfs, lms, win, poses, points)
    return kfs, lms, stats
