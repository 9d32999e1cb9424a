"""SE(3) pose-graph optimization.

The reference delegates pose-graph optimization and post-loop map
correction to OpenVSLAM's g2o backend (SURVEY.md §2.8; consumed through
`openvslam::system`, `/root/reference/modules/slam_module.h:20`). This
is the equivalent here: a batched Gauss-Newton solver over
relative-pose edges with

  residual_e = log_se3( Z_ij^-1 · (T_i · T_j^-1) )      (cam_T_world T)

Per-edge 6x6 Jacobians come from forward-mode AD of the left-perturbed
residual (exact at the linearization point, vmapped over all edges —
the batch formulation), the normal system is
assembled with scatter-adds into a dense [6K, 6K] matrix, gauge is
fixed with a strong prior on node 0, and the solve is one dense
Cholesky — for the keyframe counts of this system (<= a few hundred)
dense beats block-sparse bookkeeping (SURVEY.md §7.3).

Landmark correction after optimization mirrors OpenVSLAM's loop
correction: each map point moves with its anchor keyframe,
p' = T_new^-1 · T_old · p.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.se3 import SE3, exp_se3, log_se3
from ra_slam_tpu.slam.keyframes import Keyframes
from ra_slam_tpu.slam.landmarks import Landmarks

_HIGH = jax.lax.Precision.HIGHEST


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity relative-pose constraint set (a pytree)."""

    i: jax.Array  # [E] int32 source keyframe slot
    j: jax.Array  # [E] int32 target keyframe slot
    R: jax.Array  # [E, 3, 3] measured Z_ij = Ti · Tj^-1 rotation
    t: jax.Array  # [E, 3]
    weight: jax.Array  # [E] float32 information scale (0 = empty slot)

    @property
    def capacity(self) -> int:
        return self.i.shape[0]


def create_edges(capacity: int) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=jnp.zeros((capacity,), jnp.int32),
        j=jnp.zeros((capacity,), jnp.int32),
        R=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (capacity, 3, 3)),
        t=jnp.zeros((capacity, 3), jnp.float32),
        weight=jnp.zeros((capacity,), jnp.float32),
    )


def add_edge(
    edges: PoseGraphEdges,
    slot: jax.Array,
    i: jax.Array,
    j: jax.Array,
    z_ij: SE3,
    weight=1.0,
) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=edges.i.at[slot].set(jnp.int32(i)),
        j=edges.j.at[slot].set(jnp.int32(j)),
        R=edges.R.at[slot].set(z_ij.R),
        t=edges.t.at[slot].set(z_ij.t),
        weight=edges.weight.at[slot].set(jnp.float32(weight)),
    )


def odometry_edge(pose_i: SE3, pose_j: SE3) -> SE3:
    """Measurement from current estimates: Z_ij = T_i · T_j^-1."""
    return pose_i @ pose_j.inverse()


def _edge_residual(
    xi_i: jax.Array, xi_j: jax.Array, Ti: SE3, Tj: SE3, Zinv: SE3
) -> jax.Array:
    Ti_p = exp_se3(xi_i) @ Ti
    Tj_p = exp_se3(xi_j) @ Tj
    return log_se3(Zinv @ (Ti_p @ Tj_p.inverse()))


def _edge_lin(Ti: SE3, Tj: SE3, Z: SE3):
    """(r, J_i, J_j) at the current linearization point."""
    zero = jnp.zeros((6,), jnp.float32)
    Zinv = Z.inverse()
    r = _edge_residual(zero, zero, Ti, Tj, Zinv)
    Ji = jax.jacfwd(_edge_residual, argnums=0)(zero, zero, Ti, Tj, Zinv)
    Jj = jax.jacfwd(_edge_residual, argnums=1)(zero, zero, Ti, Tj, Zinv)
    return r, Ji, Jj


class PoseGraphStats(NamedTuple):
    rmse_before: jax.Array
    rmse_after: jax.Array


def optimize_pose_graph(
    kfs: Keyframes,
    edges: PoseGraphEdges,
    kf_counter: jax.Array,
    max_nodes: int,
    iterations: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e6,
) -> Tuple[Keyframes, PoseGraphStats]:
    """Optimize keyframe poses 0..kf_counter-1 over all weighted edges.

    `max_nodes` is the static node capacity (= kfs.capacity normally);
    nodes >= kf_counter are frozen by a unit prior so shapes stay static.
    """
    K = max_nodes
    node_active = (jnp.arange(K) < kf_counter) & kfs.valid[:K]

    def solve_once(R, t):
      # f32 linalg (Cholesky / triangular solve) lowers to blocked
      # matmuls that may default to reduced precision (one bf16 pass, or
      # TF32) — with the 1e6 gauge prior the [6K, 6K] solve then loses
      # the entire correction signal (loop closures applied ~zero
      # shift). Force true f32 accumulation.
      with jax.default_matmul_precision("highest"):
          Ti = SE3(R[edges.i], t[edges.i])
          Tj = SE3(R[edges.j], t[edges.j])
          Z = SE3(edges.R, edges.t)
          r, Ji, Jj = jax.vmap(_edge_lin)(Ti, Tj, Z)  # [E,6],[E,6,6],[E,6,6]

          # edge validity: weight > 0, both endpoints active
          w = edges.weight * node_active[edges.i] * node_active[edges.j]
          rw = r * w[:, None]

          # assemble dense H [6K, 6K], g [6K] with scatter-adds
          Hii = jnp.einsum("eri,erj->eij", Ji * w[:, None, None], Ji, precision=_HIGH)
          Hjj = jnp.einsum("eri,erj->eij", Jj * w[:, None, None], Jj, precision=_HIGH)
          Hij = jnp.einsum("eri,erj->eij", Ji * w[:, None, None], Jj, precision=_HIGH)
          gi = jnp.einsum("eri,er->ei", Ji, rw, precision=_HIGH)
          gj = jnp.einsum("eri,er->ei", Jj, rw, precision=_HIGH)

          Hb = jnp.zeros((K, K, 6, 6), jnp.float32)
          Hb = Hb.at[edges.i, edges.i].add(Hii)
          Hb = Hb.at[edges.j, edges.j].add(Hjj)
          Hb = Hb.at[edges.i, edges.j].add(Hij)
          Hb = Hb.at[edges.j, edges.i].add(jnp.swapaxes(Hij, -1, -2))
          g = jnp.zeros((K, 6), jnp.float32)
          g = g.at[edges.i].add(gi)
          g = g.at[edges.j].add(gj)

          # gauge prior on node 0; freeze inactive nodes
          prior = jnp.where(
              jnp.arange(K) == 0, gauge_weight, jnp.where(node_active, 0.0, 1.0)
          )
          eye6 = jnp.eye(6, dtype=jnp.float32)
          Hb = Hb + (prior[:, None, None, None] + damping) * eye6[None, None] * (
              jnp.eye(K, dtype=jnp.float32)[:, :, None, None]
          )

          H = jnp.transpose(Hb, (0, 2, 1, 3)).reshape(6 * K, 6 * K)
          gflat = g.reshape(6 * K)
          dxi = -jax.scipy.linalg.solve(H, gflat, assume_a="pos").reshape(K, 6)
          dxi = jnp.where(jnp.isfinite(dxi), dxi, 0.0)
          dxi = jnp.where(node_active[:, None], dxi, 0.0)

          upd = jax.vmap(exp_se3)(dxi)
          new = jax.vmap(lambda u, Rk, tk: u @ SE3(Rk, tk))(upd, R, t)
          chi2 = jnp.sum(rw * r)
          nact = jnp.maximum(jnp.sum(w > 0), 1)
          return new.R, new.t, jnp.sqrt(chi2 / nact.astype(jnp.float32))

    R0, t0 = kfs.R[:K], kfs.t[:K]
    _, _, rmse_before = solve_once(R0, t0)

    def body(_, carry):
        R, t = carry
        Rn, tn, _ = solve_once(R, t)
        return Rn, tn

    R, t = jax.lax.fori_loop(0, iterations, body, (R0, t0))
    _, _, rmse_after = solve_once(R, t)

    kfs_out = kfs._replace(
        R=kfs.R.at[:K].set(R),
        t=kfs.t.at[:K].set(t),
    )
    return kfs_out, PoseGraphStats(rmse_before=rmse_before, rmse_after=rmse_after)


def correct_landmarks(
    lms: Landmarks,
    old_kfs_R: jax.Array,
    old_kfs_t: jax.Array,
    new_kfs: Keyframes,
) -> Landmarks:
    """Move every landmark with its REFERENCE (creation) keyframe:
    p' = T_new^-1 · (T_old · p) — OpenVSLAM's loop-correction rule.

    The anchor must be the creation keyframe, not last_seen: a landmark
    created before the drift and re-observed during the revisit already
    agrees with the early map, and dragging it with the revisit
    keyframe's large correction shears the map into inconsistent sheets
    (measured: post-loop GBA rmse 10871 px with last_seen anchors)."""
    anchor = jnp.clip(lms.anchor, 0, new_kfs.capacity - 1)
    T_old = SE3(old_kfs_R[anchor], old_kfs_t[anchor])
    T_new = SE3(new_kfs.R[anchor], new_kfs.t[anchor])
    p_cam = jax.vmap(lambda T, p: T.apply(p))(T_old, lms.pos)
    p_new = jax.vmap(lambda T, p: T.inverse().apply(p))(T_new, p_cam)
    return lms._replace(pos=jnp.where(lms.valid[:, None], p_new, lms.pos))
