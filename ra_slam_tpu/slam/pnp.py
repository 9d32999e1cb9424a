"""Motion-only pose estimation: batched Gauss-Newton on SE(3).

The reference delegates this to OpenVSLAM's motion-only bundle
adjustment (g2o, SURVEY.md §2.8). Batched formulation: residuals and
analytic Jacobians for ALL correspondences are computed in one vmapped
pass ([N, 2] residuals, [N, 2, 6] Jacobians), the 6x6 normal equations
assembled with einsum, and the update applied with the SE(3) exp
map — fixed iteration count under `lax.fori_loop`, no data-dependent
control flow.

Convention: pose is cam_T_world; the update is left-multiplicative,
T <- exp(dxi) @ T, with twist [w, v] (rotation first) matching
`core.se3.exp_se3`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.se3 import SE3, exp_se3

_HIGH = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    pose: SE3  # refined cam_T_world
    inliers: jax.Array  # [N] bool final chi2 inlier mask
    num_inliers: jax.Array  # int32
    rmse: jax.Array  # float32 reprojection RMSE over inliers (px)


def reprojection_residuals(
    pose: SE3,
    pts_world: jax.Array,  # [N, 3]
    uv_obs: jax.Array,  # [N, 2]
    cam: PinholeCamera,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Residuals [N, 2] = proj(T x) - uv, Jacobians [N, 2, 6] wrt the
    left-multiplicative twist [w, v], and a validity mask (z > eps)."""
    p = pose.apply(pts_world)  # [N, 3] camera frame
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = z > 1e-6
    zs = jnp.where(ok, z, 1.0)
    inv_z = 1.0 / zs
    u = x * inv_z * cam.fx + cam.cx
    v = y * inv_z * cam.fy + cam.cy
    r = jnp.stack([u, v], -1) - uv_obs  # [N, 2]

    # d(uv)/dp
    fx, fy = cam.fx, cam.fy
    zero = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
        ],
        -2,
    )  # [N, 2, 3]

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
    J_p = jnp.concatenate([px, eye], axis=-1)  # [N, 3, 6]
    J = jnp.matmul(J_proj, J_p, precision=_HIGH)  # [N, 2, 6]
    return r, J, ok


def _huber_weight(r2: jax.Array, delta: float) -> jax.Array:
    """IRLS weight for the Huber loss on squared residual norm r2."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def _depth_residuals(
    pose: SE3,
    pts_world: jax.Array,  # [N, 3]
    d_obs: jax.Array,  # [N] measured depth (m), <=0 = none
    cam: PinholeCamera,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pixel-scaled depth residual r_z = fx·(z - d)/z and its [N, 6]
    twist Jacobian.

    The RGB-D analog of ORB-SLAM2's virtual right-camera coordinate:
    expressing the metric depth error in pixel units (÷z·fx) lets one
    Huber/chi2 scale govern both residual types. The reference feeds
    depth to OpenVSLAM's `track_RGBD_image`
    (`/root/reference/modules/slam_module.cc:133`), whose g2o edges do
    the same via the stereo u_r formulation.
    """
    p = pose.apply(pts_world)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = (z > 1e-6) & (d_obs > 0)
    zs = jnp.where(z > 1e-6, z, 1.0)
    r = cam.fx * (zs - d_obs) / zs  # fx·(1 - d/z)
    # dz/dxi for left-multiplied exp(xi) T: row z of [-[p]x | I]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    dz = jnp.stack([y, -x, zero, zero, zero, one], -1)  # [N, 6]
    J = (cam.fx * d_obs / (zs * zs))[:, None] * dz
    return r, J, ok


def motion_only_gn(
    pose0: SE3,
    pts_world: jax.Array,  # [N, 3]
    uv_obs: jax.Array,  # [N, 2]
    weights: jax.Array,  # [N] per-point weight (0 = ignore)
    cam: PinholeCamera,
    iterations: int = 10,
    huber_delta: float = 5.0,
    chi2_inlier: float = 5.991,  # 95% chi2(2) in pixels^2 (per unit sigma)
    damping: float = 1e-6,
    depth_obs: jax.Array | None = None,  # [N] measured depth (m), <=0 none
    depth_weight: float = 0.5,  # relative weight of the depth residual
) -> PnPResult:
    """Gauss-Newton pose refinement over fixed iterations.

    `weights` masks invalid correspondences and can encode per-level
    measurement sigmas (OpenVSLAM weighs by pyramid level). With
    `depth_obs`, each point with measured depth also contributes a
    pixel-scaled depth residual — absolute scale observability every
    frame, which breaks the tangential pose/landmark aliasing a pure
    reprojection solve tolerates on self-similar texture.
    """

    def body(_, pose: SE3) -> SE3:
        r, J, ok = reprojection_residuals(pose, pts_world, uv_obs, cam)
        r2 = jnp.sum(r * r, -1)
        w = weights * ok * _huber_weight(r2, huber_delta)  # [N]
        Jw = J * w[:, None, None]
        H = jnp.einsum("nri,nrj->ij", Jw, J, precision=_HIGH)
        g = jnp.einsum("nri,nr->i", Jw, r, precision=_HIGH)
        if depth_obs is not None:
            rz, Jz, okz = _depth_residuals(pose, pts_world, depth_obs, cam)
            wz = (
                depth_weight * weights * okz
                * _huber_weight(rz * rz, huber_delta)
            )
            Jzw = Jz * wz[:, None]
            H = H + jnp.einsum("ni,nj->ij", Jzw, Jz, precision=_HIGH)
            g = g + jnp.einsum("ni,n->i", Jzw, rz, precision=_HIGH)
        H = H + damping * jnp.eye(6, dtype=H.dtype)
        with jax.default_matmul_precision("highest"):
            # default-precision f32 linalg may use reduced-precision
            # matmuls; keep the 6x6 exact
            dxi = -jnp.linalg.solve(H, g)
        # guard: bad conditioning -> no update
        dxi = jnp.where(jnp.all(jnp.isfinite(dxi)), dxi, jnp.zeros_like(dxi))
        return exp_se3(dxi) @ pose

    # NOTE: unrolled on purpose — measured on jax 0.9, lowering
    # this as a rolled while-loop under the fused step's lax.cond tree
    # ballooned compile time from ~145 s to >9 min; straight-line code
    # compiles far faster here.
    pose = jax.lax.fori_loop(0, iterations, body, pose0, unroll=True)

    r, _, ok = reprojection_residuals(pose, pts_world, uv_obs, cam)
    r2 = jnp.sum(r * r, -1)
    inl = (weights > 0) & ok & (r2 < chi2_inlier * huber_delta)
    n_inl = jnp.sum(inl.astype(jnp.int32))
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(inl, r2, 0.0)) / jnp.maximum(n_inl.astype(r2.dtype), 1.0)
    )
    return PnPResult(pose=pose, inliers=inl, num_inliers=n_inl, rmse=rmse)
