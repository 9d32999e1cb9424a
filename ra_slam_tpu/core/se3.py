"""SE(3)/SO(3) rigid-body transforms as JAX pytrees.

Capability parity with the reference's device-side pose type
(`/root/reference/utils/cuda/lie_group.cuh:8-45`, a quaternion+translation
struct with Inverse/Apply/compose), extended with the exp/log maps needed
by the native tracking and bundle-adjustment solvers (the reference
outsources those to OpenVSLAM/g2o).

Representation: rotation matrix ``R`` ([..., 3, 3]) + translation ``t``
([..., 3]). Matrices compose/apply via matmul (trivially batchable); quaternion helpers are provided for compact storage and
interpolation (pose buffer, `/root/reference/utils/rotation_math/pose_manager.cc`).

Conventions: ``T = SE3(R, t)`` maps points ``x_world -> R @ x + t``. For a
camera pose stored as ``cam_T_world`` (the reference's convention,
`/root/reference/modules/slam_module.cc:55`), ``apply`` takes world points
to camera points.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Small 3x3 geometry matmuls must stay exact float32: at default
# precision an accelerator may multiply float32 in bf16 passes or TF32
# (~1e-3 relative error or worse), which is fatal for pose chains.
# Negligible cost at these shapes.
_HIGH = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGH)


def _mv(m, v):
    return jnp.einsum("...ij,...j->...i", m, v, precision=_HIGH)


class SE3(NamedTuple):
    """Rigid transform: rotation matrix [..., 3, 3] + translation [..., 3]."""

    R: jax.Array
    t: jax.Array

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "SE3":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        t = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return SE3(R, t)

    @staticmethod
    def from_matrix(m: jax.Array) -> "SE3":
        """From a [..., 4, 4] (or [..., 3, 4]) homogeneous matrix."""
        return SE3(m[..., :3, :3], m[..., :3, 3])

    def as_matrix(self) -> jax.Array:
        """[..., 4, 4] homogeneous matrix."""
        batch = self.t.shape[:-1]
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype), (*batch, 1, 4)
        )
        top = jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)
        return jnp.concatenate([top, bottom], axis=-2)

    def as_matrix34(self) -> jax.Array:
        """[..., 3, 4] matrix (the reference's trajectory row format)."""
        return jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply `other`, then `self`."""
        return SE3(
            _mm(self.R, other.R),
            _mv(self.R, other.t) + self.t,
        )

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return SE3(Rt, -_mv(Rt, self.t))

    def apply(self, pts: jax.Array) -> jax.Array:
        """Transform points [..., 3] (broadcasts over leading dims)."""
        return _mv(self.R, pts) + self.t

    def rotate(self, vecs: jax.Array) -> jax.Array:
        return _mv(self.R, vecs)


def hat_so3(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [..., 3, 3] of w [..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Uses series expansions near theta=0 so it is safe under jit/grad.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat_so3(w)
    K2 = _mm(K, K)
    # sin(t)/t and (1-cos(t))/t^2 with small-angle series.
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Goes through the quaternion (branch-free Shepperd extraction) and
    converts with atan2, which is numerically stable over the whole range
    of angles including theta ~ 0 and theta ~ pi.
    """
    q = mat_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = jnp.linalg.norm(qv, axis=-1)
    theta = 2.0 * jnp.arctan2(n, qw)
    small = n < 1e-6
    # w = theta * qv / n; near n=0, theta/n -> 2/qw.
    scale = jnp.where(small, 2.0 / jnp.maximum(qw, _EPS), theta / jnp.where(small, 1.0, n))
    return qv * scale[..., None]


def _left_jacobian_so3(w: jax.Array) -> jax.Array:
    """V such that exp_se3([w, v]) translation = V @ v."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat_so3(w)
    K2 = _mm(K, K)
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + b[..., None, None] * K + c[..., None, None] * K2


def exp_se3(xi: jax.Array) -> SE3:
    """se(3) twist [..., 6] (rot first: [w, v]) -> SE3."""
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    V = _left_jacobian_so3(w)
    t = _mv(V, v)
    return SE3(R, t)


def log_se3(T: SE3) -> jax.Array:
    """SE3 -> twist [..., 6] ([w, v])."""
    w = log_so3(T.R)
    V = _left_jacobian_so3(w)
    v = jnp.linalg.solve(V, T.t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [..., 4] (w, x, y, z), w >= 0.

    Branch-free Shepperd's method: compute all four candidate quaternions
    and select the best-conditioned one (largest pivot), so it vmaps/jits.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], axis=-1)
    case = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, case[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_slerp(q0: jax.Array, q1: jax.Array, u: jax.Array) -> jax.Array:
    """Spherical linear interpolation between unit quaternions.

    The reference's pose buffer leaves this as a TODO and snaps to the
    nearest pose (`/root/reference/utils/rotation_math/pose_manager.cc:27-54`);
    we interpolate properly.
    """
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_t = jnp.sin(theta)
    small = sin_t < 1e-5
    w0 = jnp.where(small, 1.0 - u, jnp.sin((1.0 - u) * theta) / jnp.where(small, 1.0, sin_t))
    w1 = jnp.where(small, u, jnp.sin(u * theta) / jnp.where(small, 1.0, sin_t))
    q = w0 * q0 + w1 * q1
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
