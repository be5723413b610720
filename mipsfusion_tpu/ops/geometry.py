"""SE(3) / quaternion geometry, camera-ray transforms, frustum bboxes.

Parity notes (semantics re-derived, not copied):
  * quaternion convention is real-first [qw, qx, qy, qz], matching
    pytorch3d as used by the reference
    (/root/reference/helper_functions/geometry_helper.py:11-37).
  * ``get_frame_surface_bbox`` mirrors geometry_helper.py:133-147.
  * ``project_to_pixel`` mirrors geometry_helper.py:216-222 (note the
    x-flip for the OpenGL camera convention).

Everything here is pure jnp and safe inside jit.

All matmuls in this module run at Precision.HIGHEST: a reduced-precision
matmul (bf16, or TF32 on a GPU) is fine for the neural field but
corrupts pose chains (3x3/4x4 products) at the 1e-3 level — far above
the SDF truncation scale the tracker optimizes against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full-f32-precision matmul, whatever the default precision."""
    return jnp.matmul(a, b, precision=_HI)


# ---------------------------------------------------------------------------
# Quaternions (real-first, [w, x, y, z])
# ---------------------------------------------------------------------------

def quaternion_to_matrix(quat: jnp.ndarray) -> jnp.ndarray:
    """Convert quaternion(s) [..., 4] (wxyz) to rotation matrices [..., 3, 3].

    The quaternion is normalized internally so unnormalized inputs (e.g.
    mid-optimization pose parameters) produce valid rotations.
    """
    q = quat / (jnp.linalg.norm(quat, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = 2.0
    m = jnp.stack(
        [
            1 - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w),
            two * (x * y + z * w), 1 - two * (x * x + z * z), two * (y * z - x * w),
            two * (x * z - y * w), two * (y * z + x * w), 1 - two * (x * x + y * y),
        ],
        axis=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(x, 0.0))


def matrix_to_quaternion(matrix: jnp.ndarray) -> jnp.ndarray:
    """Convert rotation matrices [..., 3, 3] to quaternions [..., 4] (wxyz).

    Uses the numerically-stable four-branch construction (same algorithm
    family as pytorch3d's matrix_to_quaternion) so it is safe under jit
    and for gradients away from the branch boundaries.
    """
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = jnp.stack(
        [
            _sqrt_positive_part(1.0 + m00 + m11 + m22),
            _sqrt_positive_part(1.0 + m00 - m11 - m22),
            _sqrt_positive_part(1.0 - m00 + m11 - m22),
            _sqrt_positive_part(1.0 - m00 - m11 + m22),
        ],
        axis=-1,
    )

    quat_by_w = jnp.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    quat_by_x = jnp.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], axis=-1)
    quat_by_y = jnp.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], axis=-1)
    quat_by_z = jnp.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], axis=-1)
    quat_candidates = jnp.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], axis=-2)
    # divide safely by 2*q_abs for each branch
    denom = 2.0 * jnp.maximum(q_abs, 0.1)[..., None]
    quat_candidates = quat_candidates / denom

    best = jnp.argmax(q_abs, axis=-1)
    quat = jnp.take_along_axis(
        quat_candidates, best[..., None, None].repeat(4, axis=-1), axis=-2
    )[..., 0, :]
    # standardize: nonnegative real part
    quat = jnp.where(quat[..., 0:1] < 0, -quat, quat)
    return quat


def qt_to_matrix(rot_quat: jnp.ndarray, trans: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] quaternion + [..., 3] translation -> [..., 4, 4] SE3."""
    R = quaternion_to_matrix(rot_quat)
    batch = rot_quat.shape[:-1]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(trans)
    T = T.at[..., 3, 3].set(1.0)
    return T


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def pose_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Invert SE3 matrices [..., 4, 4] using the rigid structure."""
    R_T = jnp.swapaxes(T[..., :3, :3], -1, -2)
    t = T[..., :3, 3:]
    inv = jnp.zeros_like(T)
    inv = inv.at[..., :3, :3].set(R_T)
    inv = inv.at[..., :3, 3:].set(-_mm(R_T, t))
    inv = inv.at[..., 3, 3].set(1.0)
    return inv


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply SE3 [4,4] (or batched [...,4,4]) to points [..., N, 3]."""
    return _mm(pts, jnp.swapaxes(T[..., :3, :3], -1, -2)) + T[..., None, :3, 3]


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log map -> twist [..., 6] (rho, phi). Safe near identity."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    # axis * 2 sin(theta) from the skew-symmetric part
    w_hat = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    cos_theta = jnp.clip((jnp.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    # atan2 form is well-conditioned everywhere except theta ~ pi.
    # All divisions below substitute safe denominators in the untaken
    # where-branch so autodiff (jacfwd through the PGO residual) never
    # sees 0/0.
    w2 = jnp.sum(w_hat * w_hat, axis=-1)
    small = w2 < 1e-10
    sin_theta = 0.5 * jnp.sqrt(jnp.where(small, 1.0, w2))
    sin_theta = jnp.where(small, 0.0, sin_theta)
    theta = jnp.arctan2(sin_theta, cos_theta)
    sin_safe = jnp.where(small, 1.0, sin_theta)
    scale = jnp.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * sin_safe))
    phi = w_hat * scale[..., None]

    # V^{-1} t
    wx = _skew(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta_ = jnp.sqrt(theta2_safe)
    A = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                  (1.0 - (theta_ * jnp.cos(theta_ / 2.0)) / (2.0 * jnp.sin(theta_ / 2.0))) / theta2_safe)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), wx.shape)
    V_inv = eye - 0.5 * wx + A[..., None, None] * _mm(wx, wx)
    rho = _mm(V_inv, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exp map from twist [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(phi * phi, axis=-1)
    small = theta2 < 1e-10
    # safe-where: substitute 1 in the untaken branch so autodiff never
    # divides by ~0 (0/0 grads poison jacfwd-based solvers)
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    wx = _skew(phi)
    # exact identity avoids a reduced-precision matmul: wx^2 = phi phi^T - theta^2 I
    wx2 = phi[..., :, None] * phi[..., None, :] - theta2[..., None, None] * jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), wx.shape)
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), wx.shape)
    R = eye + A[..., None, None] * wx + B[..., None, None] * wx2
    V = eye + B[..., None, None] * wx + C[..., None, None] * wx2
    t = _mm(V, rho[..., None])[..., 0]
    T = jnp.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# Camera rays
# ---------------------------------------------------------------------------

def get_camera_rays(H: int, W: int, fx: float, fy: float, cx: float, cy: float,
                    convention: str = "OpenGL") -> jnp.ndarray:
    """Per-pixel ray directions [H, W, 3] in the camera frame.

    OpenGL convention (the reference's default,
    /root/reference/datasets/utils.py:4-36): +x right, +y up, looking
    down -z, so dirs = [(i-cx)/fx, -(j-cy)/fy, -1].
    """
    j, i = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                        jnp.arange(W, dtype=jnp.float32), indexing="ij")
    if convention == "OpenGL":
        dirs = jnp.stack([(i - cx) / fx, -(j - cy) / fy, -jnp.ones_like(i)], axis=-1)
    elif convention == "OpenCV":
        dirs = jnp.stack([(i - cx) / fx, (j - cy) / fy, jnp.ones_like(i)], axis=-1)
    else:
        raise NotImplementedError(convention)
    return dirs


def rays_to_world(rays_d_cam: jnp.ndarray, c2w: jnp.ndarray):
    """Rotate camera-frame ray dirs [N,3] by c2w [4,4]; return (rays_o, rays_d)."""
    rays_d = _mm(rays_d_cam, c2w[:3, :3].T)
    rays_o = jnp.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_to_world_batched(rays_d_cam: jnp.ndarray, c2ws: jnp.ndarray,
                          pose_indices: jnp.ndarray):
    """Per-ray pose transform: rays [N,3], poses [M,4,4], indices [N]."""
    R = c2ws[pose_indices, :3, :3]            # [N, 3, 3]
    rays_d = jnp.einsum("nj,nij->ni", rays_d_cam, R, precision=_HI)
    rays_o = c2ws[pose_indices, :3, 3]
    return rays_o, rays_d


def get_frame_surface_bbox(c2w: jnp.ndarray, depth: jnp.ndarray,
                           rays_d_cam: jnp.ndarray, dist_near: float,
                           dist_far: float):
    """Axis-aligned bbox (center, length) of a frame's back-projected surface.

    Parity: geometry_helper.get_frame_surface_bbox (ref :133-147). Invalid
    depths are excluded via masked min/max (static shapes, jit-safe).
    """
    d = depth.reshape(-1, 1)
    dirs = rays_d_cam.reshape(-1, 3)
    rays_o, rays_d = rays_to_world(dirs, c2w)
    pts = rays_o + rays_d * d
    valid = ((d[:, 0] > dist_near) & (d[:, 0] < dist_far))[:, None]
    big = jnp.asarray(1e10, pts.dtype)
    xyz_max = jnp.max(jnp.where(valid, pts, -big), axis=0)
    xyz_min = jnp.min(jnp.where(valid, pts, big), axis=0)
    any_valid = jnp.any(valid)
    xyz_max = jnp.where(any_valid, xyz_max, jnp.zeros(3, pts.dtype))
    xyz_min = jnp.where(any_valid, xyz_min, jnp.zeros(3, pts.dtype))
    xyz_len = xyz_max - xyz_min
    xyz_center = xyz_min + 0.5 * xyz_len
    return xyz_center, xyz_len


def pts_in_bbox(pts: jnp.ndarray, xyz_min: jnp.ndarray, xyz_max: jnp.ndarray) -> jnp.ndarray:
    """Containment test: pts [N,3] vs bboxes [M,3]/[M,3] -> bool [N,M].

    Parity: geometry_helper.pts_in_bbox (ref :193-201), vectorized over M.
    """
    gt_min = jnp.all(pts[:, None, :] > xyz_min[None, :, :], axis=-1)
    lt_max = jnp.all(pts[:, None, :] < xyz_max[None, :, :], axis=-1)
    return gt_min & lt_max


def project_to_pixel(K: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame points [N,3] to pixel coords [N,2] (u, v).

    Parity: geometry_helper.project_to_pixel (ref :216-222) — the x axis is
    flipped before applying K because rays use the OpenGL convention.
    """
    pts = pts_cam * jnp.asarray([-1.0, 1.0, 1.0], pts_cam.dtype)
    uvw = _mm(pts, K.T)
    z = uvw[:, 2:3] + 1e-5
    return uvw[:, :2] / z
