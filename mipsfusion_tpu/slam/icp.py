"""Point-to-plane ICP in pure JAX (loop-closure pose rectification).

Replacement for the reference's open3d ICP call
(/root/reference/PoseCorrector.py:149-163). Differences by design:

  * normals are estimated by k-NN PCA over the target cloud (open3d's
    estimate_normals equivalent), as one batched eigendecomposition;
  * correspondences are brute-force nearest neighbors (clouds are
    downsampled keyframe back-projections, a few thousand points, so the
    [N, M] distance matrix is a single matmul);
  * the solve is a fixed iteration count of damped point-to-plane
    Gauss-Newton steps inside one jit (static shapes, masked
    correspondences instead of dynamic rejection).

Outputs mirror the open3d contract the reference consumes: the rigid
transform and the number of inlier correspondences within threshold.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.geometry import _mm, se3_exp

_HI = jax.lax.Precision.HIGHEST


def estimate_normals(pts: jnp.ndarray, k: int = 10) -> jnp.ndarray:
    """Per-point normals via k-NN PCA. pts [N,3] -> normals [N,3]."""
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    _, idx = jax.lax.top_k(-d2, k)                 # [N, k] nearest (incl self)
    nbrs = pts[idx]                                # [N, k, 3]
    centered = nbrs - jnp.mean(nbrs, axis=1, keepdims=True)
    cov = jnp.einsum("nki,nkj->nij", centered, centered, precision=_HI)
    # smallest-eigenvalue eigenvector = plane normal
    w, v = jnp.linalg.eigh(cov)
    return v[:, :, 0]


class ICPResult(NamedTuple):
    transform: jnp.ndarray       # [4,4] src -> dst
    n_inliers: jnp.ndarray       # scalar int
    rmse: jnp.ndarray            # scalar


@partial(jax.jit, static_argnames=("n_iters", "rel_damping",
                                   "robust_delta"))
def icp_point_to_plane(src: jnp.ndarray, src_valid: jnp.ndarray,
                       dst: jnp.ndarray, dst_valid: jnp.ndarray,
                       dst_normals: jnp.ndarray, threshold: float,
                       n_iters: int = 20,
                       rel_damping: float = 0.0,
                       robust_delta: float = 0.0) -> ICPResult:
    """Register src onto dst minimizing point-to-plane error.

    src [N,3] + validity mask, dst [M,3] + mask + normals. Matches the
    semantics of o3d registration_icp(..., PointToPlane): correspondences
    are nearest neighbors within ``threshold``.

    ``rel_damping`` > 0 adds Tikhonov damping RELATIVE to the normal
    equations' own scale (lambda = rel_damping * tr(H)/6): directions
    the correspondences barely constrain (the tangential null space of
    point-to-plane — sliding along the scene's dominant planes) then
    take ~no step instead of wandering on correspondence/normal noise.
    Used by the tracker's drift gate, where "propose no correction in
    unconstrained directions" is the safe behavior; the loop-closure
    rectification keeps the raw solve (its clouds are dense and the
    reference's open3d call is undamped).

    ``robust_delta`` > 0 applies a Cauchy weight 1/(1 + (r/delta)^2) on
    the plane residual: correspondences at occlusion boundaries and
    across depth edges (plane error >> delta even at the correct pose)
    otherwise drag the least-squares solve toward phantom corrections
    of the sampling-floor scale."""
    big = jnp.asarray(1e10, src.dtype)

    def step(T, _):
        p = src @ T[:3, :3].T + T[:3, 3]
        d2 = jnp.sum((p[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(dst_valid[None, :], d2, big)
        j = jnp.argmin(d2, axis=-1)                 # [N]
        dmin = jnp.sqrt(jnp.take_along_axis(d2, j[:, None], 1)[:, 0])
        w = (src_valid & (dmin < threshold)).astype(src.dtype)

        q = dst[j]
        n = dst_normals[j]
        r = jnp.sum((p - q) * n, axis=-1)           # point-to-plane residual
        if robust_delta > 0.0:
            w = w / (1.0 + (r / robust_delta) ** 2)
        # jacobian rows: [n, p x n] w.r.t. twist (rho, phi)
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)  # [N, 6]
        Jw = J * w[:, None]
        H = _mm(Jw.T, J)
        lam = 1e-6 + rel_damping * jnp.trace(H) / 6.0
        H = H + lam * jnp.eye(6, dtype=src.dtype)
        g = Jw.T @ (r * 1.0)
        xi = -jnp.linalg.solve(H, g)
        dT = se3_exp(xi)
        return _mm(dT, T), None

    T0 = jnp.eye(4, dtype=src.dtype)
    T, _ = jax.lax.scan(step, T0, None, length=n_iters)

    # final inlier stats
    p = src @ T[:3, :3].T + T[:3, 3]
    d2 = jnp.sum((p[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(dst_valid[None, :], d2, big)
    dmin = jnp.sqrt(jnp.min(d2, axis=-1))
    inlier = src_valid & (dmin < threshold)
    n_in = jnp.sum(inlier)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inlier, dmin ** 2, 0.0))
                    / jnp.maximum(n_in, 1))
    return ICPResult(transform=T, n_inliers=n_in, rmse=rmse)


def backproject_rays(rays: jnp.ndarray, poses: jnp.ndarray,
                     pose_idx: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """rays [N,7] (dir,rgb,depth) + poses [K,4,4] + per-ray pose index ->
    (points [N,3], valid [N]). Mirrors construct_pc_given_kfs
    (ref PoseCorrector.py:70-87) without the open3d dependency."""
    T = poses[pose_idx]
    d = rays[:, 6:7]
    dirs = jnp.einsum("nj,nij->ni", rays[:, :3], T[:, :3, :3], precision=_HI)
    pts = T[:, :3, 3] + dirs * d
    return pts, d[:, 0] > 0.0


# ---------------------------------------------------------------------------
# SVD (point-to-point) ICP — parity with the vendored pypose fragment
# ---------------------------------------------------------------------------

def svd_transform(src: jnp.ndarray, dst: jnp.ndarray,
                  weights: jnp.ndarray) -> jnp.ndarray:
    """Weighted closed-form rigid transform src -> dst (Kabsch/Arun).

    Parity with the reference's vendored pypose svdtf
    (/root/reference/external/Pypose_external/ICP.py:14-27), the
    point-to-point solver its batched ICP uses.
    """
    w = weights / (jnp.sum(weights) + 1e-12)
    cs = jnp.sum(src * w[:, None], axis=0)
    cd = jnp.sum(dst * w[:, None], axis=0)
    H = _mm(((src - cs) * w[:, None]).T, dst - cd)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(_mm(Vt.T, U.T))
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0]) * 1.0).at[2, 2].set(det)
    R = _mm(Vt.T, _mm(D, U.T))
    t = cd - R @ cs
    T = jnp.eye(4, dtype=src.dtype)
    return T.at[:3, :3].set(R).at[:3, 3].set(t)


@partial(jax.jit, static_argnames=("n_iters",))
def icp_point_to_point(src: jnp.ndarray, src_valid: jnp.ndarray,
                       dst: jnp.ndarray, dst_valid: jnp.ndarray,
                       threshold: float, n_iters: int = 20) -> ICPResult:
    """Classic nearest-neighbor + SVD ICP (point-to-point metric).

    Parity with the vendored pypose ICP loop
    (/root/reference/external/Pypose_external/ICP.py:30-109): NN
    correspondences, Kabsch solve, iterate. Correspondences beyond
    ``threshold`` are down-weighted to zero (static-shape masking
    replaces the reference's plateau stepper early-exit).
    """
    big = jnp.asarray(1e10, src.dtype)

    def step(T, _):
        p = src @ T[:3, :3].T + T[:3, 3]
        d2 = jnp.sum((p[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(dst_valid[None, :], d2, big)
        j = jnp.argmin(d2, axis=-1)
        dmin = jnp.sqrt(jnp.take_along_axis(d2, j[:, None], 1)[:, 0])
        w = (src_valid & (dmin < threshold)).astype(src.dtype)
        dT = svd_transform(p, dst[j], w)
        return _mm(dT, T), None

    T0 = jnp.eye(4, dtype=src.dtype)
    T, _ = jax.lax.scan(step, T0, None, length=n_iters)

    p = src @ T[:3, :3].T + T[:3, 3]
    d2 = jnp.sum((p[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(dst_valid[None, :], d2, big)
    dmin = jnp.sqrt(jnp.min(d2, axis=-1))
    inlier = src_valid & (dmin < threshold)
    n_in = jnp.sum(inlier)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inlier, dmin ** 2, 0.0))
                    / jnp.maximum(n_in, 1))
    return ICPResult(transform=T, n_inliers=n_in, rmse=rmse)
