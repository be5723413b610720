"""Mesh extraction: per-submap and joint (entropy/distance-fused) meshes.

Counterpart of the reference Mesher
(/root/reference/model/Mesher.py:288-669 + vis/math_helper.py:60-96):

  * per-submap: uniform grid over the submap AABB (intersected with the
    marching-cubes bound), batched SDF queries on device (one jitted
    chunked query), native marching-tetrahedra triangulation with
    truncation-aware invalid rejection on host, per-vertex color query;
  * joint: union grid over all submap AABBs; per-submap TSDF + class
    entropy queried per grid point; fused SDF = sum_i w_i * sdf_i with
    w_i = normalize(exp(-10 * entropy_i) * gauss(dist-to-submap-center))
    masked by per-submap AABB visibility (ref compute_weights
    math_helper.py:79-96, convert_dist_to_weight :66-72);
  * visibility filtering: grid points outside every submap AABB are
    marked invalid so the extractor skips them (the reference's
    VoxelGrid-based visibility culling serves the same purpose).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene_rep as sr
from .marching import marching_cubes


@dataclasses.dataclass
class MeshConfig:
    voxel_size: float = 0.05
    query_chunk: int = 131072
    iso: float = 0.0


def _grid_points(lo: np.ndarray, hi: np.ndarray, voxel: float):
    xs = np.arange(lo[0], hi[0] + voxel, voxel, dtype=np.float32)
    ys = np.arange(lo[1], hi[1] + voxel, voxel, dtype=np.float32)
    zs = np.arange(lo[2], hi[2] + voxel, voxel, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return pts, (len(xs), len(ys), len(zs)), (xs, ys, zs)


def surface_occupancy(points_w: np.ndarray, lo: np.ndarray,
                      hi: np.ndarray, cvox: float = 0.2,
                      dilate: int = 1):
    """Coarse occupancy of observed surface, as a point->bool query fn.

    The reference culls its mesh query grid with an open3d VoxelGrid
    built from keyframe back-projected surface points, radially dilated
    by +-20% copies (ref Mesher.get_bounding_geometry :126-162 +
    create_voxelgrids_from_pointcloud :80-95, vox_size=0.5). Here the
    same coarse visibility is an occupancy grid (cvox voxels) grown by
    ``dilate`` voxels — validity reaches ~cvox*(dilate..dilate+1) from
    observed surface, uniformly instead of centroid-radially.

    Marking far-from-surface grid points INVALID (rather than trusting
    the field there) is what makes meshing robust: the SDF is only
    supervised inside the truncation band around observed surface, so
    querying it far away yields arbitrary crossings (spurious mesh) —
    and the classification head saturates at +-1 in free space, which a
    magnitude-based validity test would wrongly reject right next to
    genuine surface.
    """
    lo = np.asarray(lo, np.float64) - cvox * (dilate + 1)
    hi = np.asarray(hi, np.float64) + cvox * (dilate + 1)
    dims = np.maximum(((hi - lo) / cvox).astype(int) + 1, 1)
    occ = np.zeros(dims, bool)
    idx = np.floor((points_w - lo) / cvox).astype(int)
    ok = ((idx >= 0) & (idx < dims)).all(axis=1)
    idx = idx[ok]
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    if dilate:
        from scipy.ndimage import binary_dilation
        occ = binary_dilation(occ, iterations=dilate)
    return _Occupancy(occ, lo.astype(np.float32), float(cvox))


class _Occupancy:
    """Callable point->bool occupancy query exposing its grid (the
    device fused-SDF path uploads .occ/.lo/.cvox once — a few tens of
    KB — instead of round-tripping per-point masks)."""

    def __init__(self, occ: np.ndarray, lo: np.ndarray, cvox: float):
        self.occ, self.lo, self.cvox = occ, lo, cvox

    def __call__(self, q: np.ndarray) -> np.ndarray:
        dims = np.asarray(self.occ.shape)
        qi = np.floor((q - self.lo) / self.cvox).astype(int)
        inb = ((qi >= 0) & (qi < dims)).all(axis=1)
        qi = np.clip(qi, 0, dims - 1)
        return inb & self.occ[qi[:, 0], qi[:, 1], qi[:, 2]]


def kf_surface_points(kf_world: np.ndarray, kf_rays: np.ndarray
                      ) -> np.ndarray:
    """Back-project stored keyframe rays to world surface points
    (ref Mesher.get_bounding_geometry :133-147). kf_world [K,4,4],
    kf_rays [K,R,7] = (dir, rgb, depth); zero-depth rays dropped."""
    dirs_w = np.einsum("kij,krj->kri", kf_world[:, :3, :3],
                       kf_rays[..., :3])
    pts = kf_world[:, None, :3, 3] + dirs_w * kf_rays[..., 6:7]
    return pts.reshape(-1, 3)[kf_rays[..., 6].reshape(-1) > 0]


class Mesher:
    def __init__(self, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                 mesh_cfg: MeshConfig = MeshConfig()):
        self.fcfg = fcfg
        self.consts = consts
        self.cfg = mesh_cfg

        @jax.jit
        def _query(params, pts):
            out = sr.run_network(params, pts, fcfg, consts)
            # rgb(3) sdf(1) entropy(1)
            return out[..., :5]

        self._query = _query

    def query_grid(self, params: Dict, pts_local: np.ndarray) -> np.ndarray:
        """Chunked device query -> [N, 5] (rgb, sdf, entropy).

        The final ragged chunk is zero-padded to the fixed chunk size so
        the jitted query compiles exactly once per param shape.
        """
        n = pts_local.shape[0]
        # power-of-2 bucketing: masked queries have data-dependent point
        # counts; a chunk size of exactly n would compile a fresh kernel
        # per distinct count
        b = 1024
        while b < min(n, self.cfg.query_chunk):
            b *= 2
        chunk = min(self.cfg.query_chunk, b)
        outs = []
        for s in range(0, n, chunk):
            seg = pts_local[s:s + chunk]
            pad = chunk - seg.shape[0]
            if pad:
                seg = np.pad(seg, ((0, pad), (0, 0)))
            out = np.asarray(self._query(params, jnp.asarray(seg)))
            outs.append(out[:chunk - pad] if pad else out)
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, 5),
                                                                  np.float32)

    def query_grid_masked(self, params: Dict, pts_local: np.ndarray,
                          mask: np.ndarray, fill: float = 0.0
                          ) -> np.ndarray:
        """query_grid over pts_local[mask] only, scattered back to [N,5]
        (unqueried rows = fill). The observed fraction of a scene grid
        is typically well under half, so skipping invalid points cuts
        mesh wall time proportionally."""
        out = np.full((pts_local.shape[0], 5), fill, np.float32)
        if mask.any():
            out[mask] = self.query_grid(params, pts_local[mask])
        return out

    # ------------------------------------------------------------------
    # per-submap mesh (ref Mesher.extract_single_mesh :288-402)
    # ------------------------------------------------------------------

    def extract_single_mesh(self, params: Dict, anchor_world: np.ndarray,
                            center_world: np.ndarray, length: np.ndarray,
                            trunc: float = 0.3, with_color: bool = True,
                            bound_world: Optional[np.ndarray] = None,
                            observed_fn=None, grid_bounds=None):
        """Mesh one submap. The AABB (center, length) is in world coords;
        grid points are converted to the submap's local frame for SDF
        queries (ref :332-344), and vertices are returned in world coords.
        ``grid_bounds`` (lo, hi) overrides the AABB-derived grid extent
        (e.g. the observed-surface bbox — see extract_mesh_jointly).

        ``observed_fn`` (points_w -> bool[N], see surface_occupancy) is
        the coarse visibility mask of ref Mesher.py:316-325: grid points
        it rejects are marked invalid for the extractor (the reference
        passes the same mask to skimage marching_cubes) and are never
        queried. Observed SDF values are clipped inside the truncation
        band so saturated free space next to surface stays VALID —
        validity means "observed", not "small |sdf|".
        """
        if grid_bounds is not None:
            lo, hi = np.asarray(grid_bounds[0]), np.asarray(grid_bounds[1])
        else:
            lo = center_world - 0.5 * length
            hi = center_world + 0.5 * length
        if bound_world is not None:
            lo = np.maximum(lo, bound_world[:, 0])
            hi = np.minimum(hi, bound_world[:, 1])
        pts_w, shape, axes = _grid_points(lo, hi, self.cfg.voxel_size)

        w2l = np.linalg.inv(anchor_world)
        pts_l = pts_w @ w2l[:3, :3].T + w2l[:3, 3]
        if observed_fn is not None:
            obs = observed_fn(pts_w)
            raw = self.query_grid_masked(params, pts_l.astype(np.float32),
                                         obs)
            sdf = np.where(obs, np.clip(raw[:, 3], -0.98 * trunc,
                                        0.98 * trunc), 2.0 * trunc)
        else:
            raw = self.query_grid(params, pts_l.astype(np.float32))
            sdf = raw[:, 3]
        sdf = sdf.reshape(shape)

        verts_g, faces = marching_cubes(sdf, self.cfg.iso, trunc)
        if len(verts_g) == 0:
            return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3)))
        verts_w = lo[None, :] + verts_g * self.cfg.voxel_size

        colors = np.zeros_like(verts_w)
        if with_color:
            v_l = verts_w @ w2l[:3, :3].T + w2l[:3, 3]
            raw_v = self.query_grid(params, v_l.astype(np.float32))
            colors = 1.0 / (1.0 + np.exp(-raw_v[:, :3]))  # sigmoid
        return verts_w, faces, colors

    # ------------------------------------------------------------------
    # device-side fused TSDF volume (joint-mesh fast path)
    # ------------------------------------------------------------------

    def _get_fused_volume_fn(self, M: int, chunk: int):
        """Jitted per-chunk fused-SDF evaluator over stacked submap
        params: grid points are GENERATED on device from the flat index,
        every submap's (sdf, entropy) is queried on device, and the
        entropy/distance/occupancy weighting fuses them there — the host
        receives one fp16 scalar per grid point instead of uploading
        [N,3] points and downloading [N,5] channels per submap."""
        key = ("fused", M, chunk)
        fn = getattr(self, "_fused_cache", None)
        if fn is None:
            self._fused_cache = {}
        fn = self._fused_cache.get(key)
        if fn is not None:
            return fn
        fcfg, consts = self.fcfg, self.consts

        @partial(jax.jit, static_argnames=("ny", "nz"))
        def run(stacked, w2l, centers, sigma, occ_m, occ_glob, occ_lo,
                cvox, lo, voxel, start, trunc, ny: int, nz: int):
            idx = start + jnp.arange(chunk)
            ix = idx // (ny * nz)
            iy = (idx // nz) % ny
            iz = idx % nz
            pts = lo + voxel * jnp.stack([ix, iy, iz], -1).astype(
                jnp.float32)                              # [B, 3]

            qi = jnp.floor((pts - occ_lo) / cvox).astype(jnp.int32)
            dims = jnp.asarray(occ_glob.shape, jnp.int32)
            inb = ((qi >= 0) & (qi < dims)).all(-1)
            qc = jnp.clip(qi, 0, dims - 1)
            obs = inb & occ_glob[qc[:, 0], qc[:, 1], qc[:, 2]]
            occ_pm = occ_m[:, qc[:, 0], qc[:, 1], qc[:, 2]]  # [M, B]

            def one(p, w2l_m):
                pl = pts @ w2l_m[:3, :3].T + w2l_m[:3, 3]
                out = sr.run_network(p, pl, fcfg, consts)
                return out[:, 3], out[:, 4]

            sdf_m, ent_m = jax.vmap(one)(stacked, w2l)       # [M, B]
            dist = jnp.linalg.norm(pts[None] - centers[:, None],
                                   axis=-1)                  # [M, B]
            mask = occ_pm & obs[None]
            w = jnp.exp(-10.0 * ent_m) \
                * jnp.exp(-0.5 * (dist / sigma) ** 2) * mask
            wsum = jnp.sum(w, axis=0)
            fused = jnp.sum(w * sdf_m, axis=0) / jnp.maximum(wsum, 1e-12)
            fused = jnp.clip(fused, -0.98 * trunc, 0.98 * trunc)
            fused = jnp.where(mask.any(0), fused, 2.0 * trunc)
            return fused.astype(jnp.float16)

        self._fused_cache[key] = run
        return run

    def fused_sdf_volume_device(self, submap_params, anchors_world,
                                centers, sigma, observed: "_Occupancy",
                                submap_observed, lo, shape,
                                voxel: float, trunc: float) -> np.ndarray:
        """Fused TSDF volume [nx,ny,nz] computed entirely on device."""
        M = len(submap_params)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *submap_params)
        w2l = jnp.asarray(np.linalg.inv(anchors_world), jnp.float32)
        occ_m = jnp.asarray(np.stack(
            [s.occ for s in submap_observed]).astype(np.bool_))
        occ_glob = jnp.asarray(observed.occ.astype(np.bool_))
        nx, ny, nz = shape
        N = nx * ny * nz
        chunk = min(self.cfg.query_chunk, -(-N // 8) * 8)
        b = 8192
        while b < chunk:
            b *= 2
        chunk = min(self.cfg.query_chunk, b)
        run = self._get_fused_volume_fn(M, chunk)
        out = np.empty(N, np.float16)
        centers_d = jnp.asarray(centers, jnp.float32)
        lo_d = jnp.asarray(lo, jnp.float32)
        occ_lo = jnp.asarray(observed.lo, jnp.float32)
        for s in range(0, N, chunk):
            res = run(stacked, w2l, centers_d,
                      jnp.float32(sigma), occ_m, occ_glob, occ_lo,
                      jnp.float32(observed.cvox), lo_d,
                      jnp.float32(voxel), jnp.int32(s),
                      jnp.float32(trunc), ny=ny, nz=nz)
            out[s:s + chunk] = np.asarray(res)[:min(chunk, N - s)]
        return out.reshape(nx, ny, nz).astype(np.float32)

    # ------------------------------------------------------------------
    # joint mesh (ref extract_mesh_jointly_geometry :418-581)
    # ------------------------------------------------------------------

    def extract_mesh_jointly(self, submap_params: List[Dict],
                             anchors_world: np.ndarray,
                             centers: np.ndarray, lengths: np.ndarray,
                             trunc: float = 0.3, with_color: bool = True,
                             bound_world: Optional[np.ndarray] = None,
                             observed_fn=None,
                             submap_observed_fns=None, grid_bounds=None):
        """Fuse all submaps' SDFs into one mesh.

        anchors_world [M,4,4]; centers/lengths [M,3] world AABBs.
        ``observed_fn``: coarse surface-occupancy visibility (see
        extract_single_mesh); ``submap_observed_fns`` [M] replaces the
        per-submap AABB membership masks with each submap's OWN
        observed-surface occupancy (where its field is supervised);
        ``grid_bounds`` (lo, hi) overrides the grid extent (e.g. the
        all-keyframe surface bbox instead of the AABB union).
        """
        M = len(submap_params)
        lo = np.min(centers - 0.5 * lengths, axis=0)
        hi = np.max(centers + 0.5 * lengths, axis=0)
        if grid_bounds is not None:
            # mesh the region the fields were actually TRAINED on (the
            # observed-surface bbox) rather than the manager's clamped
            # submap AABBs: keyframe rays supervise the field wherever
            # they land, which routinely extends beyond localMLP_max_len
            lo, hi = np.asarray(grid_bounds[0]), np.asarray(grid_bounds[1])
        if bound_world is not None:
            lo = np.maximum(lo, bound_world[:, 0])
            hi = np.minimum(hi, bound_world[:, 1])
        # sigma for the Gaussian distance weights
        # (ref convert_dist_to_weight :66-72: sigma = max distance / 3;
        # the max over grid points is attained at a grid-bbox corner)
        corners = np.stack(np.meshgrid([lo[0], hi[0]], [lo[1], hi[1]],
                                       [lo[2], hi[2]], indexing="ij"),
                           axis=-1).reshape(-1, 3)
        max_d = max(float(np.linalg.norm(corners - c, axis=1).max())
                    for c in centers)
        sigma = max(max_d, 1e-6) / 3.0

        device_path = (isinstance(observed_fn, _Occupancy)
                       and submap_observed_fns is not None
                       and all(isinstance(f, _Occupancy)
                               for f in submap_observed_fns)
                       and len({f.occ.shape for f in submap_observed_fns}
                               | {observed_fn.occ.shape}) == 1)
        if device_path:
            # _grid_points uses arange(lo, hi + voxel): reproduce dims
            xs = np.arange(lo[0], hi[0] + self.cfg.voxel_size,
                           self.cfg.voxel_size, dtype=np.float32)
            ys = np.arange(lo[1], hi[1] + self.cfg.voxel_size,
                           self.cfg.voxel_size, dtype=np.float32)
            zs = np.arange(lo[2], hi[2] + self.cfg.voxel_size,
                           self.cfg.voxel_size, dtype=np.float32)
            shape = (len(xs), len(ys), len(zs))
            sdf_grid = self.fused_sdf_volume_device(
                submap_params, anchors_world, centers, sigma,
                observed_fn, list(submap_observed_fns), lo, shape,
                self.cfg.voxel_size, trunc)
        else:
            pts_w, shape, axes = _grid_points(lo, hi, self.cfg.voxel_size)
            n = pts_w.shape[0]
            obs = observed_fn(pts_w) if observed_fn is not None \
                else np.ones(n, bool)

            sdf_all = np.zeros((n, M), np.float32)
            ent_all = np.zeros((n, M), np.float32)
            mask_all = np.zeros((n, M), bool)
            dist_all = np.zeros((n, M), np.float32)

            for m in range(M):
                w2l = np.linalg.inv(anchors_world[m])
                if submap_observed_fns is not None:
                    # per-submap validity = near surface observed by
                    # THIS submap's keyframes (where it is supervised)
                    mask_all[:, m] = submap_observed_fns[m](pts_w) & obs
                else:
                    inlo = centers[m] - 0.5 * lengths[m]
                    inhi = centers[m] + 0.5 * lengths[m]
                    mask_all[:, m] = ((pts_w > inlo)
                                      & (pts_w < inhi)).all(-1) & obs
                pts_l = pts_w @ w2l[:3, :3].T + w2l[:3, 3]
                raw = self.query_grid_masked(submap_params[m],
                                             pts_l.astype(np.float32),
                                             mask_all[:, m])
                sdf_all[:, m] = raw[:, 3]
                ent_all[:, m] = raw[:, 4]
                dist_all[:, m] = np.linalg.norm(pts_w - centers[m],
                                                axis=-1)

            gauss = np.exp(-0.5 * (dist_all / sigma) ** 2)
            # entropy-inverse weights (ref compute_weights :79-96)
            w = np.exp(-10.0 * ent_all) * gauss * mask_all
            wsum = w.sum(axis=1, keepdims=True)
            visible = mask_all.any(axis=1)
            w = np.where(wsum > 1e-12, w / np.maximum(wsum, 1e-12), 0.0)

            fused = (w * sdf_all).sum(axis=1)
            fused = np.clip(fused, -0.98 * trunc, 0.98 * trunc)
            fused = np.where(visible, fused, np.inf)  # invalid -> skipped
            sdf_grid = fused.reshape(shape).astype(np.float32)

        verts_g, faces = marching_cubes(sdf_grid, self.cfg.iso, trunc)
        if len(verts_g) == 0:
            return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3)))
        verts_w = lo[None, :] + verts_g * self.cfg.voxel_size

        colors = np.zeros_like(verts_w)
        if with_color:
            # per-vertex fused color with the same weighting scheme
            # (ref extract_mesh_jointly_color :590-669)
            nv = verts_w.shape[0]
            rgb_v = np.zeros((nv, M, 3), np.float32)
            wv = np.zeros((nv, M), np.float32)
            for m in range(M):
                w2l = np.linalg.inv(anchors_world[m])
                v_l = verts_w @ w2l[:3, :3].T + w2l[:3, 3]
                raw = self.query_grid(submap_params[m],
                                      v_l.astype(np.float32))
                rgb_v[:, m] = 1.0 / (1.0 + np.exp(-raw[:, :3]))
                d = np.linalg.norm(verts_w - centers[m], axis=-1)
                inlo = centers[m] - 0.5 * lengths[m]
                inhi = centers[m] + 0.5 * lengths[m]
                msk = ((verts_w > inlo) & (verts_w < inhi)).all(-1)
                wv[:, m] = np.exp(-10.0 * raw[:, 4]) * np.exp(
                    -0.5 * (d / sigma) ** 2) * msk
            wvs = wv.sum(axis=1, keepdims=True)
            wv = np.where(wvs > 1e-12, wv / np.maximum(wvs, 1e-12),
                          1.0 / M)
            colors = (wv[..., None] * rgb_v).sum(axis=1)
        return verts_w, faces, colors


def point_seen_mask(verts_w: np.ndarray, kf_poses_w: np.ndarray,
                    K: np.ndarray, H: int, W: int,
                    kf_max_depths: np.ndarray,
                    edge: Optional[int] = None) -> np.ndarray:
    """Bool [V]: vertex visible from at least one keyframe.

    Reference point_mask (/root/reference/model/Mesher.py:245-281):
    project into each keyframe (OpenGL, z < 0 in front), require the
    pixel inside an ``edge`` margin and |z| within (0, that keyframe's
    max depth). The reference's fixed 20 px margin assumes 1200x680
    images; kept proportional (~3% of the short side) so small frames
    are not dominated by the margin.
    """
    if edge is None:
        edge = max(2, min(20, int(round(0.03 * min(H, W)))))
    seen = np.zeros(verts_w.shape[0], bool)
    for c2w, max_d in zip(kf_poses_w, kf_max_depths):
        w2c = np.linalg.inv(c2w)
        pc = verts_w @ w2c[:3, :3].T + w2c[:3, 3]          # [V, 3]
        z = pc[:, 2]
        # same x-flip projection as ops.geometry.project_to_pixel
        # (ref geometry_helper.py:216-222)
        uvw = (pc * np.asarray([-1.0, 1.0, 1.0])) @ K.T
        zz = uvw[:, 2] + 1e-5
        u, v = uvw[:, 0] / zz, uvw[:, 1] / zz
        m = ((u > edge) & (u < W - edge) & (v > edge) & (v < H - edge)
             & (z < 0) & (np.abs(z) > 0) & (np.abs(z) < max_d))
        seen |= m
        if seen.all():
            break
    return seen


def filter_unseen_faces(faces: np.ndarray,
                        seen_mask: np.ndarray) -> np.ndarray:
    """Drop faces whose vertices are ALL unseen (the reference's loose
    rule, ref get_face_mask Mesher.py:223-231)."""
    unseen = ~seen_mask
    face_unseen = unseen[faces].all(axis=1)
    return faces[~face_unseen]


def remove_small_components(verts: np.ndarray, faces: np.ndarray,
                            colors: Optional[np.ndarray] = None,
                            min_area: float = 0.5):
    """Drop connected components with total triangle area <= min_area
    (ref Mesher.py:360-366, remove_small_geometry_threshold = 0.5 m^2)."""
    if len(faces) == 0:
        return verts, faces, colors
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    V = len(verts)
    e0 = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    e1 = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(e0)), (e0, e1)), shape=(V, V))
    _, labels = connected_components(adj, directed=False)

    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    tri_area = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
    face_label = labels[faces[:, 0]]
    comp_area = np.bincount(face_label, weights=tri_area,
                            minlength=labels.max() + 1)
    keep_face = comp_area[face_label] > min_area
    faces = faces[keep_face]

    used = np.zeros(V, bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    verts2 = verts[used]
    colors2 = colors[used] if colors is not None and len(colors) == V \
        else colors
    return verts2, remap[faces], colors2


def apply_visibility_filters(verts: np.ndarray, faces: np.ndarray,
                             colors: Optional[np.ndarray],
                             kf_poses_w: np.ndarray, K: np.ndarray,
                             H: int, W: int, kf_max_depths: np.ndarray,
                             min_component_area: float = 0.5):
    """Reference post-extraction cleanup (ref Mesher.py:360-378):
    small-component removal, then unseen-face culling against the
    keyframe set. Returns the filtered (verts, faces, colors)."""
    if len(verts) == 0 or len(kf_poses_w) == 0:
        return verts, faces, colors
    verts, faces, colors = remove_small_components(
        verts, faces, colors, min_component_area)
    if len(verts) == 0:
        return verts, faces, colors
    seen = point_seen_mask(verts, kf_poses_w, K, H, W, kf_max_depths)
    faces = filter_unseen_faces(faces, seen)
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    colors = colors[used] if colors is not None \
        and len(colors) == len(verts) else colors
    return verts[used], remap[faces], colors


def load_mesh_ply(path: str):
    """Read an ascii PLY written by save_mesh_ply (or compatible).

    Returns (verts [N,3] f32, faces [F,3] i32, colors [N,3] f32 in [0,1]
    or None).
    """
    with open(path) as f:
        assert f.readline().strip() == "ply", "not a PLY file"
        n_vert = n_face = 0
        has_color = False
        for line in f:
            tok = line.strip().split()
            if tok[:2] == ["element", "vertex"]:
                n_vert = int(tok[2])
            elif tok[:2] == ["element", "face"]:
                n_face = int(tok[2])
            elif tok[:2] == ["property", "uchar"] and tok[2] in (
                    "red", "green", "blue"):
                has_color = True
            elif tok[0] == "format" and tok[1] != "ascii":
                raise ValueError("only ascii PLY is supported")
            elif tok[0] == "end_header":
                break
        verts = np.empty((n_vert, 3), np.float32)
        colors = np.empty((n_vert, 3), np.float32) if has_color else None
        for i in range(n_vert):
            vals = f.readline().split()
            verts[i] = [float(v) for v in vals[:3]]
            if has_color:
                colors[i] = [float(v) / 255.0 for v in vals[3:6]]
        faces = np.empty((n_face, 3), np.int32)
        for i in range(n_face):
            vals = f.readline().split()
            assert vals[0] == "3", "only triangle faces are supported"
            faces[i] = [int(v) for v in vals[1:4]]
    return verts, faces, colors


def concat_meshes(meshes):
    """Concatenate (verts, faces, colors) triples with index offsets."""
    verts_l, faces_l, colors_l = [], [], []
    off = 0
    any_color = any(c is not None for _, _, c in meshes)
    for v, fcs, c in meshes:
        verts_l.append(v)
        faces_l.append(np.asarray(fcs) + off)
        if any_color:
            colors_l.append(c if c is not None
                            else np.full((len(v), 3), 0.5, np.float32))
        off += len(v)
    verts = np.concatenate(verts_l) if verts_l else np.zeros((0, 3))
    faces = np.concatenate(faces_l) if faces_l else np.zeros((0, 3), np.int32)
    colors = np.concatenate(colors_l) if any_color else None
    return verts, faces, colors


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                  colors: Optional[np.ndarray] = None) -> None:
    """Minimal binary-less PLY writer (no trimesh dependency)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None and len(colors) == len(verts):
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None and len(colors) == len(verts):
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, c8):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
