"""Camera tracking: particle-swarm RO + gradient GO, each one jitted call.

Counterparts of the reference's two trackers:

  * RO — the ROSEFusion-style gradient-free random optimizer
    (/root/reference/RandomOptimizer.py:10-227). The pre-sampled particle
    swarm template (PST) is evaluated in ONE batched field query per
    iteration ([P, n_rays] points through hash+MLP), the advanced
    particle subset is reduced by a weighted mean, and the search size
    shrinks/grows with the mean SDF. The whole n_iter loop is a
    lax.fori_loop inside jit — zero host round-trips.

  * GO — gradient descent on a quaternion+translation pose param against
    the rendering losses (/root/reference/mipsfusion.py:470-576),
    with best-loss pose selection carried through a lax.scan.

Both operate in the active submap's local coordinate frame.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..models import scene_rep as sr
from ..ops.geometry import _mm, qt_to_matrix, quaternion_to_matrix, matrix_to_quaternion


# ---------------------------------------------------------------------------
# RO: random (particle swarm) optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ROConfig:
    particle_size: int = 2000
    initial_scaling_factor: float = 0.02   # ref RO.initial_scaling_factor
    rescaling_factor: float = 0.5          # ref RO.rescaling_factor
    n_rows: int = 16
    n_cols: int = 24
    n_iters: int = 5
    sdf_weight: float = 1000.0
    # Two-stage fitness screen (beyond the reference, OFF by default = exact
    # reference semantics): stage A scores ALL particles on an
    # evenly-strided ``screen_px`` subset of the pixel grid, stage B
    # re-scores the ``screen_keep`` best (identity always kept — it
    # anchors f0) on the full grid; non-survivors get zero APS weight.
    # Cuts the dominant [P*n] field-query batch ~2x at equal particle
    # and pixel budgets. Validated on the fast-motion sweep + outback
    # stress scenes before adoption.
    screen_px: int = 0
    screen_keep: int = 0
    # Adaptive search escalation (robustness lever beyond the reference, OFF by
    # default): scale the per-frame INITIAL search size by
    # clip(prev_loss / loss_EWMA, 1, escalate). The reference's search
    # size adapts within a frame (mean-SDF rescale) but every frame
    # restarts at the same fixed reach (~4-5 deg); the round-5
    # multi-seed stress A/B traced fast-motion divergence to gradual
    # basin slides whose 2-6 deg wobbles sit exactly at that reach —
    # tracking strain (loss over EWMA) is the on-device signal that the
    # reach must briefly grow (tools/diag_sweep.py).
    escalate: float = 0.0

    @staticmethod
    def from_dict(cfg: dict) -> "ROConfig":
        ro = cfg["tracking"]["RO"]
        return ROConfig(
            particle_size=ro["particle_size"],
            initial_scaling_factor=ro["initial_scaling_factor"],
            rescaling_factor=ro["rescaling_factor"],
            n_rows=ro["n_rows"], n_cols=ro["n_cols"],
            n_iters=cfg["tracking"]["iter_RO"],
            screen_px=ro.get("screen_px", 0),
            screen_keep=ro.get("screen_keep", 0),
            escalate=ro.get("escalate", 0.0),
        )


def make_pst(key: jax.Array, cfg: ROConfig) -> jnp.ndarray:
    """Pre-sampled particle swarm template [P, 6] ~ N(0, I), clamped to
    +-2, particle 0 pinned to identity (ref RandomOptimizer.py:26-32).

    Drawn as ANTITHETIC pairs (+z, -z): the reference's raw draw leaves
    the template with a nonzero sample mean (~1/sqrt(P) per axis), and
    because the same template is reused every iteration of every frame,
    that bias pushes the weighted-mean APS update in one fixed direction
    all sequence long — template-seed luck decided whether a trajectory
    drifted. Pairing zeroes the sample mean by construction (clip is
    odd, so the clamp preserves the symmetry)."""
    P = cfg.particle_size
    pairs = (P - 1) // 2
    z = jnp.clip(jax.random.normal(key, (pairs, 6)), -2.0, 2.0)
    # 1-2 identity rows (particle 0, plus a pad row when P is even —
    # identity particles carry zero APS weight, so duplicates are inert)
    zeros = jnp.zeros((P - 2 * pairs, 6))
    return jnp.concatenate([zeros, z, -z], axis=0)


def ro_pixel_grid(H: int, W: int, cfg: ROConfig):
    """Uniform pixel grid used by RO (ref RandomOptimizer.py:42-43)."""
    rows = jnp.linspace(0, H - 1, cfg.n_rows).astype(jnp.int32)
    cols = jnp.linspace(0, W - 1, cfg.n_cols).astype(jnp.int32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    # the per-iter offset (iter % 5) must stay in range
    return (jnp.clip(rr.reshape(-1), 0, H - 5),
            jnp.clip(cc.reshape(-1), 0, W - 5))


def _pose_6d_to_7d(p6: jnp.ndarray) -> jnp.ndarray:
    """[P,6] (qx,qy,qz,tx,ty,tz) -> [P,7] (qw,qx,qy,qz,t) (ref :54-60)."""
    imag_sq = jnp.sum(p6[:, :3] ** 2, axis=-1)
    qw = jnp.where(imag_sq <= 1.0, jnp.sqrt(jnp.maximum(1.0 - imag_sq, 0.0)),
                   0.0)[:, None]
    return jnp.concatenate([qw, p6], axis=-1)


def ro_world_points(rot: jnp.ndarray, trans: jnp.ndarray,
                    pts_cam: jnp.ndarray) -> jnp.ndarray:
    """Camera points [n, 3] under P poses (rot [P,3,3], trans [P,3]) as
    [3, P*n] points, particle-major."""
    ptsT = pts_cam.T                                              # [3,n]
    rows = [jnp.matmul(rot[:, i, :], ptsT,
                       precision=jax.lax.Precision.HIGHEST)
            + trans[:, i:i + 1] for i in range(3)]
    return jnp.stack(rows, 0).reshape(3, -1)


def ro_fitness(field_params: Dict, fcfg: sr.FieldConfig,
               consts: sr.FieldConsts, rot: jnp.ndarray, trans: jnp.ndarray,
               pts_cam: jnp.ndarray, valid: jnp.ndarray, sdf_weight: float,
               ray_sharding=None):
    """Particle fitness of RO (ref RandomOptimizer.py:113-131): the mean
    |SDF| (meters) of the camera points under each of the P candidate
    poses (rot [P,3,3], trans [P,3]), and that mean times
    ``sdf_weight``. Returns (fitness [P], mean_sdf [P]).

    The world points are built directly in points-minor layout
    (ro_world_points). With ``ray_sharding`` the point axis is sharded
    over the mesh's data axis.
    """
    P = rot.shape[0]
    worldT = ro_world_points(rot, trans, pts_cam)
    if ray_sharding is not None and \
            worldT.shape[1] % ray_sharding.mesh.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec
        worldT = jax.lax.with_sharding_constraint(
            worldT, NamedSharding(ray_sharding.mesh,
                                  PartitionSpec(None, "data")))
    sdf = sr.run_network_sdf_T(field_params, worldT, fcfg, consts)
    sdf = sdf.reshape(P, -1) * fcfg.trunc
    mean_sdf = jnp.mean(valid[None, :] * jnp.abs(sdf), axis=-1)      # [P]
    return mean_sdf * sdf_weight, mean_sdf


def ro_optimize(field_params: Dict, fcfg: sr.FieldConfig,
                consts: sr.FieldConsts, rcfg: ROConfig,
                pst: jnp.ndarray, depth_img: jnp.ndarray,
                rays_dir_img: jnp.ndarray, initial_pose: jnp.ndarray,
                row_idx: jnp.ndarray, col_idx: jnp.ndarray,
                n_iters: int, ray_sharding=None,
                ss_scale=None) -> jnp.ndarray:
    """Run the particle-swarm search; returns the refined pose [4, 4].

    Semantics mirror RandomOptimizer.optimize (ref :164-227): per iter,
    back-project a shifted uniform pixel grid, evaluate |SDF| under all
    candidate poses in one batched query, weighted-mean the advanced
    particles, and rescale the per-axis search size by the mean SDF.

    ``ray_sharding``: optional NamedSharding over the mesh's data axis —
    the [3, P*n] fitness batch (the per-frame hot loop 1, ref
    RandomOptimizer.py:113-131) is sharded across devices with the
    field params replicated; XLA inserts the collectives for the
    per-particle |SDF| means.
    """

    def fitness(rot, trans, pts_cam, valid):
        return ro_fitness(field_params, fcfg, consts, rot, trans, pts_cam,
                          valid, rcfg.sdf_weight, ray_sharding)

    def body(i, carry):
        rot, trans, search_size = carry
        off = jnp.mod(i, 5)
        d = depth_img[row_idx + off, col_idx + off][:, None]     # [n,1]
        dirs = rays_dir_img[row_idx + off, col_idx + off]        # [n,3]
        pts_cam = dirs * d
        valid = (d[:, 0] > 0.0).astype(jnp.float32)

        pst_scaled = pst * search_size                            # [P,6]
        pst7 = _pose_6d_to_7d(pst_scaled)                         # [P,7]
        delta_R = quaternion_to_matrix(pst7[:, :4])               # [P,3,3]
        abs_rot = jnp.einsum("ij,pjk->pik", rot, delta_R,
                             precision=jax.lax.Precision.HIGHEST)
        abs_trans = trans[None, :] + pst7[:, 4:]                  # [P,3]

        P = pst.shape[0]
        if 0 < rcfg.screen_keep < P and rcfg.screen_px > 0:
            # stage A: every particle on an evenly-strided pixel subset
            n_px = pts_cam.shape[0]
            sub = jnp.linspace(0, n_px - 1, rcfg.screen_px) \
                .astype(jnp.int32)
            fit_a, _ = fitness(abs_rot, abs_trans, pts_cam[sub],
                               valid[sub])
            # identity (particle 0) anchors f0 — always survives
            fit_a = fit_a.at[0].set(-jnp.inf)
            _, keep = jax.lax.top_k(-fit_a, rcfg.screen_keep)
            # stage B: survivors on the full grid; non-survivors score
            # a large-but-FINITE sentinel (an inf would turn the
            # (f0 - fit) * 0 weight product into NaN)
            fit_b, ms_b = fitness(abs_rot[keep], abs_trans[keep],
                                  pts_cam, valid)
            fit = jnp.full((P,), 1e10, fit_b.dtype).at[keep].set(fit_b)
            mean_sdf = jnp.zeros((P,), ms_b.dtype).at[keep].set(ms_b)
        else:
            fit, mean_sdf = fitness(abs_rot, abs_trans, pts_cam, valid)

        f0 = fit[0]
        better = (fit < f0).astype(jnp.float32)
        weights = (f0 - fit) * better
        wsum = jnp.sum(weights) + 1e-5
        success = jnp.count_nonzero(better) > 0

        mean_sdf_aps = jnp.where(success,
                                 jnp.sum(weights * mean_sdf) / wsum,
                                 mean_sdf[0])

        mean_tf = jnp.sum(pst7 * weights[:, None], axis=0) / wsum  # [7]
        quat = mean_tf[:4] / (jnp.linalg.norm(mean_tf[:4]) + 1e-5)
        mean_tf = jnp.where(
            success,
            jnp.concatenate([quat, mean_tf[4:]]),
            jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], mean_tf.dtype))

        dR = quaternion_to_matrix(mean_tf[:4])
        rot_new = jnp.where(success, _mm(rot, dR), rot)
        trans_new = jnp.where(success, trans + mean_tf[4:], trans)

        # search size update (ref :154-157)
        s = jnp.abs(mean_tf[1:]) + 1e-4                           # [6]
        ss = rcfg.rescaling_factor * mean_sdf_aps * s / jnp.linalg.norm(s) + 1e-4
        search_size_new = jnp.where(success, ss, ss * 2.0)[None, :]
        return rot_new, trans_new, search_size_new

    rot0 = initial_pose[:3, :3]
    trans0 = initial_pose[:3, 3]
    ss0 = jnp.full((1, 6), rcfg.initial_scaling_factor)
    if ss_scale is not None:
        ss0 = ss0 * ss_scale
    rot, trans, _ = jax.lax.fori_loop(0, n_iters, body, (rot0, trans0, ss0))
    T = jnp.eye(4, dtype=initial_pose.dtype)
    T = T.at[:3, :3].set(rot).at[:3, 3].set(trans)
    return T


# ---------------------------------------------------------------------------
# GO: gradient pose optimization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GOConfig:
    n_iters: int = 10
    n_rays: int = 1000
    lr_rot: float = 0.001
    lr_trans: float = 0.001
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    best: bool = True
    wait_iters: int = 100   # early stop after this many non-improving
                            # iters (ref mipsfusion.py:552, config :62)
    # Robustness beyond the reference (which accepts the GO pose
    # unconditionally, ref mipsfusion.py:558):
    #  * motion_prior_w: quadratic anchor of the GO pose to the
    #    constant-velocity prediction — restores observability in the
    #    photometric null space (texture-poor walls, pure-forward
    #    motion). 0 disables.
    #  * gate_rel/gate_abs: device-side pose acceptance gate — if the
    #    post-GO loss exceeds gate_rel x the running loss EWMA (and
    #    gate_abs), the frame keeps the motion-model pose instead of a
    #    basin-escaped estimate. 0 disables.
    motion_prior_w: float = 0.0
    gate_rel: float = 0.0
    gate_abs: float = 0.0

    @staticmethod
    def from_dict(cfg: dict) -> "GOConfig":
        t = cfg["tracking"]
        gate = t.get("pose_gate", {}) or {}
        return GOConfig(n_iters=t["iter"], n_rays=t["sample"],
                        lr_rot=t["lr_rot"], lr_trans=t["lr_trans"],
                        ignore_edge_w=t["ignore_edge_W"],
                        ignore_edge_h=t["ignore_edge_H"],
                        best=bool(t["best"]),
                        wait_iters=int(t.get("wait_iters", 100)),
                        motion_prior_w=float(t.get("motion_prior_w", 0.0)),
                        gate_rel=float(gate.get("rel", 0.0)),
                        gate_abs=float(gate.get("abs", 0.0)))


@dataclasses.dataclass(frozen=True)
class DriftGateConfig:
    """Frame-to-keyframe geometric drift gate + ICP rescue (robustness lever
    beyond the reference, OFF by default = exact reference semantics).

    An earlier multi-seed study showed full-budget
    fast-motion divergence is a gradual basin slide that (a) every
    EWMA-relative loss gate absorbs, and (b) the neural map itself
    absorbs within ~1 BA cycle — tools/diag_absres.py measured the
    median |SDF| residual of the live map pinned at ~4 mm while the
    pose error passed 100 mm (the map is dragged along by the
    pixels_cur rays). The only drift-proof anchor in the system is the
    stored keyframe DEPTH data: camera-frame back-projections are
    immutable sensor observations, and keyframes are laid down at
    keyframe_every cadence by (inductively) healthy poses.

    Gate: point-to-plane ICP of the current frame's strided
    back-projection onto the last keyframe's stored cloud, from the
    estimated relative pose; the MAGNITUDE of the correction ICP
    proposes (trans + rot_lever x angle, meters) is the drift
    measurement — an absolute metric that accumulates exactly the slip
    since the keyframe. (A median per-point plane-distance gate was
    tried first and under-measures tangential slips — the aperture
    problem; the ICP normal equations aggregate the minority of
    differently-oriented surfaces that constrain them.)
    Rescue (correction > ``thresh`` with enough inliers): adopt the
    ICP-corrected pose, optionally GO-polish photometrically, then
    VERIFY with the same instrument — a second ICP from the rescued
    pose must propose < half the original correction, else the
    original pose stands. The ICP+polish body sits under lax.cond and
    costs nothing unless it fires; the always-on measurement is one
    small NN + GN solve inside the existing tracking dispatch.
    """
    thresh: float = 0.0        # meters of proposed correction; 0 disables
    src_rows: int = 16         # current-frame strided grid
    src_cols: int = 24
    anchor_rows: int = 24      # keyframe anchor subsample grid
    anchor_cols: int = 43
    icp_iters: int = 10
    icp_thresh: float = 0.2    # NN correspondence cutoff (m)
    rot_lever: float = 2.0     # m/rad: rotation's weight in the slip
                               # magnitude (~ the scene's working depth)
    anchor_every: int = 5      # frames between anchor refreshes (the
                               # measured slides run 15-40 mm/frame, so
                               # a fresh anchor catches them; fresher
                               # also = more overlap = lower floor)
    anchor_health: float = 0.5 # refresh only when the frame's own
                               # drift reading < health * thresh (an
                               # anchor inherits its frame's error)
    polish_prior_w: float = 3.0  # quadratic anchor of the GO polish to
                               # the ICP pose (the polish optimizes
                               # against a possibly-dragged map)
    min_inlier_frac: float = 0.3   # of valid src points, else the ICP
                               # verdict is not trusted (overlap lost)
    icp_damping: float = 0.05  # relative Tikhonov damping of the gate
                               # ICP (see icp.icp_point_to_plane)
    icp_robust_delta: float = 0.02  # Cauchy scale (m) on the gate ICP's
                               # plane residuals (occlusion outliers)
    polish: bool = True        # GO re-run from the ICP-corrected pose

    @staticmethod
    def from_dict(cfg: dict) -> "DriftGateConfig":
        g = cfg["tracking"].get("drift_gate", {}) or {}
        return DriftGateConfig(
            thresh=float(g.get("thresh", 0.0)),
            src_rows=int(g.get("src_rows", 16)),
            src_cols=int(g.get("src_cols", 24)),
            anchor_rows=int(g.get("anchor_rows", 24)),
            anchor_cols=int(g.get("anchor_cols", 43)),
            icp_iters=int(g.get("icp_iters", 10)),
            icp_thresh=float(g.get("icp_thresh", 0.2)),
            icp_damping=float(g.get("icp_damping", 0.05)),
            icp_robust_delta=float(g.get("icp_robust_delta", 0.02)),
            rot_lever=float(g.get("rot_lever", 2.0)),
            anchor_every=int(g.get("anchor_every", 5)),
            anchor_health=float(g.get("anchor_health", 0.5)),
            polish_prior_w=float(g.get("polish_prior_w", 3.0)),
            min_inlier_frac=float(g.get("min_inlier_frac", 0.3)),
            polish=bool(g.get("polish", True)))


def _gate_anchor_core(packed_frame: jnp.ndarray, rows: int, cols: int):
    """Build a drift-gate anchor from a packed [H,W,7] frame: strided
    camera-frame back-projection + kNN-PCA normals. Invalid-depth
    points are banished to 1e6 so they never win an NN. Traceable —
    runs both standalone (first-frame arming) and under lax.cond
    inside the tracking dispatch (periodic on-device refresh)."""
    from .icp import estimate_normals

    H, W = packed_frame.shape[:2]
    rr = jnp.linspace(0, H - 1, rows).astype(jnp.int32)
    cc = jnp.linspace(0, W - 1, cols).astype(jnp.int32)
    r, c = jnp.meshgrid(rr, cc, indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    d = packed_frame[r, c, 6:7]
    pts = packed_frame[r, c, :3] * d
    valid = d[:, 0] > 0.0
    pts = jnp.where(valid[:, None], pts, 1e6)
    normals = estimate_normals(pts, k=8)
    return pts, normals, valid


gate_anchor = jax.jit(_gate_anchor_core, static_argnames=("rows", "cols"))


def _pose_optim(gcfg: GOConfig):
    return optax.multi_transform(
        {"rot": optax.adam(gcfg.lr_rot), "trans": optax.adam(gcfg.lr_trans)},
        {"rot": "rot", "trans": "trans"})


def go_optimize(field_params: Dict, fcfg: sr.FieldConfig,
                consts: sr.FieldConsts, gcfg: GOConfig,
                key: jax.Array, rays_d_cam: jnp.ndarray,
                target_rgb: jnp.ndarray, target_d: jnp.ndarray,
                initial_pose: jnp.ndarray, n_iters: int,
                lw: sr.LossWeights,
                prior_pose: jnp.ndarray = None,
                ray_sharding=None
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gradient refinement of a pose against fixed sampled rays.

    Mirrors the GO stage of tracking_render (ref mipsfusion.py:490-563):
    pose = (quat, trans) optimized by Adam; the loss BEFORE each update
    competes for the best pose; EMD classification terms are disabled
    during tracking (EMD_w=0, ref :533). Early stop: after
    ``wait_iters`` consecutive non-improving iterations the loop exits
    WITHOUT applying that iteration's update (ref :541-556 — thresh
    resets to 0 on improvement, the break precedes loss.backward()).
    The loop is a lax.while_loop, so the stop decision stays on device
    — no per-iteration host sync. Returns (pose [4,4], best loss).
    """
    quat0 = matrix_to_quaternion(initial_pose[:3, :3])
    params0 = {"rot": quat0, "trans": initial_pose[:3, 3]}
    opt = _pose_optim(gcfg)
    opt_state0 = opt.init(params0)

    # points-minor training layout (scene_rep.forward_losses_T): the
    # camera rays and targets are fixed across iterations, so their
    # [N, 3] -> [3, N] flips happen once per frame, outside the loop
    rays_d_camT = rays_d_cam.T
    target_rgbT = target_rgb.T
    if ray_sharding is not None and \
            rays_d_camT.shape[1] % ray_sharding.mesh.size == 0:
        # GO ray-DP (hot loop 2, ref mipsfusion.py:490-556): rays and
        # targets sharded over the data axis, pose params replicated —
        # XLA inserts the pose-gradient all-reduce
        from jax.sharding import NamedSharding, PartitionSpec
        colsh = NamedSharding(ray_sharding.mesh,
                              PartitionSpec(None, "data"))
        rays_d_camT = jax.lax.with_sharding_constraint(rays_d_camT, colsh)
        target_rgbT = jax.lax.with_sharding_constraint(target_rgbT, colsh)
        target_d = jax.lax.with_sharding_constraint(target_d, ray_sharding)

    if gcfg.motion_prior_w > 0.0:
        prior = initial_pose if prior_pose is None else prior_pose
        q_prior = matrix_to_quaternion(prior[:3, :3])
        t_prior = prior[:3, 3]

    def loss_fn(p, k):
        T = qt_to_matrix(p["rot"], p["trans"])
        rays_dT = T[:3, :3] @ rays_d_camT
        rays_oT = jnp.broadcast_to(T[:3, 3][:, None], rays_dT.shape)
        ret = sr.forward_losses_T(field_params, k, rays_oT, rays_dT,
                                  target_rgbT, target_d, fcfg, consts,
                                  emd_w=0.0)
        loss = sr.total_loss(ret, lw)
        if gcfg.motion_prior_w > 0.0:
            # quadratic anchor to the motion-model prediction: meters^2
            # for translation; the sign-invariant quaternion term is
            # ~theta^2/4 for small angles (comparable scale)
            q = p["rot"] / (jnp.linalg.norm(p["rot"]) + 1e-9)
            d = jnp.sum(q * q_prior) ** 2
            loss = loss + gcfg.motion_prior_w * (
                jnp.sum((p["trans"] - t_prior) ** 2) + (1.0 - d))
        return loss

    keys = jax.random.split(key, max(n_iters, 1))

    def cond(carry):
        i, _, _, _, _, thresh = carry
        return (i < n_iters) & (thresh <= gcfg.wait_iters)

    def body(carry):
        i, p, opt_state, best_loss, best_p, thresh = carry
        loss, g = jax.value_and_grad(loss_fn)(p, keys[i])
        improved = loss < best_loss
        best_loss = jnp.where(improved, loss, best_loss)
        best_p = jax.tree.map(
            lambda bp, cp: jnp.where(improved, cp, bp), best_p, p)
        # iter 0 seeds best_sdf_loss and counts as non-improving in the
        # reference (ref :536-550: best is set to the first loss, then
        # loss < best is False), hence the (i > 0) guard
        thresh = jnp.where(improved & (i > 0), 0, thresh + 1)
        # the reference breaks BEFORE stepping once patience runs out
        do = thresh <= gcfg.wait_iters
        updates, new_state = opt.update(g, opt_state, p)
        p = jax.tree.map(lambda a, u: jnp.where(do, a + u, a), p, updates)
        opt_state = jax.tree.map(
            lambda nn, oo: jnp.where(do, nn, oo), new_state, opt_state)
        return i + 1, p, opt_state, best_loss, best_p, thresh

    _, p_last, _, best_loss, best_p, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0, jnp.int32), params0, opt_state0,
         jnp.asarray(jnp.inf, jnp.float32), params0,
         jnp.asarray(0, jnp.int32)))

    p_final = best_p if gcfg.best else p_last
    return qt_to_matrix(p_final["rot"], p_final["trans"]), best_loss


def sample_pixels_mix(key: jax.Array, H: int, W: int, n_rows: int,
                      n_cols: int, depth_img: jnp.ndarray, n_total: int,
                      edge_h: int = 0, edge_w: int = 0):
    """Uniform-grid + valid-random pixel mix (ref sampling_helper.py:20-68).

    The uniform grid contributes n_rows*n_cols pixels; the remainder is
    drawn randomly, weighted toward valid-depth pixels. ``edge_h/w``
    exclude an image border from both parts (the reference crops
    ignore_edge_H/W before sampling tracking pixels,
    ref mipsfusion.py:504-522).
    """
    # clamp so tiny test images are not eaten entirely by the margin
    edge_h = min(edge_h, max((H - 8) // 2, 0))
    edge_w = min(edge_w, max((W - 8) // 2, 0))
    Hi, Wi = H - 2 * edge_h, W - 2 * edge_w
    rows = edge_h + jnp.linspace(0, Hi - 1, n_rows).astype(jnp.int32)
    cols = edge_w + jnp.linspace(0, Wi - 1, n_cols).astype(jnp.int32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    n_rand = n_total - rr.shape[0]
    if n_rand <= 0:
        return rr[:n_total], cc[:n_total]
    # valid-biased random sampling: add noise to validity, take top-k
    interior = depth_img[edge_h:H - edge_h, edge_w:W - edge_w]
    valid = (interior > 0.0).astype(jnp.float32).reshape(-1)
    score = valid + jax.random.uniform(key, valid.shape)
    _, idx = jax.lax.top_k(score, n_rand)
    return (jnp.concatenate([rr, edge_h + (idx // Wi).astype(jnp.int32)]),
            jnp.concatenate([cc, edge_w + (idx % Wi).astype(jnp.int32)]))


class TrackResult(NamedTuple):
    pose: jnp.ndarray
    loss: jnp.ndarray
    loss_ewma: jnp.ndarray   # running accepted-loss EWMA (gate state)
    accepted: jnp.ndarray    # bool: False = pose gate fell back to the
                             # motion-model prediction
    drift_res: jnp.ndarray   # drift-gate residual (m; 0 when gate off)
    rescued: jnp.ndarray     # bool: drift gate fired and the ICP/polish
                             # pose was adopted


class TrackUpdate(NamedTuple):
    est_c2w: jnp.ndarray
    est_c2w_rel: jnp.ndarray
    keyframe_ref: jnp.ndarray
    pose: jnp.ndarray
    loss: jnp.ndarray
    loss_ewma: jnp.ndarray
    accepted: jnp.ndarray
    drift_res: jnp.ndarray
    rescued: jnp.ndarray
    # drift-gate anchor state (None when the gate is off): refreshed ON
    # DEVICE every anchor_every frames from the tracked frame's own
    # packed data — zero host syncs in the steady loop
    gate_pts: jnp.ndarray = None
    gate_normals: jnp.ndarray = None
    gate_valid: jnp.ndarray = None
    gate_kf_frame: jnp.ndarray = None


@partial(jax.jit, static_argnames=("fcfg", "rcfg", "gcfg", "n_iter_ro",
                                   "n_iter_go", "from_current",
                                   "keyframe_every", "ray_sharding",
                                   "dgcfg"))
def track_frame_update(field_params: Dict, fcfg: sr.FieldConfig,
                       consts: sr.FieldConsts, rcfg: ROConfig,
                       gcfg: GOConfig, pst: jnp.ndarray, base_key: jax.Array,
                       packed_frame: jnp.ndarray, est_c2w: jnp.ndarray,
                       est_c2w_rel: jnp.ndarray, keyframe_ref: jnp.ndarray,
                       frame_idx, use_const_speed, switch_tracking,
                       active_first_kf, lw: sr.LossWeights, n_iter_ro: int,
                       n_iter_go: int, keyframe_every: int,
                       from_current: bool = False,
                       loss_ewma: jnp.ndarray = None,
                       prev_loss: jnp.ndarray = None,
                       ray_sharding=None,
                       dgcfg: "DriftGateConfig" = None,
                       gate_pts: jnp.ndarray = None,
                       gate_normals: jnp.ndarray = None,
                       gate_valid: jnp.ndarray = None,
                       gate_kf_frame: jnp.ndarray = None,
                       prev_rescued: jnp.ndarray = None) -> TrackUpdate:
    """Track frame ``frame_idx`` AND commit the pose-store bookkeeping
    (ref mipsfusion.py:470-576 including the :558-576 epilogue) in one
    jitted dispatch.

    ``packed_frame`` is the device-resident [H, W, 7] =
    (direction, rgb, depth) frame; the per-frame PRNG key is derived on
    device by fold_in so the steady-state loop issues no host->device
    transfers beyond the handful of scalar arguments.
    """
    frame_idx = jnp.asarray(frame_idx, jnp.int32)
    key = jax.random.fold_in(base_key, frame_idx)
    if loss_ewma is None:
        loss_ewma = jnp.asarray(-1.0, jnp.float32)
    res = track_frame(field_params, fcfg, consts, rcfg, gcfg, pst, key,
                      packed_frame[..., 3:6], packed_frame[..., 6],
                      packed_frame[..., :3], est_c2w, frame_idx,
                      use_const_speed, lw, n_iter_ro, n_iter_go,
                      from_current=from_current, loss_ewma=loss_ewma,
                      prev_loss=prev_loss, ray_sharding=ray_sharding,
                      dgcfg=dgcfg, gate_pts=gate_pts,
                      gate_normals=gate_normals, gate_valid=gate_valid,
                      gate_kf_frame=gate_kf_frame,
                      prev_rescued=prev_rescued)

    # pose-store epilogue (ref mipsfusion.py:558-576)
    kf_id = frame_idx // keyframe_every
    kf_frame = kf_id * keyframe_every
    is_kf = frame_idx % keyframe_every == 0
    from ..ops.geometry import pose_inverse
    est_c2w = est_c2w.at[frame_idx].set(res.pose)
    delta = _mm(pose_inverse(est_c2w[kf_frame]), res.pose)
    rel_new = jnp.where(is_kf, est_c2w_rel[frame_idx], delta)
    est_c2w_rel = est_c2w_rel.at[frame_idx].set(rel_new)
    switch_tracking = jnp.asarray(switch_tracking, bool)
    ref_new = jnp.where(is_kf & ~switch_tracking,
                        jnp.asarray(active_first_kf, jnp.int32),
                        keyframe_ref[kf_id])
    keyframe_ref = keyframe_ref.at[kf_id].set(ref_new)
    g_pts, g_nrm, g_val, g_kf = (gate_pts, gate_normals, gate_valid,
                                 gate_kf_frame)
    if dgcfg is not None and dgcfg.thresh > 0.0 and gate_pts is not None \
            and not from_current:
        # periodic ON-DEVICE anchor refresh from the frame just tracked:
        # due when the anchor aged past anchor_every; allowed only when
        # the frame's own drift reading is below anchor_health * thresh
        # (an anchor inherits its frame's pose error). If refreshes kept
        # being vetoed (sustained strain / low overlap) the health bound
        # relaxes to the full threshold after 3 missed cycles rather
        # than letting the anchor age without limit.
        armed = g_kf >= 0
        age = frame_idx - g_kf
        due = (~armed) | (age >= dgcfg.anchor_every)
        health = jnp.where(age >= 3 * dgcfg.anchor_every,
                           dgcfg.thresh,
                           dgcfg.anchor_health * dgcfg.thresh)
        healthy = (~armed) | (res.drift_res <= health)
        do = due & healthy & ~switch_tracking

        def build(_):
            pts, normals, valid = _gate_anchor_core(
                packed_frame, dgcfg.anchor_rows, dgcfg.anchor_cols)
            return pts, normals, valid, frame_idx

        def keep(_):
            return g_pts, g_nrm, g_val, g_kf

        g_pts, g_nrm, g_val, g_kf = jax.lax.cond(do, build, keep, None)

    return TrackUpdate(est_c2w=est_c2w, est_c2w_rel=est_c2w_rel,
                       keyframe_ref=keyframe_ref, pose=res.pose,
                       loss=res.loss, loss_ewma=res.loss_ewma,
                       accepted=res.accepted, drift_res=res.drift_res,
                       rescued=res.rescued, gate_pts=g_pts,
                       gate_normals=g_nrm, gate_valid=g_val,
                       gate_kf_frame=g_kf)


@partial(jax.jit, static_argnames=("fcfg", "rcfg", "gcfg", "n_iter_ro",
                                   "n_iter_go", "from_current",
                                   "ray_sharding", "dgcfg"))
def track_frame(field_params: Dict, fcfg: sr.FieldConfig,
                consts: sr.FieldConsts, rcfg: ROConfig, gcfg: GOConfig,
                pst: jnp.ndarray, key: jax.Array,
                rgb_img: jnp.ndarray, depth_img: jnp.ndarray,
                rays_dir_img: jnp.ndarray, est_c2w: jnp.ndarray,
                frame_idx: jnp.ndarray, use_const_speed: jnp.ndarray,
                lw: sr.LossWeights, n_iter_ro: int, n_iter_go: int,
                from_current: bool = False,
                loss_ewma: jnp.ndarray = None,
                prev_loss: jnp.ndarray = None,
                ray_sharding=None,
                dgcfg: "DriftGateConfig" = None,
                gate_pts: jnp.ndarray = None,
                gate_normals: jnp.ndarray = None,
                gate_valid: jnp.ndarray = None,
                gate_kf_frame: jnp.ndarray = None,
                prev_rescued: jnp.ndarray = None) -> TrackResult:
    """Full per-frame tracking: motion model -> RO -> GO. One jitted call.

    Mirrors tracking_render (ref mipsfusion.py:470-563) with the
    constant-velocity prediction of predict_current_pose (ref :448-458).
    Pose history is indexed from ``est_c2w`` on-device (a host-side
    slice per frame would cost a dispatch round-trip); with
    ``from_current`` the stored pose of the frame itself is the seed
    (switch re-tracking, ref :470-476).
    """
    from ..ops.geometry import pose_inverse

    H, W = depth_img.shape
    if from_current:
        pred = est_c2w[frame_idx]
    else:
        prev_pose = est_c2w[frame_idx - 1]
        prev_prev_pose = est_c2w[jnp.maximum(frame_idx - 2, 0)]
        delta = _mm(prev_pose, pose_inverse(prev_prev_pose))
        use_cs = use_const_speed
        if prev_rescued is not None:
            # a drift-gate rescue at frame-1 put a correction JUMP into
            # the (frame-1, frame-2) delta; const-speed would extrapolate
            # that jump on top of the corrected pose — fall back to the
            # previous (corrected) pose for one frame
            use_cs = use_cs & ~prev_rescued
        pred = jnp.where(use_cs, _mm(delta, prev_pose), prev_pose)

    gate_on = (dgcfg is not None and dgcfg.thresh > 0.0
               and gate_pts is not None and not from_current)
    if gate_on:
        # the extra split only exists when the gate is configured, so
        # gate-off runs keep the exact reference-default PRNG streams
        k_ro, k_px, k_go, k_polish = jax.random.split(key, 4)
    else:
        k_ro, k_px, k_go = jax.random.split(key, 3)

    pose = pred
    if n_iter_ro > 0:
        ss_scale = None
        if rcfg.escalate > 0.0 and prev_loss is not None:
            # tracking-strain escalation: grow the initial reach by the
            # previous frame's loss over the accepted-loss EWMA (both
            # device scalars — no sync). Inactive until the EWMA seeds.
            ew = loss_ewma if loss_ewma is not None \
                else jnp.asarray(-1.0, jnp.float32)
            ratio = prev_loss / jnp.maximum(ew, 1e-8)
            ss_scale = jnp.where((ew > 0.0) & (prev_loss > 0.0),
                                 jnp.clip(ratio, 1.0, rcfg.escalate), 1.0)
        row_idx, col_idx = ro_pixel_grid(H, W, rcfg)
        pose = ro_optimize(field_params, fcfg, consts, rcfg, pst,
                           depth_img, rays_dir_img, pose, row_idx,
                           col_idx, n_iter_ro,
                           ray_sharding=ray_sharding, ss_scale=ss_scale)

    # pixel selection for GO (fixed across iterations, ref :504-522)
    rr, cc = sample_pixels_mix(k_px, H, W, rcfg.n_rows, rcfg.n_cols,
                               depth_img, gcfg.n_rays,
                               edge_h=gcfg.ignore_edge_h,
                               edge_w=gcfg.ignore_edge_w)
    rays_d_cam = rays_dir_img[rr, cc]
    target_rgb = rgb_img[rr, cc]
    target_d = depth_img[rr, cc][:, None]

    pose, loss = go_optimize(field_params, fcfg, consts, gcfg, k_go,
                             rays_d_cam, target_rgb, target_d, pose,
                             n_iter_go, lw, prior_pose=pred,
                             ray_sharding=ray_sharding)

    if loss_ewma is None:
        loss_ewma = jnp.asarray(-1.0, jnp.float32)
    if gcfg.gate_rel > 0.0:
        # pose acceptance gate: a loss far above the running EWMA of
        # accepted losses marks a basin escape — keep the motion-model
        # prediction for this frame instead. Rejections inflate the
        # EWMA so a genuine regime change re-opens the gate within a
        # few frames rather than locking out forever.
        seeded = loss_ewma > 0.0
        ok = (~seeded) | (loss <= gcfg.gate_abs) \
            | (loss <= gcfg.gate_rel * loss_ewma)
        pose = jnp.where(ok, pose, pred)
        ewma_upd = jnp.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)
        loss_ewma = jnp.where(ok, ewma_upd, loss_ewma * 1.25)
        accepted = ok
    else:
        seeded = loss_ewma > 0.0
        loss_ewma = jnp.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)
        accepted = jnp.asarray(True)

    drift_res = jnp.asarray(0.0, jnp.float32)
    rescued = jnp.asarray(False)
    if gate_on:
        from .icp import icp_point_to_plane

        srr = jnp.linspace(0, H - 1, dgcfg.src_rows).astype(jnp.int32)
        scc = jnp.linspace(0, W - 1, dgcfg.src_cols).astype(jnp.int32)
        sr_, sc_ = jnp.meshgrid(srr, scc, indexing="ij")
        sr_, sc_ = sr_.reshape(-1), sc_.reshape(-1)
        sd = depth_img[sr_, sc_][:, None]
        src_cam = rays_dir_img[sr_, sc_] * sd
        src_valid = sd[:, 0] > 0.0
        n_valid = jnp.sum(src_valid)

        kf_pose = est_c2w[jnp.maximum(gate_kf_frame, 0)]
        kf_inv = pose_inverse(kf_pose)

        def slip_of(p4):
            """ICP the current cloud onto the keyframe cloud from pose
            p4; the magnitude of the proposed correction IS the drift
            measurement. (A median point-to-plane residual was tried
            first and under-measures tangential slips — the aperture
            problem: a slip parallel to the dominant planes leaves most
            per-point plane distances unchanged, while the ICP normal
            equations aggregate the minority of differently-oriented
            surfaces that do constrain it.)"""
            rel0 = _mm(kf_inv, p4)
            src0 = src_cam @ rel0[:3, :3].T + rel0[:3, 3]
            icp = icp_point_to_plane(src0, src_valid, gate_pts,
                                     gate_valid, gate_normals,
                                     dgcfg.icp_thresh,
                                     n_iters=dgcfg.icp_iters,
                                     rel_damping=dgcfg.icp_damping,
                                     robust_delta=dgcfg.icp_robust_delta)
            T = icp.transform
            theta = jnp.arccos(jnp.clip(
                (jnp.trace(T[:3, :3]) - 1.0) * 0.5, -1.0, 1.0))
            slip = jnp.linalg.norm(T[:3, 3]) + dgcfg.rot_lever * theta
            enough = icp.n_inliers >= dgcfg.min_inlier_frac * n_valid
            pose_c = _mm(kf_pose, _mm(T, rel0))
            return slip, enough, pose_c

        slip, enough, pose_icp = slip_of(pose)
        drift_res = slip
        armed = gate_kf_frame >= 0
        fire = armed & enough & (slip > dgcfg.thresh)

        def do_rescue(args):
            pose, pose_icp = args
            # geometric verify FIRST, decoupled from the polish: from a
            # correct pose a second ICP proposes ~no further correction.
            # (The polish's GO optimizes against a possibly-DRAGGED map
            # — it must not hold veto power over the rescue.)
            slip_v, enough_v, _ = slip_of(pose_icp)
            ok = enough_v & (slip_v < 0.5 * slip)
            pose_r = pose_icp
            if dgcfg.polish and n_iter_go > 0:
                pgcfg = dataclasses.replace(
                    gcfg, motion_prior_w=dgcfg.polish_prior_w)
                pose_r, _ = go_optimize(
                    field_params, fcfg, consts, pgcfg, k_polish,
                    rays_d_cam, target_rgb, target_d, pose_icp,
                    n_iter_go, lw, prior_pose=pose_icp,
                    ray_sharding=ray_sharding)
            return (jnp.where(ok, pose_r, pose),
                    jnp.where(ok, slip_v, slip), ok)

        pose, drift_res, rescued = jax.lax.cond(
            fire, do_rescue,
            lambda a: (a[0], slip, jnp.asarray(False)),
            (pose, pose_icp))

    return TrackResult(pose=pose, loss=loss, loss_ewma=loss_ewma,
                       accepted=accepted, drift_res=drift_res,
                       rescued=rescued)
