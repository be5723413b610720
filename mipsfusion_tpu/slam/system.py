"""The SLAM system: the per-frame orchestration loop.

Counterpart of the reference's two-process system
(/root/reference/mipsfusion.py + InactiveMap.py). The host loop only
sequences jitted device steps and makes the (cheap, per-keyframe-
cadence) control decisions; all compute — tracking RO+GO, local BA,
submap init, switch BA, background refinement, ICP, PGO — runs as
whole-loop jitted calls with static shapes, so the per-frame hot path
never retraces.

How the reference's two-process architecture maps here:
  * ActiveMap process        -> the run() loop;
  * InactiveMap round-robin  -> inactive_refine_step(), interleaved at
    mapping cadence (ref InactiveMap.py:203-307);
  * the shared-model handoff protocol (shared_flag spin-waits,
    ref mipsfusion.py:607-653 / InactiveMap.py:61-96) -> a list index:
    submap params live in self.submap_params[m], so "archive" and
    "return asked model" are free;
  * keyframe_mutex_mask / overlap_kf_flag ownership races
    (ref SURVEY §5.2) -> explicit sequencing: active BA and inactive BA
    never run concurrently, and the inactive step excludes keyframes
    bound to the active submap.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..eval.ate import pose_evaluation, save_traj_tum
from ..models import scene_rep as sr
from ..ops.geometry import _mm, pose_inverse, project_to_pixel, qt_to_matrix
from . import icp as icp_mod
from . import manager as manager_mod
from . import mapper, pose_graph
from . import state as slam_state
from . import tracker


def _anchor_of(st: slam_state.SlamState, submap_id) -> jnp.ndarray:
    return st.kf_c2w[st.localMLP_first_kf[submap_id]]


def _extract_submap_kf_poses(st: slam_state.SlamState, submap_id,
                             kf_frames: jnp.ndarray) -> jnp.ndarray:
    """Local poses of every keyframe slot in submap_id's frame.

    Vectorized extract_localMLP_vars steps 4.1-4.3
    (ref keyframeSet.py:472-515): ordinary kfs use est_c2w directly
    (valid when their first binding == submap_id); first kfs of
    OTHER submaps convert from their world anchor; overlapping kfs
    whose first binding differs convert via both anchors.
    """
    poses = st.est_c2w[kf_frames]                      # [K,4,4]
    anchor = _anchor_of(st, submap_id)
    anchor_inv = pose_inverse(anchor)

    kf_ref = st.keyframe_ref
    first_kf = st.localMLP_first_kf[submap_id]
    idx = jnp.arange(poses.shape[0])

    # first kfs of other submaps: local = anchor^-1 @ world
    world = st.kf_c2w[jnp.clip(idx, 0, st.kf_c2w.shape[0] - 1)]
    from_world = jnp.einsum("ij,kjl->kil", anchor_inv, world,
                            precision=jax.lax.Precision.HIGHEST)
    is_other_first = (kf_ref == -1) & (idx != first_kf)
    poses = jnp.where(is_other_first[:, None, None], from_world, poses)

    # overlapping kfs bound first to another submap: convert via the
    # first-bound submap's anchor
    first_bind = st.keyframe_localMLP[:, 0]
    other_anchor = st.kf_c2w[st.localMLP_first_kf[
        jnp.clip(first_bind, 0, st.localMLP_first_kf.shape[0] - 1)]]
    world_ovlp = jnp.einsum("kij,kjl->kil", other_anchor,
                            st.est_c2w[kf_frames],
                            precision=jax.lax.Precision.HIGHEST)
    local_ovlp = jnp.einsum("ij,kjl->kil", anchor_inv, world_ovlp,
                            precision=jax.lax.Precision.HIGHEST)
    is_ovlp_other = (kf_ref == -2) & (first_bind != submap_id)
    poses = jnp.where(is_ovlp_other[:, None, None], local_ovlp, poses)

    # the submap's own first keyframe: identity in its own frame
    poses = jnp.where((idx == first_kf)[:, None, None],
                      jnp.eye(4, dtype=poses.dtype)[None], poses)
    return poses


def _writeback_ba_poses(st: slam_state.SlamState, submap_id,
                        kf_mask: jnp.ndarray, opt_poses: jnp.ndarray,
                        kf_frames: jnp.ndarray) -> slam_state.SlamState:
    """Write optimized kf poses back by type (ref mipsfusion.py:344-367)."""
    kf_ref = st.keyframe_ref
    first_kf = st.localMLP_first_kf[submap_id]
    idx = jnp.arange(opt_poses.shape[0])
    anchor = _anchor_of(st, submap_id)
    upd = kf_mask & (idx != first_kf)

    # ordinary kfs: est_c2w[frame] = optimized local pose
    ordinary = upd & (kf_ref >= 0)

    # overlapping kfs first-bound to this submap: same
    first_bind = st.keyframe_localMLP[:, 0]
    ovlp_here = upd & (kf_ref == -2) & (first_bind == submap_id)

    # overlapping kfs first-bound elsewhere: convert to that frame
    world = jnp.einsum("ij,kjl->kil", anchor, opt_poses,
                       precision=jax.lax.Precision.HIGHEST)
    other_anchor_inv = pose_inverse(st.kf_c2w[st.localMLP_first_kf[
        jnp.clip(first_bind, 0, st.localMLP_first_kf.shape[0] - 1)]])
    local_other = jnp.einsum("kij,kjl->kil", other_anchor_inv, world,
                             precision=jax.lax.Precision.HIGHEST)
    ovlp_other = upd & (kf_ref == -2) & (first_bind != submap_id)

    new_frame_pose = jnp.where(
        (ordinary | ovlp_here)[:, None, None], opt_poses,
        jnp.where(ovlp_other[:, None, None], local_other,
                  st.est_c2w[kf_frames]))
    est_c2w = st.est_c2w.at[kf_frames].set(new_frame_pose)

    # first kfs of other submaps: update their world anchors
    other_first = upd & (kf_ref == -1)
    new_kf_c2w = jnp.where(other_first[:, None, None], world,
                           st.kf_c2w[jnp.clip(
                               idx, 0, st.kf_c2w.shape[0] - 1)])
    kf_c2w = st.kf_c2w.at[jnp.clip(
        idx, 0, st.kf_c2w.shape[0] - 1)].set(new_kf_c2w)
    return st._replace(est_c2w=est_c2w, kf_c2w=kf_c2w)


@partial(jax.jit, static_argnames=("k", "edge", "H", "W"))
def _overlap_verify(st: slam_state.SlamState, depth, rays_d, pose_world,
                    mo_id, active_id, rows, cols, K_mat, kf_frames,
                    k: int, edge: int, H: int, W: int):
    """Loop-closure overlap verification as ONE device program
    (ref Manager.find_overlapping_region :261-352): related-keyframe
    selection, world poses, top-k nearest, per-kf visibility, AABB
    membership. The host reads back one small dict and decides.

    Padded top-k slots (fewer than k related keyframes) carry
    top_valid=False and are excluded from the visibility votes.
    """
    from ..ops.geometry import rays_to_world, pts_in_bbox

    # related keyframes: bound to mo_id, not first-bound to active
    rel_mask = (slam_state.submap_kf_mask(st, mo_id)
                & (st.keyframe_localMLP[:, 0] != active_id))

    # world poses of ALL kf slots (vectorized convert_given_world_pose)
    first_bind = st.keyframe_localMLP[:, 0]
    M = st.localMLP_first_kf.shape[0]
    anchors = st.kf_c2w[st.localMLP_first_kf[
        jnp.clip(first_bind, 0, M - 1)]]
    local = st.est_c2w[kf_frames]
    world = jnp.einsum("kij,kjl->kil", anchors, local,
                       precision=jax.lax.Precision.HIGHEST)
    Kn = world.shape[0]
    world = jnp.where((st.keyframe_ref == -1)[:, None, None],
                      st.kf_c2w[jnp.arange(Kn)], world)

    # surface points of the triggering keyframe in world
    d = depth[rows, cols][:, None]
    dirs = rays_d[rows, cols]
    rays_o, rays_dw = rays_to_world(dirs, pose_world)
    pts = rays_o + rays_dw * d                        # [N,3]

    # top-k nearest related kfs by center distance
    center = jnp.mean(pts, axis=0)
    dists = jnp.linalg.norm(world[:, :3, 3] - center, axis=-1)
    dists = jnp.where(rel_mask, dists, 1e9)
    neg, top_ids = jax.lax.top_k(-dists, k)
    top_valid = -neg < 1e9
    top_world = world[top_ids]

    # visibility of pts in each top kf camera
    w2c = pose_inverse(top_world)                     # [k,4,4]
    pts_cam = jnp.einsum("kij,nj->kni", w2c[:, :3, :3], pts,
                         precision=jax.lax.Precision.HIGHEST) \
        + w2c[:, None, :3, 3]
    uv = jax.vmap(lambda p: project_to_pixel(K_mat, p))(pts_cam)
    vis = ((uv[..., 0] > edge) & (uv[..., 0] < W - edge)
           & (uv[..., 1] > edge) & (uv[..., 1] < H - edge)
           & (pts_cam[..., 2] < 0)
           & top_valid[:, None])                      # [k,N]
    mask_pts = jnp.any(vis, axis=0)

    info = st.localMLP_info[mo_id]
    lo = info[1:4] - 0.5 * info[4:7]
    hi = info[1:4] + 0.5 * info[4:7]
    mask_in = pts_in_bbox(pts, lo[None], hi[None])[:, 0]
    mask_final = mask_pts & mask_in & (d[:, 0] > 0)
    return {
        "top_kf_ids": top_ids, "top_valid": top_valid,
        "counts": jnp.sum(vis, axis=-1), "vis": vis,
        "mask_final": mask_final,
        "n_related": jnp.sum(rel_mask),
        "n_visible": jnp.sum(mask_pts), "n_in_bbox": jnp.sum(mask_in),
        "n_valid": jnp.sum(mask_final),
    }


@partial(jax.jit, static_argnames=("k", "edge", "H", "W", "n_per",
                                   "n_incl", "keyframe_every", "R",
                                   "n_iters"))
def _overlap_verify_icp(st: slam_state.SlamState, depth, rays_d,
                        pose_world, mo_id, active_id, rows, cols, K_mat,
                        kf_frames, cur_frame, rr_src, cc_src, sub_incl,
                        threshold, min_trans, min_count,
                        k: int, edge: int, H: int, W: int, n_per: int,
                        n_incl: int, keyframe_every: int, R: int,
                        n_iters: int = 15):
    """Overlap verification AND ICP rectification as ONE device program
    with ONE batched readback. The keyframe selection between them
    (enough visible overlap points, ref PoseCorrector.py:117-123) runs
    on device: selected top-k ids are stably compacted to the front and
    cycle-padded across the k slots with phased per-slot ray indices, so
    the full icp_dst_n budget lands on the selected keyframes at the
    reference's density with static shapes, and the switch keyframe
    pays one readback instead of two."""
    ver = _overlap_verify(st, depth, rays_d, pose_world, mo_id,
                          active_id, rows, cols, K_mat, kf_frames,
                          k=k, edge=edge, H=H, W=W)
    # device-side keyframe selection + cycle-padding
    sel = (ver["counts"] > min_count) & ver["top_valid"]
    sel = jnp.where(jnp.any(sel), sel, ver["top_valid"])
    order = jnp.argsort(~sel, stable=True)        # selected ids first
    n_used = jnp.maximum(jnp.sum(sel), 1)
    use_ids = ver["top_kf_ids"][order[jnp.arange(k) % n_used]]
    # phased per-slot ray indices: slot i samples segment i // n_used of
    # an even spread over the keyframe ray store
    reps = (k + n_used - 1) // n_used
    total = n_per * reps
    seg = jnp.arange(k)[:, None] // n_used        # [k, 1]
    pos = seg * n_per + jnp.arange(n_per)[None, :]
    sub_dst = jnp.clip(
        (pos * jnp.maximum(R - 1, 1)) // jnp.maximum(total - 1, 1),
        0, R - 1).astype(jnp.int32)               # [k, n_per]
    n_in, pose_final, pose_ini = _switch_icp(
        st, use_ids, depth, rays_d, mo_id, active_id, cur_frame,
        kf_frames, rr_src, cc_src, sub_dst, sub_incl, threshold,
        min_trans, n_per=n_per, n_incl=n_incl,
        keyframe_every=keyframe_every, n_iters=n_iters)
    ver.update({"n_inliers": n_in, "pose_final": pose_final,
                "pose_ini": pose_ini})
    return ver


@partial(jax.jit, static_argnames=("k", "edge", "H", "W", "n_per",
                                   "n_incl", "keyframe_every", "R",
                                   "n_iters"))
def _predicates_verify_fused(st, pose_local, depth, rays_d, wait_id_c,
                             wait_id_raw, min_cr_len, near, far,
                             cr_rows, cr_cols, ov_rows, ov_cols, K_mat,
                             kf_frames, cur_frame, rr_src, cc_src,
                             sub_incl, threshold, min_trans, min_count,
                             db_armed, min_cr_back, min_cr_mo,
                             k: int, edge: int, H: int, W: int,
                             n_per: int, n_incl: int,
                             keyframe_every: int, R: int,
                             n_iters: int = 15):
    """Manager keyframe predicates + speculative overlap-verify + ICP
    as ONE program (see Manager.predicates_fn). The speculative target
    is the wait-loop submap when one is pending, else the
    most-overlapping candidate from the predicates themselves.

    The verify+ICP body is GATED by a lax.cond on the device-computed
    switch predicate: it only executes on keyframes that could actually
    trigger a loop verification (wait-loop pending, armed double
    binding, or the case-5 switch-back test), so ordinary keyframes do
    not pay its device cost to save a readback on the few switch
    keyframes of a sequence. A conservatively wrong gate is safe: the
    host falls back to a separate verify dispatch
    (_find_overlapping_region checks ``spec_ran``)."""
    pred = manager_mod._predicates_fused(
        st, pose_local, depth, rays_d, wait_id_c, min_cr_len, near, far,
        cr_rows, cr_cols)
    spec = jnp.where(wait_id_raw >= 0, wait_id_raw,
                     pred["mo_id"].astype(jnp.int32))
    active = pred["active_id"]
    used = jnp.sum(pred["localMLP_info"][:, 0] > 0)
    not_active = (used > 1) & (spec != active)
    need = (wait_id_raw >= 0) | (
        not_active & ((pred["cr_mo"] >= min_cr_back)
                      | (db_armed & (pred["cr_mo"] >= min_cr_mo))))

    def _run(_):
        return _overlap_verify_icp(
            st, depth, rays_d, pred["pose_world"], spec, active,
            ov_rows, ov_cols, K_mat, kf_frames, cur_frame, rr_src,
            cc_src, sub_incl, threshold, min_trans, min_count,
            k=k, edge=edge, H=H, W=W, n_per=n_per, n_incl=n_incl,
            keyframe_every=keyframe_every, R=R, n_iters=n_iters)

    shapes = jax.eval_shape(_run, 0)
    ver = jax.lax.cond(
        need, _run,
        lambda _: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                               shapes), 0)
    pred.update({f"spec_{kk}": v for kk, v in ver.items()})
    pred["spec_target"] = spec
    pred["spec_ran"] = need
    return pred


@partial(jax.jit,
         static_argnames=("n_per", "n_incl", "keyframe_every", "n_iters"))
def _switch_icp(st: slam_state.SlamState, use_ids, depth, rays_d,
                mo_id, active_id, cur_frame, kf_frames,
                rr_src, cc_src, sub_dst, sub_incl, threshold, min_trans,
                n_per: int, n_incl: int, keyframe_every: int,
                n_iters: int = 15):
    """Switch-pose ICP rectification as ONE device program
    (ref PoseCorrector.switch_pose_rectifying :99-163).

    Target cloud: ``use_ids`` [k] holds the SELECTED keyframes (those
    that saw enough overlap points, ref :117-123), cycle-padded by the
    host across the k slots; ``sub_dst`` [k, n_per] carries per-slot ray
    indices phased so repeated keyframes sample disjoint segments — the
    full icp_dst_n point budget lands on the selected keyframes at the
    reference's density, with static shapes.
    Source cloud: the triggering keyframe's grid rays at the initial
    pose, plus the last ``n_incl`` keyframes' stored rays converted
    through both anchors (ref :137-148; out-of-range slots masked).
    Returns (n_inliers, pose_final, pose_local_ini); pose_final already
    applies the min_trans_dist distrust rule (ref :156-157).
    """
    anchor_prev = _anchor_of(st, active_id)
    anchor_aft = _anchor_of(st, mo_id)
    pose_world = _mm(anchor_prev, st.est_c2w[cur_frame])
    pose_local_ini = _mm(pose_inverse(anchor_aft), pose_world)

    # target cloud in mo_id's local frame
    poses_local_all = _extract_submap_kf_poses(st, mo_id, kf_frames)
    dst_rays = st.kf_rays[use_ids[:, None], sub_dst].reshape(-1, 7)
    pose_idx = jnp.repeat(use_ids, n_per)
    dst_pts, dst_valid = icp_mod.backproject_rays(
        dst_rays, poses_local_all, pose_idx)

    # source cloud: current keyframe grid rays at the initial pose
    d = depth[rr_src, cc_src][:, None]
    dirs = rays_d[rr_src, cc_src]
    dirs_w = dirs @ pose_local_ini[:3, :3].T
    src_pts = pose_local_ini[:3, 3] + dirs_w * d
    src_valid = d[:, 0] > 0

    if n_incl > 0:
        cur_kf = cur_frame // keyframe_every
        prev_locals = _extract_submap_kf_poses(st, active_id, kf_frames)
        rel_anchor = _mm(pose_inverse(anchor_aft), anchor_prev)
        extra_pts, extra_valid = [], []
        for j in range(1, n_incl + 1):
            kj = cur_kf - j
            ok_j = kj >= 0
            kj = jnp.maximum(kj, 0)
            pose_aft = _mm(rel_anchor, prev_locals[kj])
            rays_k = st.kf_rays[kj][sub_incl]
            dk = rays_k[:, 6:7]
            dirs_k = rays_k[:, :3] @ pose_aft[:3, :3].T
            extra_pts.append(pose_aft[:3, 3] + dirs_k * dk)
            extra_valid.append((dk[:, 0] > 0) & ok_j)
        src_pts = jnp.concatenate([src_pts] + extra_pts, axis=0)
        src_valid = jnp.concatenate([src_valid] + extra_valid, axis=0)

    normals = icp_mod.estimate_normals(dst_pts, k=10)
    res = icp_mod.icp_point_to_plane(
        src_pts, src_valid, dst_pts, dst_valid, normals,
        threshold, n_iters=n_iters)
    rel = jnp.where(jnp.linalg.norm(res.transform[:3, 3]) >= min_trans,
                    jnp.eye(4, dtype=res.transform.dtype),
                    res.transform)   # distrust large corrections
    return res.n_inliers, _mm(rel, pose_local_ini), pose_local_ini


# Jitted per-stage step programs, shared ACROSS system instances: the
# steps close over only hashable static configs, with all device data
# (state, params, consts, PRNG keys) passed as arguments. A fresh
# MIPSFusionTPU (benchmark passes, --resume restarts, multi-sequence
# batch jobs) therefore reuses the already-compiled executables instead
# of paying a multi-second compile-cache reload per big program.
_STEP_CACHE: Dict = {}

_extract_poses_jit = jax.jit(_extract_submap_kf_poses)
_writeback_jit = jax.jit(_writeback_ba_poses)


def _get_ba_step(fcfg, mcfg, lw, n_rays, ray_sharding):
    ck = ("ba", fcfg, mcfg, lw, n_rays, ray_sharding)
    fn = _STEP_CACHE.get(ck)
    if fn is not None:
        return fn

    def step(st, params, opt_state, cur_rays, i, consts, ba_key,
             kf_frames):
        active = st.active_submap_id
        kf_mask = slam_state.submap_kf_mask(st, active)
        first_kf = st.localMLP_first_kf[active]
        last_kf = jnp.max(
            jnp.where(kf_mask, jnp.arange(kf_mask.shape[0]), -1))
        poses_local = _extract_submap_kf_poses(st, active, kf_frames)
        key = jax.random.fold_in(ba_key, i)
        res = mapper.local_ba(
            params, opt_state, key, st.kf_rays, kf_mask, first_kf,
            last_kf, poses_local, cur_rays, st.est_c2w[i], fcfg, consts,
            mcfg, lw, n_rays, ray_sharding=ray_sharding)
        opt_poses = qt_to_matrix(res.kf_quat, res.kf_trans)
        st = _writeback_ba_poses(st, active, kf_mask, opt_poses, kf_frames)
        if mcfg.optim_cur:
            st = st._replace(est_c2w=st.est_c2w.at[i].set(
                qt_to_matrix(res.cur_quat, res.cur_trans)))
        return st, res.field_params, res.map_opt_state

    fn = jax.jit(step)
    _STEP_CACHE[ck] = fn
    return fn


def _get_refine_step(fcfg, mcfg, lw, n_rays, ray_sharding):
    ck = ("refine", fcfg, mcfg, lw, n_rays, ray_sharding)
    fn = _STEP_CACHE.get(ck)
    if fn is not None:
        return fn
    map_opt = mapper.make_map_optimizer(mcfg)

    def step(st, params, kf_mask, m, i, consts, refine_key, kf_frames):
        first_kf = st.localMLP_first_kf[m]
        last_kf = jnp.max(
            jnp.where(kf_mask, jnp.arange(kf_mask.shape[0]), -1))
        poses_local = _extract_submap_kf_poses(st, m, kf_frames)
        # fresh optimizer per round (the reference creates one per
        # call, ref InactiveMap.py:213)
        opt_state = map_opt.init(params)
        key = jax.random.fold_in(refine_key, i)
        dummy_cur = jnp.zeros((8, 7))
        res = mapper.local_ba(
            params, opt_state, key, st.kf_rays, kf_mask, first_kf,
            last_kf, poses_local, dummy_cur, jnp.eye(4), fcfg, consts,
            mcfg, lw, n_rays, include_current=False,
            ray_sharding=ray_sharding)
        opt_poses = qt_to_matrix(res.kf_quat, res.kf_trans)
        st = _writeback_ba_poses(st, m, kf_mask, opt_poses, kf_frames)
        return st, res.field_params

    fn = jax.jit(step)
    _STEP_CACHE[ck] = fn
    return fn


@jax.jit
def _switch_state_update(st, i, rectified, back_id):
    """Switch-back bookkeeping as ONE device program (instead of an
    eager gather, two scatters and a read). Returns (new state, the pre-rectification local pose
    needed as temp_local_pose by the subsequent PGO)."""
    temp = st.est_c2w[i]
    st = st._replace(
        active_first_kf=st.localMLP_first_kf[back_id],
        last_switch_frame=i,
        est_c2w=st.est_c2w.at[i].set(rectified))
    return st, temp


@jax.jit
def _global_pgo(st, local_prev, local_aft, aft_id, prev_id, used, key_w):
    """Pose-graph optimization after a loop closure as ONE device
    program with ZERO readbacks (ref InactiveMap.global_BA :478-497 ->
    PoseCorrector.pose_graph_optimize :173-216): anchors, edge
    assembly, the damped-GN solve and the anchor write-back all stay on
    device; the scalar ids arrive from the host binding mirror."""
    M = st.localMLP_info.shape[0]
    Nk = st.kf_c2w.shape[0]
    first_kf = jnp.clip(st.localMLP_first_kf, 0, Nk - 1)
    anchors = st.kf_c2w[first_kf]

    pairs = np.asarray([(a, b) for a in range(M) for b in range(a + 1, M)],
                       np.int32).reshape(-1, 2)
    pi, pj = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    rels = jax.vmap(lambda a, b: _mm(pose_inverse(b), a))(
        anchors[pi], anchors[pj])
    key_rel = _mm(local_prev, pose_inverse(local_aft))
    rels = jnp.concatenate([rels, key_rel[None]], axis=0)
    edges = jnp.concatenate(
        [jnp.asarray(pairs),
         jnp.stack([aft_id, prev_id]).astype(jnp.int32)[None]], axis=0)
    w = ((st.localMLP_adjacent[pi, pj] > 0)
         & (pi < used) & (pj < used)).astype(jnp.float32)
    weights = jnp.concatenate([w, key_w[None].astype(jnp.float32)])
    node_mask = (jnp.arange(M) >= 1) & (jnp.arange(M) < used)

    nodes, _cost = pose_graph.optimize_pose_graph(
        anchors, edges, rels, weights, node_mask, n_iters=10)
    valid = jnp.arange(M) < used
    idx = jnp.where(valid, first_kf, Nk)   # out-of-range rows drop
    kf_c2w = st.kf_c2w.at[idx].set(nodes, mode="drop")
    return st._replace(kf_c2w=kf_c2w)


@partial(jax.jit, static_argnames=("fcfg", "n_iters", "n_total",
                                   "pose_accum_step"))
def _switch_ba_fused(st, params, key, kf_mask, frame_rays, i, kf_frames,
                     fcfg, consts, lw, lr_rot, lr_trans, n_iters, n_total,
                     pose_accum_step):
    """Switch-time pose-only BA as ONE device program: local-pose
    extraction, the BA scan and the pose write-back fused (the eager
    extract chain alone cost ~15 dispatches per switch event)."""
    poses_local = _extract_submap_kf_poses(st, st.active_submap_id,
                                           kf_frames)
    pose_opt, _ = mapper.switch_ba(
        params, key, st.kf_rays, kf_mask, poses_local, frame_rays,
        st.est_c2w[i], fcfg, consts, lw, lr_rot, lr_trans,
        n_iters, n_total, pose_accum_step)
    return st._replace(est_c2w=st.est_c2w.at[i].set(pose_opt))


class MIPSFusionTPU:
    """Online multi-implicit-submap RGB-D SLAM."""

    def __init__(self, config: Dict, dataset=None):
        self.config = config
        if dataset is None:
            from ..datasets import get_dataset
            dataset = get_dataset(config)
        self.dataset = dataset

        H, W = dataset.H, dataset.W
        self.H, self.W = H, W

        # static configs
        self.fcfg = sr.for_platform(sr.FieldConfig.from_dict(config),
                                    jax.default_backend())
        # Per-stage z-sampling budgets: tracking may run a leaner
        # z-ladder than mapping (``tracking.n_samples_d`` /
        # ``tracking.n_range_d`` override the shared ``training.*``
        # values for GO only); no multi-seed verdict on them exists yet
        # (ROADMAP A4).
        import dataclasses as _dc
        _tz = {k: config["tracking"][k] for k in
               ("n_samples_d", "n_range_d") if k in config["tracking"]}
        self.fcfg_track = _dc.replace(self.fcfg, **_tz) if _tz else self.fcfg
        self.rcfg = tracker.ROConfig.from_dict(config)
        self.gcfg = tracker.GOConfig.from_dict(config)
        self.dgcfg = tracker.DriftGateConfig.from_dict(config)
        if self.dgcfg.thresh <= 0.0:
            self.dgcfg = None    # gate off: tracker runs the exact
                                 # reference-default program
        self.mcfg = mapper.MapConfig.from_dict(config)
        self.lw = sr.LossWeights.from_dict(config)

        m = config["mapping"]
        self.keyframe_every = m["keyframe_every"]
        self.kf_strain_mask = float(m.get("kf_strain_mask", 0.0))
        self.map_every = m["map_every"]
        # state capacities are BUCKETED (next multiple of 256 frames) so
        # different sequence lengths share compiled programs — otherwise
        # every est_c2w[n_frames] shape change recompiles the whole
        # track/BA pipeline
        n_frames = -(-dataset.num_frames // 256) * 256
        num_kf = n_frames // self.keyframe_every + 1

        samp = config["sampling"]
        self.cap = slam_state.StateCapacity(
            n_frames=n_frames,
            n_keyframes=num_kf,
            n_submaps=m["localMLP_num"],
            rays_per_kf=samp["kf_n_rays_h"] * samp["kf_n_rays_w"],
            kf_rays_h=samp["kf_n_rays_h"],
            kf_rays_w=samp["kf_n_rays_w"],
        )
        self.state = slam_state.init_state(self.cap, m["localMLP_max_len"])
        self.kf_rows, self.kf_cols = slam_state.kf_downsample_indices(
            H, W, samp["kf_n_rays_h"], samp["kf_n_rays_w"])
        # lazily-built index caches for the fused switch programs
        self._ovlp_grid = None
        self._icp_subs = None

        # normalization constants of the active submap's field
        if self.fcfg.use_bound_normalize:
            self.consts = sr.FieldConsts.from_bound(
                jnp.asarray(m["bound"], jnp.float32))
        else:
            self.consts = sr.FieldConsts.from_norm_factor(
                jnp.asarray(m["localMLP_max_len"], jnp.float32))

        # submap fields: list of identically-shaped param pytrees. All
        # submaps start from the SAME initial params — the reference
        # stores init values and recovers them on submap creation
        # (ref scene_rep.py:49-55, mipsfusion.py:648).
        self.key = jax.random.PRNGKey(config.get("seed", 0))
        self.key, k0, kpst = jax.random.split(self.key, 3)
        self.initial_params = sr.init_field_params(k0, self.fcfg)
        self.submap_params: List[Optional[Dict]] = [None] * self.cap.n_submaps
        self.submap_params[0] = self.initial_params
        self.active_id = 0

        self.map_opt = mapper.make_map_optimizer(self.mcfg)
        self.map_opt_state = self.map_opt.init(self.initial_params)
        # adam's init is zeros-of-param-shapes: identical for every
        # submap, so switches reuse this pytree instead of re-running
        # the eager init tree (~#leaves dispatches per switch event)
        self._fresh_opt_state = self.map_opt_state

        self.pst = tracker.make_pst(kpst, self.rcfg)

        # multi-submap machinery
        self.use_manager = config.get("use_manager", True)
        self.manager = manager_mod.Manager(
            manager_mod.ManagerConfig.from_dict(config), H, W,
            self.keyframe_every)
        self.manager.find_overlap_fn = self._find_overlapping_region
        self.manager.predicates_fn = self._manager_predicates_with_verify
        t = config["tracking"]
        self.switch_interval = t.get("switch_interval", 30)
        sw = t.get("switch", {})
        self.sw_align_threshold = sw.get("align_threshold", 0.05)
        self.sw_min_corr = sw.get("min_correspondence", 2000)
        self.sw_min_trans = sw.get("min_trans_dist", 0.5)
        self.sw_including_last = int(sw.get("including_last", 0))
        self.sw_map_num = sw.get("map_num", 15)
        self.sw_lr_rot = sw.get("lr_rot", 0.001)
        self.sw_lr_trans = sw.get("lr_trans", 0.001)
        self.sw_iter_ro = sw.get("iter_RO", 10)
        self.sw_iter_go = sw.get("iter", 20)
        self.key_edge_weight = m.get("global_BA", {}).get(
            "key_edge_weight", 0.1)
        self.near_kf_num = 10  # ref keyframeSet.py:70
        # Deferred new-submap init: the reference runs the 500-iter
        # first fit CONCURRENTLY with tracking in the mapping process
        # (ref mipsfusion.py:198-222 overlap :470-576); in this
        # sequenced loop the same overlap is re-expressed by splitting
        # the fit into fixed-size chunks interleaved with the tracked
        # frames, so no single frame pays the whole fit. 0 = disabled
        # (whole fit on the switch frame, round-2 behavior).
        self.init_chunk = int(m.get("first_iters_chunk", 0))
        self._pending_init_iters = 0
        self._pending_init_rays = None
        # Deferred switch-back PGO: drains on the frame after the switch
        # keyframe (the reference defers global BA to the background
        # process the same way, ref mipsfusion.py:700-706 ->
        # InactiveMap.py:531-533; switch-BA stays synchronous like the
        # reference's ActiveMap — see _drain_switch_chain)
        self.switch_chain_defer = bool(m.get("switch_chain_defer", True))
        self._pending_switch: Optional[Dict] = None
        self._last_verify: Optional[Dict] = None
        # ICP cloud subsampling (the reference feeds full 30k-ray clouds
        # to open3d; we subsample for the brute-force NN matmul and scale
        # the min-correspondence threshold accordingly)
        self.icp_src_n = min(2048, self.cap.rays_per_kf)
        self.icp_dst_n = 4096
        self.optim_cur = self.mcfg.optim_cur

        # background refinement (InactiveMap round-robin). On a
        # multi-chip mesh the round-robin becomes ONE sharded step:
        # every inactive submap refines concurrently, its params placed
        # on its own chip group (parallel/sharding.py submap axis) —
        # the InactiveMap-on-other-chips design from ARCHITECTURE.md.
        self.inactive_started = False
        self._inactive_rr = 0
        self.n_devices = len(jax.devices())
        par = config.get("parallel", {})
        self.use_sharded_refine = (
            self.n_devices > 1 and par.get("sharded_refine", True))
        # ray data-parallelism on the HOT PATH (local BA + submap init):
        # the per-iteration ray batch is sharded over the mesh's data
        # axis, field/pose params replicated, gradient all-reduce
        # inserted by XLA (SURVEY §2.11 rays-across-devices;
        # parallel/sharding.py)
        self.use_dp_hot = (
            self.n_devices > 1 and par.get("dp_hot_path", True))
        self._sharded_refine_cache: Dict[int, object] = {}
        self._mesh = None
        self._ray_sharding = None
        if self.use_sharded_refine or self.use_dp_hot:
            from ..parallel import sharding as sh
            self._mesh = sh.make_mesh(self.n_devices)
            if self.use_dp_hot:
                self._ray_sharding = sh.ray_sharded(self._mesh)

        # on-demand in-loop meshing (the reference's mesh_flag hook,
        # ref InactiveMap.py:526-529 — there the flag is polled by the
        # background process; here the request is honored by run() at
        # the next frame boundary). mesh.mesh_freq > 0 additionally
        # requests a mesh every mesh_freq frames.
        self._mesh_request: Optional[int] = None

        # per-frame device sync in run() (off for production: the
        # zero-sync pipeline is the perf model). Needed on single-core
        # hosts running virtual multi-device meshes, where a collective
        # left in flight during a long jit compile can starve the CPU
        # rendezvous past its 40 s hard timeout (SIGABRT).
        self._sync_per_frame = bool(config.get("sync_per_frame", False))

        # loop-closure transient state
        self.debug_loop = bool(config.get("debug_loop", False))
        self.rectified_local_pose: Optional[jnp.ndarray] = None
        self.temp_local_pose: Optional[jnp.ndarray] = None
        self.key_kf_id = -1

        # jitted wrappers over pure state->array helpers (one dispatch
        # instead of one per eager op)
        self._kf_frames_dev = jnp.asarray(self._kf_frames())
        self._extract_poses_jit = lambda st, m: _extract_poses_jit(
            st, m, self._kf_frames_dev)
        self._writeback_jit = lambda st, m, mask, poses: _writeback_jit(
            st, m, mask, poses, self._kf_frames_dev)
        # per-stage base PRNG keys: the per-frame key is derived on
        # device (fold_in) inside the jitted steps — no per-frame
        # host-side splits or uploads
        self.key, ktr, kba, krf = jax.random.split(self.key, 4)
        self._track_key, self._ba_key, self._refine_key = ktr, kba, krf

        # host mirrors of slow-changing state (updated at keyframe
        # cadence) so the steady-state loop never blocks on device
        # readbacks: submap count, keyframe count, keyframe bindings
        self._host_used = 0
        self._host_n_kf = 0
        self._host_kf_bind = np.full((self.cap.n_keyframes, 2), -1,
                                     np.int32)

        # host-side trackers
        self.track_losses: List[float] = []
        self.track_accepted: List = []
        self.track_rescued: List = []
        self.track_drift: List = []
        # pose-gate state: EWMA of accepted tracking losses (device
        # scalar; -1 = unseeded). Reset at submap switches, where the
        # loss distribution legitimately changes.
        self._loss_ewma = jnp.asarray(-1.0, jnp.float32)
        self._prev_loss = jnp.asarray(-1.0, jnp.float32)
        self.last_switch_frame = 0
        self._gt_cache: Dict[int, np.ndarray] = {}

        # drift-gate anchor: the last keyframe's strided cloud + normals
        # (immutable sensor data — the only reference the basin slide
        # cannot drag, see tracker.DriftGateConfig). kf_frame -1 =
        # disarmed (fresh submap / after a switch, until the next
        # keyframe lays a new anchor in the new local frame).
        self._gate_pts = self._gate_normals = self._gate_valid = None
        self._gate_kf_frame = jnp.asarray(-1, jnp.int32)
        self._last_drift = jnp.asarray(0.0, jnp.float32)
        self._prev_rescued = jnp.asarray(False)
        self.n_rescued = 0
        if self.dgcfg is not None:
            # pre-allocate a disarmed anchor so the tracking program is
            # ONE jit variant whether or not an anchor exists yet
            M = self.dgcfg.anchor_rows * self.dgcfg.anchor_cols
            self._gate_pts = jnp.full((M, 3), 1e6, jnp.float32)
            self._gate_normals = jnp.zeros((M, 3), jnp.float32)
            self._gate_valid = jnp.zeros((M,), bool)

        out = config.get("data", {}).get("output")
        self.output_dir = None
        if out:
            self.output_dir = os.path.join(
                out, config["data"].get("exp_name", "exp"))
            os.makedirs(self.output_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _packed(self, frame: Dict) -> jnp.ndarray:
        """Device-resident packed frame [H, W, 7] = (direction, rgb,
        depth), cached by frame id — track/BA/keyframe stages all consume
        the same array (slicing happens on device).

        Datasets that render or prefetch on device expose ``packed``
        (zero per-frame host->device traffic); otherwise the frame dict's
        numpy arrays are packed once and uploaded in one transfer.
        """
        fid = frame.get("frame_id")
        if getattr(self, "_packed_fid", None) == fid and fid is not None:
            return self._packed_frame
        if hasattr(self.dataset, "packed") and fid is not None:
            arr = self.dataset.packed(fid)
        else:
            arr = jnp.asarray(np.concatenate(
                [np.asarray(frame["direction"]), np.asarray(frame["rgb"]),
                 np.asarray(frame["depth"])[..., None]], axis=-1))
        self._packed_frame = arr
        self._packed_fid = fid
        return arr

    def _frame_arrays(self, frame: Dict):
        arr = self._packed(frame)
        return arr[..., 3:6], arr[..., 6], arr[..., :3]

    def _next_key(self):
        self.key, k = jax.random.split(self.key)
        return k

    def _round_rays(self, n: int) -> int:
        """Round a per-iteration ray budget up to a multiple of the
        data-axis size (sharded batches must divide evenly)."""
        if self._ray_sharding is None:
            return n
        d = self.n_devices
        return -(-n // d) * d

    def _kf_frames(self):
        K = self.cap.n_keyframes
        return np.minimum(np.arange(K) * self.keyframe_every,
                          self.cap.n_frames - 1)

    def _anchor(self, st: slam_state.SlamState, submap_id) -> jnp.ndarray:
        return st.kf_c2w[st.localMLP_first_kf[submap_id]]

    def extract_submap_kf_poses(self, st: slam_state.SlamState,
                                submap_id: int) -> jnp.ndarray:
        return _extract_submap_kf_poses(st, submap_id,
                                        jnp.asarray(self._kf_frames()))

    def writeback_ba_poses(self, st: slam_state.SlamState, submap_id: int,
                           kf_mask: jnp.ndarray, opt_poses: jnp.ndarray
                           ) -> slam_state.SlamState:
        return _writeback_ba_poses(st, submap_id, kf_mask, opt_poses,
                                   jnp.asarray(self._kf_frames()))

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def first_frame_mapping(self, frame: Dict, n_iters: int):
        """Initialize submap 0 on frame 0 (ref mipsfusion.py:155-194)."""
        rgb, depth, direction = self._frame_arrays(frame)
        st = self.state
        c2w_world = jnp.asarray(frame["c2w"], jnp.float32)
        self._host_used = 1
        self._host_n_kf = 1
        self._host_kf_bind[0] = (0, -1)

        from ..ops.geometry import get_frame_surface_bbox
        center, length = get_frame_surface_bbox(
            c2w_world, depth, direction,
            self.config["cam"]["near"], self.config["cam"]["far"])

        st = st._replace(
            kf_c2w=st.kf_c2w.at[0].set(c2w_world),
            est_c2w=st.est_c2w.at[0].set(jnp.eye(4)),
            keyframe_ref=st.keyframe_ref.at[0].set(-1),
            localMLP_first_kf=st.localMLP_first_kf.at[0].set(0),
            localMLP_info=st.localMLP_info.at[0].set(
                jnp.concatenate([jnp.ones(1), center, length])),
            keyframe_localMLP=st.keyframe_localMLP.at[0, 0].set(0),
        )

        frame_rays = self._packed_frame
        params, opt_state, _ = mapper.init_submap_fit(
            self.submap_params[0], self.map_opt_state, self._next_key(),
            frame_rays.reshape(-1, 7), self.fcfg, self.consts, self.mcfg,
            self.lw, n_iters,
            self._round_rays(self.mcfg.mapping_sample_init),
            ray_sharding=self._ray_sharding)
        self.submap_params[0] = params
        self.map_opt_state = opt_state

        st = slam_state.add_keyframe(st, frame_rays, 0,
                                     self.kf_rows, self.kf_cols)
        self.state = st
        self._gate_anchor_update(frame_rays, 0)

    def track(self, frame: Dict, i: int, switch_tracking: bool = False):
        """Track frame i against the active submap (ref :470-576).

        ONE jitted dispatch: motion model, RO, GO, and the pose-store
        epilogue all run on device (tracker.track_frame_update); the
        loss stays on device so the steady loop never syncs.
        """
        packed = self._packed(frame)
        st = self.state
        if switch_tracking:
            use_cs = False
            n_ro, n_go = self.sw_iter_ro, self.sw_iter_go
        else:
            use_cs = bool(self.config["tracking"]["const_speed"]
                          and (i - self.last_switch_frame) >= 2)
            n_ro, n_go = self.rcfg.n_iters, self.gcfg.n_iters

        upd = tracker.track_frame_update(
            self.submap_params[self.active_id], self.fcfg_track,
            self.consts,
            self.rcfg, self.gcfg, self.pst, self._track_key, packed,
            st.est_c2w, st.est_c2w_rel, st.keyframe_ref, i, use_cs,
            bool(switch_tracking), st.active_first_kf, self.lw,
            n_ro, n_go, self.keyframe_every,
            from_current=bool(switch_tracking),
            loss_ewma=self._loss_ewma,
            prev_loss=self._prev_loss,
            ray_sharding=self._ray_sharding,
            dgcfg=self.dgcfg, gate_pts=self._gate_pts,
            gate_normals=self._gate_normals, gate_valid=self._gate_valid,
            gate_kf_frame=self._gate_kf_frame,
            prev_rescued=self._prev_rescued)
        self.state = st._replace(est_c2w=upd.est_c2w,
                                 est_c2w_rel=upd.est_c2w_rel,
                                 keyframe_ref=upd.keyframe_ref)
        self._loss_ewma = upd.loss_ewma       # device scalar, no sync
        self._prev_loss = upd.loss            # escalation signal
        self._last_drift = upd.drift_res      # device scalar, no sync
        self._prev_rescued = upd.rescued      # motion-model suppressor
        self.track_losses.append(upd.loss)
        self.track_accepted.append(upd.accepted)
        if self.dgcfg is not None:
            self.track_rescued.append(upd.rescued)
            self.track_drift.append(upd.drift_res)
            if not switch_tracking:
                # device-refreshed anchor state (tracker.TrackUpdate)
                self._gate_pts = upd.gate_pts
                self._gate_normals = upd.gate_normals
                self._gate_valid = upd.gate_valid
                self._gate_kf_frame = upd.gate_kf_frame

    def do_local_ba(self, frame: Dict, i: int):
        """Local BA on the active submap (ref :259-370). ONE dispatch
        (the fused step: mask + pose extraction + BA scan + pose
        write-back; shared across instances via _STEP_CACHE)."""
        cur_rays = self._packed(frame).reshape(-1, 7)
        optim_cur = bool(self.optim_cur or self.mcfg.optim_cur)
        mcfg = self.mcfg
        if optim_cur and not mcfg.optim_cur:
            mcfg = mapper.MapConfig(**{**mcfg.__dict__, "optim_cur": True})
        step = _get_ba_step(self.fcfg, mcfg, self.lw,
                            self._round_rays(mcfg.sample + mcfg.pixels_cur),
                            self._ray_sharding)
        st, params, opt_state = step(
            self.state, self.submap_params[self.active_id],
            self.map_opt_state, cur_rays, i, self.consts, self._ba_key,
            self._kf_frames_dev)
        self.state = st
        self.submap_params[self.active_id] = params
        self.map_opt_state = opt_state

    def _gate_anchor_update(self, packed, i: int):
        """Arm the drift-gate anchor from frame ``i``'s packed data
        (first-frame arming; the steady loop refreshes the anchor ON
        DEVICE inside the tracking dispatch — tracker.TrackUpdate)."""
        if self.dgcfg is None:
            return
        self._gate_pts, self._gate_normals, self._gate_valid = \
            tracker.gate_anchor(packed, self.dgcfg.anchor_rows,
                                self.dgcfg.anchor_cols)
        self._gate_kf_frame = jnp.asarray(i, jnp.int32)

    def _gate_disarm(self):
        """Drop the drift-gate anchor (submap switch / resume: est_c2w
        re-expresses in a new local frame, so the anchor's stored pose
        index no longer matches until the next keyframe)."""
        if self.dgcfg is not None:
            self._gate_kf_frame = jnp.asarray(-1, jnp.int32)

    def add_keyframe(self, frame: Dict, i: int):
        packed = self._packed(frame)
        if self.kf_strain_mask > 0.0:
            # Keyframe-poisoning guard (mapping.kf_strain_mask rel
            # threshold, 0 = off): a keyframe tracked under strain
            # (loss > rel x accepted-loss EWMA — the same on-device
            # signal as the pose gate) stores ZERO-DEPTH rays, which are
            # inert in every loss term (ops/losses.get_masks depth_mask;
            # rgb weighted by training.rgb_missing for invalid depth) —
            # so a slipped pose cannot bake itself into the BA/refine
            # supervision. The keyframe still exists for manager/anchor
            # bookkeeping. Motivated by the round-5 sweep-lottery trace
            # (tools/diag_sweep.py): divergence onset keyframes carried
            # 0.6-1.0 m pose error into the ray store.
            strained = (self._loss_ewma > 0.0) & \
                (self._prev_loss > self.kf_strain_mask * self._loss_ewma)
            packed = packed.at[..., 6].multiply(
                jnp.where(strained, 0.0, 1.0))
        st = slam_state.add_keyframe(self.state, packed, i,
                                     self.kf_rows, self.kf_cols)
        kf_id = i // self.keyframe_every
        if not self.use_manager:
            st = st._replace(keyframe_localMLP=st.keyframe_localMLP.at[
                kf_id, 0].set(st.active_submap_id.astype(jnp.int32)))
            self._host_kf_bind[kf_id] = (self.active_id, -1)
        self._host_n_kf = max(self._host_n_kf, kf_id + 1)
        self.state = st

    # ------------------------------------------------------------------
    # submap switching (ref mipsfusion.py:607-653)
    # ------------------------------------------------------------------

    def active_submap_switch_new(self, frame: Dict, i: int, kf_id: int):
        """Create + initialize a fresh submap (ref :639-653 + :198-222).

        The previous submap's params are already archived in
        submap_params[prev]; the new submap starts from the shared
        initial params and gets the first-frame fit.
        """
        self._flush_pending_init()
        self._flush_pending_switch()
        st = self.state
        lb = self.manager.last_binding if self.use_manager else None
        new_id = (int(lb[1][0]) if lb is not None
                  else int(np.asarray(st.active_submap_id)))
        self.submap_params[new_id] = self.initial_params
        self.map_opt_state = self._fresh_opt_state
        self.active_id = new_id
        self._host_used = max(self._host_used, new_id + 1)
        self.last_switch_frame = i
        self._loss_ewma = jnp.asarray(-1.0, jnp.float32)  # new loss regime
        self._prev_loss = jnp.asarray(-1.0, jnp.float32)
        self._gate_disarm()
        st = st._replace(active_first_kf=jnp.asarray(kf_id, jnp.int32),
                         last_switch_frame=jnp.asarray(i, jnp.int32))
        self.state = st
        self.inactive_started = True

        rgb, depth, direction = self._frame_arrays(frame)
        rays = self._packed_frame.reshape(-1, 7)
        total = self.mcfg.first_iters
        if 0 < self.init_chunk < total:
            # run one chunk now; the rest drains one chunk per tracked
            # frame (= the ref's concurrent-fit semantics: tracking
            # proceeds against the still-training submap)
            self._pending_init_rays = rays
            self._pending_init_iters = total
            self._drain_init_chunk()
        else:
            params, opt_state, _ = mapper.init_submap_fit(
                self.submap_params[new_id], self.map_opt_state,
                self._next_key(), rays, self.fcfg,
                self.consts, self.mcfg, self.lw, total,
                self._round_rays(self.mcfg.mapping_sample_init),
                ray_sharding=self._ray_sharding)
            self.submap_params[new_id] = params
            self.map_opt_state = opt_state

    def _drain_init_chunk(self):
        """One fixed-size chunk of the deferred first fit (single
        compiled shape: always ``init_chunk`` iters, overshooting
        ``first_iters`` by < one chunk on the last frame)."""
        params, opt_state, _ = mapper.init_submap_fit(
            self.submap_params[self.active_id], self.map_opt_state,
            self._next_key(), self._pending_init_rays, self.fcfg,
            self.consts, self.mcfg, self.lw, self.init_chunk,
            self._round_rays(self.mcfg.mapping_sample_init),
            ray_sharding=self._ray_sharding)
        self.submap_params[self.active_id] = params
        self.map_opt_state = opt_state
        self._pending_init_iters -= self.init_chunk
        if self._pending_init_iters <= 0:
            self._pending_init_iters = 0
            self._pending_init_rays = None

    def _flush_pending_init(self):
        """Finish any deferred init synchronously (before events that
        must see a fully-fit submap: switches, meshing, checkpoints)."""
        while self._pending_init_iters > 0:
            self._drain_init_chunk()

    def active_submap_switch(self, frame: Dict, i: int, kf_id: int):
        """Switch back to a previous submap (ref :607-635): the model
        handoff is an index swap; the tracked pose is replaced by the
        ICP-rectified local pose computed during overlap verification."""
        self._flush_pending_init()
        self._flush_pending_switch()
        st = self.state
        lb = self.manager.last_binding if self.use_manager else None
        back_id = (int(lb[1][0]) if lb is not None
                   else int(np.asarray(st.active_submap_id)))
        self.active_id = back_id
        self.map_opt_state = self._fresh_opt_state
        self.last_switch_frame = i
        st, self.temp_local_pose = _switch_state_update(
            st, jnp.asarray(i, jnp.int32), self.rectified_local_pose,
            jnp.asarray(back_id, jnp.int32))
        self.state = st
        self.optim_cur = True
        self.inactive_started = True
        self._loss_ewma = jnp.asarray(-1.0, jnp.float32)  # new loss regime
        self._prev_loss = jnp.asarray(-1.0, jnp.float32)
        self._gate_disarm()

    def local_ba_switch(self, frame: Dict, kf_id: int, i: int):
        """Pose-only BA of the loop keyframe vs the switched-to submap
        (ref :379-444). Runs synchronously on the switch frame, exactly
        as the reference's ActiveMap does (ref :703)."""
        st = self.state
        data = self.manager.ovlp_data or {}
        top_kf_ids = data.get("top_kf_ids")
        if top_kf_ids is None or len(top_kf_ids) == 0:
            return
        kf_mask = np.zeros(self.cap.n_keyframes, bool)
        kf_mask[np.asarray(top_kf_ids)] = True
        frame_rays = self._packed_frame.reshape(-1, 7)

        self.state = _switch_ba_fused(
            st, self.submap_params[self.active_id], self._next_key(),
            jnp.asarray(kf_mask), frame_rays,
            jnp.asarray(i, jnp.int32), self._kf_frames_dev,
            self.fcfg, self.consts, self.lw, self.sw_lr_rot,
            self.sw_lr_trans, self.sw_map_num, self.mcfg.sample,
            self.mcfg.pose_accum_step)

    def _drain_switch_chain(self):
        """The deferred pose-graph optimization of a switch-back, run on
        the frame after the switch keyframe — the re-expression of the
        reference's background global-BA deferral (ref
        mipsfusion.py:700-706 sets do_globalBA; InactiveMap.py:531-533
        picks it up whenever the background process gets there; the
        switch-time local_BA_switch stays SYNCHRONOUS in the reference's
        ActiveMap, ref :703, and here too — an A/B that also deferred it
        destabilized the return leg: outback full-budget ATE 9.4 ->
        260 mm with a missed switch-back)."""
        ps = self._pending_switch
        if ps is None:
            return
        self.global_ba(ids=ps["ids"])
        self._pending_switch = None

    def _flush_pending_switch(self):
        """Finish deferred switch work synchronously (before events that
        must see converged poses/anchors: another switch, meshing,
        checkpoints, evaluation)."""
        while self._pending_switch is not None:
            self._drain_switch_chain()

    # ------------------------------------------------------------------
    # loop-closure verification (ref Manager.find_overlapping_region
    # :261-352 + PoseCorrector.switch_pose_rectifying :99-163)
    # ------------------------------------------------------------------

    def _kf_world_poses(self, st: slam_state.SlamState,
                        kf_ids: np.ndarray) -> jnp.ndarray:
        """World poses of given keyframes (ref convert_given_world_pose).
        Off the hot path (mesh extraction); the switch path computes the
        same quantity inside _overlap_verify."""
        kf_frames = self._kf_frames()
        first_bind = np.asarray(st.keyframe_localMLP[:, 0])[kf_ids]
        anchors = st.kf_c2w[st.localMLP_first_kf[
            jnp.asarray(np.clip(first_bind, 0, None))]]
        local = st.est_c2w[jnp.asarray(kf_frames[kf_ids])]
        kf_ref = np.asarray(st.keyframe_ref)[kf_ids]
        world = jnp.einsum("kij,kjl->kil", anchors, local,
                           precision=jax.lax.Precision.HIGHEST)
        # first keyframes: kf_c2w directly
        world = jnp.where((kf_ref == -1)[:, None, None],
                          st.kf_c2w[jnp.asarray(kf_ids)], world)
        return world

    def _verify_statics(self):
        """Shared static inputs of the fused verify+ICP program."""
        mcfg_mgr = self.manager.cfg
        if self._ovlp_grid is None:
            self._ovlp_grid = manager_mod.uniform_grid(
                self.H, self.W, mcfg_mgr.ovlp_rays_h, mcfg_mgr.ovlp_rays_w)
        R = self.cap.rays_per_kf
        if self._icp_subs is None:
            src_sub = np.linspace(0, len(self.kf_rows) - 1,
                                  self.icp_src_n).astype(np.int32)
            self._icp_subs = (
                jnp.asarray(np.asarray(self.kf_rows)[src_sub]),
                jnp.asarray(np.asarray(self.kf_cols)[src_sub]),
                jnp.asarray(np.linspace(0, R - 1,
                                        self.icp_src_n).astype(np.int32)))
        K_mat = jnp.asarray([[self.dataset.fx, 0.0, self.dataset.cx],
                             [0.0, self.dataset.fy, self.dataset.cy],
                             [0.0, 0.0, 1.0]])
        # reference uses a fixed 20px margin on 1200x680 images
        # (ref Manager.py:323); keep it proportional (~3%) so small test
        # images are not dominated by the margin
        edge = max(2, int(round(0.03 * min(self.H, self.W))))
        # keyframe-selection visibility threshold: the reference demands
        # > 200 visible points of its 40x40=1600 overlap grid
        # (ref PoseCorrector.py:117-123); scale to the configured grid
        # like need_icp scales min_correspondence by icp_src_n/R
        n_grid = mcfg_mgr.ovlp_rays_h * mcfg_mgr.ovlp_rays_w
        min_count = max(1, int(round(200 * n_grid / 1600)))
        return K_mat, edge, R, min_count

    def _manager_predicates_with_verify(self, st, depth, rays_d,
                                        pose_local, wait_id: int,
                                        frame_id: int):
        """Manager predicates + SPECULATIVE loop-closure verify+ICP in
        ONE device program (installed as manager.predicates_fn): the
        verification target is the wait-loop submap when waiting, else
        the most-overlapping candidate computed inside the program. The
        host decision paths that need verification consume the result
        from the same readback (_find_overlapping_region), saving one
        dispatch and readback per attempt."""
        K_mat, edge, R, min_count = self._verify_statics()
        rows, cols = self._ovlp_grid
        rr_src, cc_src, sub_incl = self._icp_subs
        k = self.near_kf_num
        n_per = max(1, self.icp_dst_n // k)
        mcfg_mgr = self.manager.cfg
        return _predicates_verify_fused(
            st, pose_local, depth, rays_d,
            jnp.asarray(max(wait_id, 0)),
            jnp.asarray(wait_id, jnp.int32),
            jnp.asarray(mcfg_mgr.min_cr_localMLP_len, jnp.float32),
            mcfg_mgr.near, mcfg_mgr.far,
            self.manager.cr_rows, self.manager.cr_cols,
            rows, cols, K_mat, self._kf_frames_dev,
            jnp.asarray(int(frame_id), jnp.int32),
            rr_src, cc_src, sub_incl,
            self.sw_align_threshold, self.sw_min_trans,
            jnp.asarray(min_count, jnp.int32),
            jnp.asarray(self.manager.double_binding_counter
                        >= mcfg_mgr.thres_db_time),
            jnp.asarray(mcfg_mgr.min_containing_ratio_back, jnp.float32),
            jnp.asarray(mcfg_mgr.min_containing_ratio_mo, jnp.float32),
            k=k, edge=edge, H=self.H, W=self.W, n_per=n_per,
            n_incl=self.sw_including_last,
            keyframe_every=self.keyframe_every, R=R)

    def _find_overlapping_region(self, mo_id: int, active_id: int,
                                 st: slam_state.SlamState,
                                 depth: jnp.ndarray, rays_d: jnp.ndarray,
                                 pose_world: jnp.ndarray):
        """Verify that the current keyframe genuinely re-observes
        submap mo_id, then ICP-rectify the switch pose. Returns
        (ok, data). ONE fused device program + ONE batched readback."""
        mcfg_mgr = self.manager.cfg
        R = self.cap.rays_per_kf
        # speculative result from the manager's fused predicate program:
        # when the verification target matches, the answer is already on
        # host — no new dispatch, no readback. One-shot: consumed (or
        # discarded) here so a later call never reads a stale snapshot.
        lp = self.manager._last_pred
        lp_state = getattr(self.manager, "_last_pred_state", None)
        self.manager._last_pred = None
        self.manager._last_pred_state = None
        if lp is not None and lp_state is st and "spec_target" in lp \
                and int(lp["spec_target"]) == int(mo_id) \
                and bool(lp.get("spec_ran", True)):
            ver = {kk[5:]: v for kk, v in lp.items()
                   if kk.startswith("spec_") and kk != "spec_target"}
        else:
            K_mat, edge, R, min_count = self._verify_statics()
            rows, cols = self._ovlp_grid
            rr_src, cc_src, sub_incl = self._icp_subs
            k = self.near_kf_num
            n_per = max(1, self.icp_dst_n // k)
            ver = jax.device_get(_overlap_verify_icp(
                st, depth, rays_d, jnp.asarray(pose_world), mo_id,
                active_id, rows, cols, K_mat, self._kf_frames_dev,
                jnp.asarray(int(self._last_tracked_frame), jnp.int32),
                rr_src, cc_src, sub_incl,
                self.sw_align_threshold, self.sw_min_trans,
                # the "enough visible overlap points" selection rule
                # (ref PoseCorrector.py:117-123: > 200 of the 40x40
                # grid), scaled to the configured grid in _verify_statics
                jnp.asarray(min_count, jnp.int32),
                k=k, edge=edge, H=self.H, W=self.W, n_per=n_per,
                n_incl=self.sw_including_last,
                keyframe_every=self.keyframe_every, R=R))

        self._last_verify = ver    # observability + tests
        need = mcfg_mgr.min_ovlp_pts
        n_valid = int(ver["n_valid"])
        if self.debug_loop:
            print(f"  [overlap mo={mo_id}] related={int(ver['n_related'])} "
                  f"visible={int(ver['n_visible'])} "
                  f"in_bbox={int(ver['n_in_bbox'])} valid={n_valid} "
                  f"(need {need})")
        if int(ver["n_related"]) == 0 or n_valid < need:
            return False, None

        # ICP acceptance: the reference demands min_correspondence
        # matches out of its full-resolution cloud; scale to the
        # subsampled source count (ref PoseCorrector.py:155-163)
        n_in = int(ver["n_inliers"])
        need_icp = int(self.sw_min_corr * self.icp_src_n / R)
        ok = n_in >= max(need_icp, 32)
        if self.debug_loop:
            print(f"  [overlap mo={mo_id}] icp ok={ok} inliers={n_in}")
        if not ok:
            return False, None
        self.rectified_local_pose = jnp.asarray(ver["pose_final"])
        top_valid = ver["top_valid"]
        data = {"top_kf_ids": ver["top_kf_ids"][top_valid],
                "top_kf_mask": ver["vis"][top_valid],
                "pts_mask": ver["mask_final"]}
        return True, data

    # ------------------------------------------------------------------
    # background refinement (InactiveMap round-robin, ref InactiveMap.py
    # :203-307) + global BA (PGO)
    # ------------------------------------------------------------------

    def _make_sharded_refine_step(self, mi: int):
        """Jitted sharded refinement of ``mi`` stacked inactive submaps:
        params sharded one-per-chip-group over the mesh's data axis,
        state replicated; each submap runs a full local-BA round
        (include_current=False) concurrently — the round-robin of
        inactive_refine_step collapses into one step with zero
        cross-chip traffic. Pose write-back is restricted to keyframes
        FIRST-bound to each submap, so concurrent submaps never write
        the same keyframe slot (the ownership rule, conflict-free by
        masking instead of by serialization).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = self._mesh
        rep = NamedSharding(mesh, P())
        ssh = NamedSharding(mesh, P("data"))
        K = self.cap.n_keyframes

        def one(st, params, m, key):
            kf_mask = slam_state.submap_kf_mask(st, m)
            kf_mask = kf_mask & (st.keyframe_localMLP[:, 0]
                                 != st.active_submap_id)
            first_kf = st.localMLP_first_kf[m]
            last_kf = jnp.max(jnp.where(kf_mask, jnp.arange(K), -1))
            poses_local = self.extract_submap_kf_poses(st, m)
            opt_state = self.map_opt.init(params)
            res = mapper.local_ba(
                params, opt_state, key, st.kf_rays, kf_mask, first_kf,
                last_kf, poses_local, jnp.zeros((8, 7)), jnp.eye(4),
                self.fcfg, self.consts, self.mcfg, self.lw,
                self.mcfg.sample, include_current=False)
            opt_poses = qt_to_matrix(res.kf_quat, res.kf_trans)
            # first-bound-only write-back mask (conflict-free)
            wb_mask = kf_mask & (st.keyframe_localMLP[:, 0] == m)
            return res.field_params, opt_poses, wb_mask

        @partial(jax.jit,
                 in_shardings=(rep, ssh, ssh, ssh, rep),
                 out_shardings=(rep, ssh))
        def step(st, stacked_params, ms, keys, n_real):
            fields, opt_poses, masks = jax.vmap(
                lambda p, m, k: one(st, p, m, k))(stacked_params, ms, keys)
            # cycle-padded slots (slot >= n_real) duplicate real submap
            # ids; masking them out keeps the write-back one-per-submap
            # (no duplicate applications, no ordering dependency)
            masks = masks & (jnp.arange(mi)[:, None] < n_real)

            def wb(i, stt):
                return self.writeback_ba_poses(stt, ms[i], masks[i],
                                               opt_poses[i])

            st2 = jax.lax.fori_loop(0, mi, wb, st)
            return st2, fields

        return step

    def _inactive_refine_sharded(self, inactive, i: int):
        """All-inactive-submaps refinement in one sharded dispatch."""
        nd = self.n_devices
        mi = ((len(inactive) + nd - 1) // nd) * nd   # pad to mesh size
        ms = (inactive * mi)[:mi]                    # cycle-pad ids
        step = self._sharded_refine_cache.get(mi)
        if step is None:
            step = self._sharded_refine_cache.setdefault(
                mi, self._make_sharded_refine_step(mi))
        from jax.sharding import NamedSharding, PartitionSpec as P
        ssh = NamedSharding(self._mesh, P("data"))
        stacked = jax.device_put(
            jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[self.submap_params[m] for m in ms]), ssh)
        keys = jax.device_put(
            jax.random.split(jax.random.fold_in(self._refine_key, i), mi),
            ssh)
        st, fields = step(self.state, stacked,
                          jax.device_put(jnp.asarray(ms, jnp.int32), ssh),
                          keys, jnp.asarray(len(inactive), jnp.int32))
        self.state = st
        for slot, m in enumerate(ms[:len(inactive)]):
            self.submap_params[m] = jax.tree.map(
                lambda x: x[slot], fields)

    def inactive_refine_step(self, i: int = 0):
        """One BA round on the next inactive submap (round-robin).

        Submap membership and the ownership rule (skip keyframes
        first-bound to the active submap — the functional re-expression
        of keyframe_mutex_mask / overlap_kf_flag) are evaluated on HOST
        MIRRORS refreshed at keyframe cadence, so this never blocks on a
        device readback; the BA round itself is one jitted dispatch.
        """
        if not self.inactive_started:
            return
        inactive = [m for m in range(self._host_used)
                    if m != self.active_id and self.submap_params[m]
                    is not None]
        if not inactive:
            return
        if self.use_sharded_refine:
            self._inactive_refine_sharded(inactive, i)
            return
        m = inactive[self._inactive_rr % len(inactive)]
        self._inactive_rr += 1

        bind = self._host_kf_bind
        valid = np.arange(bind.shape[0]) < self._host_n_kf
        mask_np = (valid & ((bind[:, 0] == m) | (bind[:, 1] == m))
                   & (bind[:, 0] != self.active_id))
        if not mask_np.any():
            return
        step = _get_refine_step(self.fcfg, self.mcfg, self.lw,
                                self._round_rays(self.mcfg.sample),
                                self._ray_sharding)
        st, params = step(self.state, self.submap_params[m],
                          jnp.asarray(mask_np), m, i, self.consts,
                          self._refine_key, self._kf_frames_dev)
        self.state = st
        self.submap_params[m] = params

    def global_ba(self, ids: Optional[Tuple[int, int]] = None):
        """Pose-graph optimization over submap anchors after a loop
        closure (ref InactiveMap.global_BA :478-497 ->
        PoseCorrector.pose_graph_optimize :173-216). ``ids`` =
        (aft_id, prev_id) when the call is deferred past the switch
        keyframe (the binding mirror has been cleared by then)."""
        st = self.state
        used = self._host_used
        if used < 2 or self.temp_local_pose is None:
            return
        if ids is not None:
            aft_id, prev_id = ids
        else:
            # switch ids from the host binding mirror (manager.
            # last_binding still holds (switched-to, previous) here;
            # process_frame clears it after the switch chain)
            lb = self.manager.last_binding if self.use_manager else None
            if lb is not None:
                aft_id, prev_id = int(lb[1][0]), int(lb[1][1])
            else:
                prev_id = int(np.asarray(st.prev_active_submap_id))
                aft_id = int(np.asarray(st.active_submap_id))

        self.state = _global_pgo(
            st, self.temp_local_pose, self.rectified_local_pose,
            jnp.asarray(aft_id, jnp.int32), jnp.asarray(prev_id, jnp.int32),
            jnp.asarray(used, jnp.int32),
            jnp.asarray(self.key_edge_weight, jnp.float32))
        # PGO just rewrote frame poses wholesale; a drift-gate anchor
        # recorded before it is stale (est_c2w[anchor_frame] no longer
        # matches the cloud) — disarm and re-arm from the next frame
        self._gate_disarm()
        # optional SDF-consistency refinement of the anchors on top of
        # PGO (ref's older global_BA_overlapping path)
        if self.config["mapping"].get("global_BA", {}).get(
                "sdf_consistency", False):
            self.global_ba_consistency()

    def _get_consistency_opt(self, B: int, n_iters: int, n_rays: int):
        """Jitted anchor optimizer for global_ba_consistency, cached per
        (pair-bucket, iters, rays) so repeated loop events reuse the
        compiled program regardless of WHICH keyframes overlap."""
        cache = getattr(self, "_consistency_opt_cache", None)
        if cache is None:
            cache = self._consistency_opt_cache = {}
        fn = cache.get((B, n_iters, n_rays))
        if fn is not None:
            return fn

        from ..ops.losses import cross_submap_consistency
        import optax

        fcfg, consts = self.fcfg, self.consts
        R = self.cap.rays_per_kf
        sub = jnp.asarray(np.linspace(0, R - 1, min(n_rays, R))
                          .astype(np.int32))
        opt = optax.adam(1e-3)

        @jax.jit
        def run_opt(p0, stacked, kf_rays, est_c2w, free, pk, pm1, pm2,
                    pair_valid, kf_frames, key):
            def loss_fn(p):
                anchors = qt_to_matrix(p["rot"], p["trans"])   # [M,4,4]

                def pair_loss(k, m1, m2):
                    rays = kf_rays[k][sub]
                    local1 = est_c2w[kf_frames[k]]
                    world = _mm(anchors[m1], local1)
                    local2 = _mm(pose_inverse(anchors[m2]), world)
                    params1 = jax.tree.map(lambda x: x[m1], stacked)
                    params2 = jax.tree.map(lambda x: x[m2], stacked)
                    return cross_submap_consistency(
                        params1, params2, fcfg, consts, consts,
                        rays[:, :3], rays[:, 6:7], local1, local2)

                per_pair = jax.vmap(pair_loss)(pk, pm1, pm2)
                return (jnp.sum(per_pair * pair_valid)
                        / jnp.maximum(jnp.sum(pair_valid), 1.0))

            def step(carry, _):
                p, opt_state = carry
                loss, g = jax.value_and_grad(loss_fn)(p)
                g = jax.tree.map(lambda gg: gg * free[:, None], g)
                upd, opt_state = opt.update(g, opt_state, p)
                return (optax.apply_updates(p, upd), opt_state), loss

            (p, _), losses = jax.lax.scan(
                step, (p0, opt.init(p0)), None, length=n_iters)
            return p, losses

        cache[(B, n_iters, n_rays)] = run_opt
        return run_opt

    def global_ba_consistency(self, n_iters: int = 10, n_rays: int = 512):
        """Cross-submap SDF-consistency refinement of submap anchors
        (ref InactiveMap.global_BA_overlapping :375-473 + get_SDF_dif
        :149-192): for every overlapping keyframe (bound to two
        submaps), back-project its stored rays in both submaps' local
        frames and penalize SDF disagreement between the two fields;
        the anchors (first-keyframe world poses, submap 0 fixed) are
        optimized by Adam with the fields frozen.

        Optional (mapping.global_BA.sdf_consistency); the default
        global BA is the pose-graph path, like the reference's live
        configuration.
        """
        st = self.state
        used = self._host_used
        if used < 2:
            return
        kf_ref = np.asarray(st.keyframe_ref)
        bind = self._host_kf_bind
        kf_frames = self._kf_frames()
        ovlp = [(int(k), int(bind[k, 0]), int(bind[k, 1]))
                for k in range(self._host_n_kf)
                if kf_ref[k] == -2 and bind[k, 1] >= 0]
        ovlp = [(k, m1, m2) for (k, m1, m2) in ovlp
                if self.submap_params[m1] is not None
                and self.submap_params[m2] is not None]
        if not ovlp:
            return

        from ..ops.geometry import matrix_to_quaternion

        M = self.cap.n_submaps
        anchors0 = st.kf_c2w[st.localMLP_first_kf[
            jnp.clip(jnp.arange(M), 0, st.localMLP_first_kf.shape[0] - 1)]]
        p0 = {"rot": matrix_to_quaternion(anchors0[:, :3, :3]),
              "trans": anchors0[:, :3, 3]}
        free = (jnp.arange(M) > 0) & (jnp.arange(M) < used)

        # pair data as bucket-padded ARRAYS so the jitted optimizer is
        # compiled once per bucket size, not once per distinct
        # overlapping-keyframe set (unbounded retraces on long
        # multi-loop sequences otherwise)
        B = 4
        while B < len(ovlp):
            B *= 2
        pk, pm1, pm2 = (np.zeros(B, np.int32) for _ in range(3))
        for j, (k, m1, m2) in enumerate(ovlp):
            pk[j], pm1[j], pm2[j] = k, m1, m2
        pair_valid = np.arange(B) < len(ovlp)
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[self.submap_params[m] if self.submap_params[m] is not None
              else self.initial_params for m in range(M)])

        run_opt = self._get_consistency_opt(B, n_iters, n_rays)
        p, losses = run_opt(
            p0, stacked, st.kf_rays, st.est_c2w, free,
            jnp.asarray(pk), jnp.asarray(pm1), jnp.asarray(pm2),
            jnp.asarray(pair_valid, jnp.float32),
            jnp.asarray(kf_frames), self._next_key())
        new_anchors = qt_to_matrix(p["rot"], p["trans"])
        first_kfs = np.asarray(st.localMLP_first_kf)[:used]
        upd = jnp.where(np.asarray(free)[:used, None, None],
                        new_anchors[:used],
                        st.kf_c2w[jnp.asarray(first_kfs)])
        self.state = st._replace(
            kf_c2w=st.kf_c2w.at[jnp.asarray(first_kfs)].set(upd))

    # ------------------------------------------------------------------
    # trajectory assembly & evaluation (ref Logger.py:84-126)
    # ------------------------------------------------------------------

    def assemble_trajectory(self, up_to: int) -> np.ndarray:
        st = self.state
        est = np.asarray(st.est_c2w[: up_to + 1])
        rel = np.asarray(st.est_c2w_rel[: up_to + 1])
        kf_ref = np.asarray(st.keyframe_ref)
        poses = np.empty_like(est)
        for i in range(up_to + 1):
            if i % self.keyframe_every == 0:
                kf_id = i // self.keyframe_every
                if kf_ref[kf_id] == -1:
                    poses[i] = np.eye(4)
                else:
                    poses[i] = est[i]
            else:
                kf_frame = (i // self.keyframe_every) * self.keyframe_every
                poses[i] = est[kf_frame] @ rel[i]
        return poses

    def world_trajectory(self, up_to: int) -> np.ndarray:
        st = self.state
        poses_local = self.assemble_trajectory(up_to)
        kf_ids = np.arange(up_to + 1) // self.keyframe_every
        kf_submap = np.asarray(st.keyframe_localMLP[:, 0])
        first_kf = np.asarray(st.localMLP_first_kf)
        kf_c2w = np.asarray(st.kf_c2w)
        anchors = kf_c2w[first_kf[np.clip(kf_submap[kf_ids], 0, None)]]
        return anchors @ poses_local

    def _gt_pose(self, i: int) -> np.ndarray:
        """GT pose with caching (the O(n^2) per-eval dataset[i] IO of
        round 1 is gone: poses are read once and memoized)."""
        p = self._gt_cache.get(i)
        if p is None:
            if hasattr(self.dataset, "gt_pose"):
                p = np.asarray(self.dataset.gt_pose(i))
            else:
                p = np.asarray(self.dataset[i]["c2w"])
            self._gt_cache[i] = p
        return p

    def evaluate(self, up_to: int, tag: str = "final") -> Dict:
        self._flush_pending_switch()   # ATE must see PGO'd anchors
        world = self.world_trajectory(up_to)
        gt = np.stack([self._gt_pose(i) for i in range(up_to + 1)])
        return pose_evaluation(gt, world, self.output_dir, tag)

    # ------------------------------------------------------------------
    # meshing + checkpointing (ref Logger.py:155-298, Mesher.py)
    # ------------------------------------------------------------------

    def resume_from(self, ckpt_dir: str) -> int:
        """Restore SLAM state + submap fields from a checkpoint and
        return the next frame index to process.

        The reference only reloads checkpoints for offline meshing
        (ref vis/render_mesh.py:58-77 — no mid-sequence resume); here a
        run can continue from any periodic checkpoint, and the active
        submap's Adam moments are restored too (older checkpoints
        without opt_state.npz fall back to a fresh optimizer).
        """
        from .checkpoint import load_ckpt, load_opt_state
        state, submap_params, extra = load_ckpt(ckpt_dir)
        self.state = state
        for i, p in enumerate(submap_params):
            if p is not None and i < len(self.submap_params):
                self.submap_params[i] = p
        self.active_id = int(extra.get("active_id",
                                       int(state.active_submap_id)))
        fresh = self.map_opt.init(self.submap_params[self.active_id])
        self.map_opt_state = load_opt_state(ckpt_dir, fresh) or fresh
        n_kf = int(state.n_kf)
        last_frame = int(state.kf_frame_ids[n_kf - 1]) if n_kf else 0
        self.last_switch_frame = int(state.last_switch_frame)
        # Rebuild the host mirrors of slow-changing device state (see
        # __init__: submap count, keyframe count, keyframe bindings) —
        # everything inactive_refine_step / global_ba_consistency reads
        # on host is derivable from the restored SlamState. Without
        # this, a restored run silently no-ops background refinement
        # (range(self._host_n_kf) == range(0)).
        self._host_used = int(np.asarray(state.localMLP_info[:, 0]).sum())
        self._host_n_kf = n_kf
        self._host_kf_bind = np.asarray(state.keyframe_localMLP).copy()
        # background refinement resumes iff inactive submaps exist
        self.inactive_started = self._host_used > 1
        self._loss_ewma = jnp.asarray(-1.0, jnp.float32)  # fresh regime
        self._prev_loss = jnp.asarray(-1.0, jnp.float32)
        self._gate_disarm()
        return last_frame + 1

    def save_checkpoint(self, tag: str = "final"):
        if not self.output_dir:
            return None
        self._flush_pending_init()
        self._flush_pending_switch()
        from .checkpoint import save_ckpt
        ckpt_dir = os.path.join(self.output_dir, f"ckpt_{tag}")
        save_ckpt(ckpt_dir, self.state, self.submap_params,
                  extra={"active_id": self.active_id},
                  opt_state=self.map_opt_state)
        return ckpt_dir

    def request_mesh(self, frame_id: int) -> None:
        """Request a mid-run mesh extraction; honored by run() at the
        next frame boundary (the reference's mesh_flag protocol,
        ref mipsfusion.py:117 / InactiveMap.py:526-529)."""
        self._mesh_request = int(frame_id)

    def extract_mesh(self, path: str = None, joint: bool = True,
                     voxel_size: float = None):
        """Extract per-submap meshes and (optionally) the joint mesh."""
        from ..mesher import Mesher, MeshConfig
        from ..mesher.mesher import save_mesh_ply

        self._flush_pending_init()
        self._flush_pending_switch()
        st = self.state
        used = int(np.asarray(st.localMLP_info[:, 0]).sum())
        voxel = voxel_size or self.config.get("mesh", {}).get(
            "voxel_final", 0.05)
        mesher = Mesher(self.fcfg, self.consts, MeshConfig(voxel_size=voxel))
        bound = np.asarray(self.config["mapping"].get(
            "marching_cubes_bound", self.config["mapping"]["bound"]))

        info = np.asarray(st.localMLP_info)
        anchors = np.stack([np.asarray(self._anchor(st, m))
                            for m in range(used)])
        params = [self.submap_params[m] for m in range(used)]
        # field SDF is in units of trunc: the extractor's validity
        # threshold lives in those units (|sdf_units| < 1 is in-band)
        sdf_trunc_units = 0.99

        # coarse surface-occupancy visibility from keyframe back-
        # projected depth (the reference's VoxelGrid culling,
        # ref Mesher.py:316-325 + :126-162): grid points far from ANY
        # observed surface are invalid — the SDF is unsupervised there.
        # The occupancies also define WHERE to mesh: each submap's field
        # is supervised wherever its keyframes' rays land (the global
        # bound normalizes coords, not the manager's clamped AABB), so
        # the grid spans the observed-surface bbox and each submap's
        # validity is its OWN keyframes' surface occupancy.
        observed_fn = None
        submap_fns = None
        grid_bounds = None
        n_kf = int(self._host_n_kf or np.asarray(st.n_kf))
        if n_kf and self.config.get("mesh", {}).get("use_occupancy", True):
            from ..mesher.mesher import surface_occupancy
            kf_world = np.asarray(
                self._kf_world_poses(st, np.arange(n_kf)))
            kf_rays_np = np.asarray(st.kf_rays[:n_kf])
            # back-project once; per-keyframe row ranges let the
            # per-submap occupancies reuse the same point array
            dirs_w = np.einsum("kij,krj->kri", kf_world[:, :3, :3],
                               kf_rays_np[..., :3])
            pts_k = (kf_world[:, None, :3, 3]
                     + dirs_w * kf_rays_np[..., 6:7])       # [K, R, 3]
            valid_k = kf_rays_np[..., 6] > 0
            surf_pts = pts_k[valid_k]
            mcfg_mesh = self.config.get("mesh", {})
            cvox = mcfg_mesh.get("occupancy_voxel", 0.2)
            dil = mcfg_mesh.get("occupancy_dilate", 1)
            observed_fn = surface_occupancy(
                surf_pts, bound[:, 0], bound[:, 1], cvox=cvox, dilate=dil)
            inb = (surf_pts > bound[:, 0]) & (surf_pts < bound[:, 1])
            sp_in = surf_pts[inb.all(axis=1)]
            if len(sp_in):
                grid_bounds = (sp_in.min(axis=0) - 2 * cvox,
                               sp_in.max(axis=0) + 2 * cvox)
            bind = self._host_kf_bind[:n_kf]
            submap_fns = []
            for m in range(used):
                sel = (bind[:, 0] == m) | (bind[:, 1] == m)
                if sel.any():
                    submap_fns.append(surface_occupancy(
                        pts_k[sel][valid_k[sel]], bound[:, 0],
                        bound[:, 1], cvox=cvox, dilate=dil))
                else:      # binding mirror empty: fall back to global
                    submap_fns.append(observed_fn)

        if joint and used > 1:
            verts, faces, colors = mesher.extract_mesh_jointly(
                params, anchors, info[:used, 1:4], info[:used, 4:7],
                trunc=sdf_trunc_units, bound_world=bound,
                observed_fn=observed_fn, submap_observed_fns=submap_fns,
                grid_bounds=grid_bounds)
        else:
            verts, faces, colors = mesher.extract_single_mesh(
                params[0], anchors[0], info[0, 1:4], info[0, 4:7],
                trunc=sdf_trunc_units, bound_world=bound,
                observed_fn=observed_fn, grid_bounds=grid_bounds)

        # reference post-extraction cleanup (ref Mesher.py:360-378):
        # small-component removal + keyframe-visibility face culling
        from ..mesher.mesher import apply_visibility_filters
        n_kf = int(st.n_kf)
        if len(verts) and n_kf:
            kf_ids = np.arange(n_kf)
            kf_world = np.asarray(self._kf_world_poses(st, kf_ids))
            kf_max_d = np.asarray(
                jnp.max(st.kf_rays[:n_kf, :, 6], axis=1))
            K_mat = np.asarray(
                [[self.dataset.fx, 0.0, self.dataset.cx],
                 [0.0, self.dataset.fy, self.dataset.cy],
                 [0.0, 0.0, 1.0]])
            min_area = self.config.get("mesh", {}).get(
                "remove_small_geometry_threshold", 0.5)
            verts, faces, colors = apply_visibility_filters(
                verts, faces, colors, kf_world, K_mat, self.H, self.W,
                kf_max_d, min_component_area=min_area)
        if path:
            save_mesh_ply(path, verts, faces, colors)
        return verts, faces, colors

    def render_debug_images(self, i: int) -> None:
        """GT-vs-render comparison grid for frame i into output_dir
        (ref Logger.img_render_save :221-262, called in-loop at
        mesh.vis cadence like ref mipsfusion.py:677)."""
        if not self.output_dir:
            return
        from .logger import img_render_save
        frame = self.dataset[i]
        img_render_save(
            self.submap_params[self.active_id], self.fcfg, self.consts,
            self.state.est_c2w[i], np.asarray(frame["rgb"]),
            np.asarray(frame["depth"]), np.asarray(frame["direction"]),
            self.output_dir, i, key=jax.random.PRNGKey(i))

    # ------------------------------------------------------------------
    # main loop (ref mipsfusion.py:661-735)
    # ------------------------------------------------------------------

    def _stage_sync(self):
        """Inter-stage barrier, active only with ``sync_per_frame``.

        On a virtual multi-device CPU mesh hosted by a machine with few
        cores (tests, dryruns), a collective left in flight while the
        host thread jit-COMPILES the next stage's program can starve
        the CPU collective rendezvous past its hard 40 s abort
        (SIGABRT in xla::cpu::InProcessCommunicator). Draining after
        every stage keeps collectives and compiles disjoint. Every
        stage's outputs hang off the state pytree or the submap params,
        so blocking on those drains the stage's whole program."""
        if self._sync_per_frame:
            jax.block_until_ready((self.state, self.submap_params))

    def process_frame(self, frame: Dict, i: int):
        """Full per-frame pipeline: track, map, keyframe decisions."""
        self._last_tracked_frame = i
        if i == 0:
            self.first_frame_mapping(frame, self.mcfg.first_iters)
            self._stage_sync()
            return

        self.track(frame, i)
        self._stage_sync()
        if self._pending_init_iters > 0:
            self._drain_init_chunk()
            self._stage_sync()
        if self._pending_switch is not None and i > self._pending_switch["i"]:
            self._drain_switch_chain()
            self._stage_sync()
        if i % self.map_every == 0:
            self.do_local_ba(frame, i)
            self._stage_sync()
            self.inactive_refine_step(i)
            self._stage_sync()

        if i % self.keyframe_every == 0:
            kf_id = i // self.keyframe_every
            self.add_keyframe(frame, i)
            self._stage_sync()
            if self.use_manager:
                _, depth, direction = self._frame_arrays(frame)
                force = (i - self.last_switch_frame) <= self.switch_interval
                st, flag = self.manager.process_keyframe(
                    self.state, depth, direction, self.state.est_c2w[i],
                    i, kf_id, force=force)
                self.state = st
                self._stage_sync()
                if flag == 3:
                    self.active_submap_switch_new(frame, i, kf_id)
                    self._stage_sync()
                elif flag == 1:
                    self.active_submap_switch(frame, i, kf_id)
                    self._stage_sync()
                    self.local_ba_switch(frame, kf_id, i)
                    self._stage_sync()
                    lb = self.manager.last_binding
                    ids = ((int(lb[1][0]), int(lb[1][1]))
                           if lb is not None else None)
                    if self.switch_chain_defer:
                        # PGO drains on the next frame (the reference's
                        # do_globalBA background deferral,
                        # ref mipsfusion.py:706 / InactiveMap.py:531-533)
                        self._pending_switch = {"i": i, "ids": ids}
                    else:
                        self.global_ba()
                        self._stage_sync()
                # refresh the host binding mirror from the manager's own
                # host-side record (saves a device readback per keyframe)
                if self.manager.last_binding is not None:
                    bkf, bpair = self.manager.last_binding
                    self._host_kf_bind[bkf] = bpair
                    self.manager.last_binding = None

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            start: int = 0):
        n = n_frames or self.dataset.num_frames
        mesh_cfg = self.config.get("mesh", {})
        vis_every = mesh_cfg.get("vis", 0)
        ckpt_every = mesh_cfg.get("ckpt_freq", 0)
        mesh_every = mesh_cfg.get("mesh_freq", 0)

        # background frame prefetch: dataset IO / synthetic rendering
        # overlaps device compute (the reference used DataLoader worker
        # processes for the same purpose, ref mipsfusion.py:672)
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=4)

        device_frames = (hasattr(self.dataset, "packed")
                         and hasattr(self.dataset, "gt_pose"))

        def _producer():
            for j in range(start, n):
                if device_frames:
                    # render/upload ahead on device; the consumer only
                    # needs the pose on host
                    self.dataset.packed(j)
                    q.put({"frame_id": j, "c2w": self.dataset.gt_pose(j)})
                else:
                    q.put(self.dataset[j])

        threading.Thread(target=_producer, daemon=True).start()

        t_start = time.time()
        for i in range(start, n):
            frame = q.get()
            self.process_frame(frame, i)
            if self._sync_per_frame:
                jax.block_until_ready(self.state.est_c2w)
            # first-frame GT-vs-render grid (ref mipsfusion.py:677)
            if i == 0 and self.output_dir and vis_every:
                self.render_debug_images(i)
            if verbose and i % 25 == 0 and i > 0:
                fps = i / (time.time() - t_start)
                print(f"frame {i}/{n}  track_loss="
                      f"{float(self.track_losses[-1]):.4f}  submap="
                      f"{self.active_id}  {fps:.2f} fps")
            # in-loop evaluation + trajectory export + visual
            # observability (ref :677,712-716; Logger.py:221-262)
            if (self.output_dir and vis_every and i > 0
                    and i % vis_every == 0):
                res = self.evaluate(i, tag=str(i))
                save_traj_tum(self.world_trajectory(i),
                              os.path.join(self.output_dir,
                                           f"traj_{i}.txt"))
                self.render_debug_images(i)
                if verbose:
                    print(f"  [eval@{i}] ATE RMSE "
                          f"{res['absolute_translational_error.rmse']:.4f}")
            # periodic checkpoint (ref :718-720)
            if (self.output_dir and ckpt_every and i > 0
                    and i % ckpt_every == 0):
                self.save_checkpoint(str(i))
            # in-loop meshing: on-demand request_mesh() or mesh_freq
            # cadence (ref InactiveMap.py:526-529 mesh_flag)
            if mesh_every and i > 0 and i % mesh_every == 0:
                self._mesh_request = i
            if self._mesh_request is not None and self.output_dir:
                mid = self._mesh_request
                self._mesh_request = None
                self.extract_mesh(os.path.join(self.output_dir,
                                               f"mesh_{mid}.ply"))
        elapsed = time.time() - t_start
        results = self.evaluate(n - 1)
        results["fps"] = (n - start) / elapsed
        results["n_submaps"] = int(
            np.asarray(self.state.localMLP_info[:, 0]).sum())
        if self.output_dir:
            save_traj_tum(self.world_trajectory(n - 1),
                          os.path.join(self.output_dir, f"traj_{n-1}.txt"))
            self.save_checkpoint("final")
            if self.config.get("mesh", {}).get("extract_final", True):
                verts, _faces, _ = self.extract_mesh(
                    os.path.join(self.output_dir, "mesh_final.ply"))
                # mesh quality tracked alongside ATE when GT is analytic
                # (synthetic scenes; C-L1-style accuracy + completion,
                # SURVEY §6 / eval/recon.py)
                if hasattr(self.dataset, "room_half") and len(verts):
                    from ..eval.recon import evaluate_synthetic_mesh
                    m = evaluate_synthetic_mesh(self, verts=verts)
                    results["mesh_accuracy_m"] = m["mesh_accuracy_m"]
                    results["mesh_completion@5cm"] = \
                        m["mesh_completion@5cm"]
        return results
