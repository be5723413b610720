"""Mapping: first-frame / new-submap initialization and local BA.

Counterparts of the reference's mapping stages:

  * ``init_submap_fit`` — the 500-iteration single-frame fit used for
    the first frame and each newly created submap
    (/root/reference/mipsfusion.py:155-222). One jitted lax.scan.

  * ``local_ba`` — joint map + keyframe-pose bundle adjustment
    (/root/reference/mipsfusion.py:259-370). The reference's dynamic
    related-keyframe list becomes a fixed-capacity mask over all
    keyframe slots, and its first/last-keyframe-biased ray sampling
    (/root/reference/model/keyframeSet.py:386-436) becomes a single
    categorical draw whose per-keyframe weights reproduce the
    reference's quota rules in expectation:
      - first kf:  max(1/n, 1/10) of the submap ray budget,
      - last  kf:  max(1/n, 1/5)   (when n > 2),
      - others:    the remainder uniformly,
      - current frame: max(sample/n, pixels_cur) extra rays.
    The iteration loop (15 iters, map step every map_accum_step, pose
    step every pose_accum_step with gradient accumulation) runs as one
    lax.scan — one compilation, zero host round-trips.

Pose parametrization is quaternion+translation per keyframe slot; the
first keyframe and invalid slots are frozen by gradient masking.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..models import scene_rep as sr
from ..ops.geometry import matrix_to_quaternion, qt_to_matrix


@dataclasses.dataclass(frozen=True)
class MapConfig:
    sample: int = 1800          # rays from keyframe store per BA iter
    pixels_cur: int = 800       # min rays from current frame per BA iter
    iters: int = 15
    first_iters: int = 500
    lr_embed: float = 0.01
    lr_decoder: float = 0.01
    lr_rot: float = 0.001
    lr_trans: float = 0.001
    map_accum_step: int = 1
    pose_accum_step: int = 5
    map_wait_step: int = 0
    optim_cur: bool = False
    mapping_sample_init: int = 2048  # rays per init iteration (ref mapping.sample)

    @staticmethod
    def from_dict(cfg: dict) -> "MapConfig":
        m = cfg["mapping"]
        return MapConfig(
            sample=m["sample"], pixels_cur=m["pixels_cur"],
            iters=m["iters"], first_iters=m["first_iters"],
            lr_embed=m["lr_embed"], lr_decoder=m["lr_decoder"],
            lr_rot=m["lr_rot"], lr_trans=m["lr_trans"],
            map_accum_step=m["map_accum_step"],
            pose_accum_step=m["pose_accum_step"],
            map_wait_step=m["map_wait_step"],
            optim_cur=bool(m["optim_cur"]),
            mapping_sample_init=m["sample"],
        )


def make_map_optimizer(mcfg: MapConfig) -> optax.GradientTransformation:
    """Adam with per-group lr/eps/weight-decay (ref mipsfusion.py:580-584):
    decoder: lr_decoder, weight_decay 1e-6 (additive, torch-style);
    hash embedding: lr_embed, eps 1e-15; betas (0.9, 0.99) for both."""
    decoder_tx = optax.chain(
        optax.add_decayed_weights(1e-6),
        optax.scale_by_adam(b1=0.9, b2=0.99),
        optax.scale(-mcfg.lr_decoder))
    embed_tx = optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
        optax.scale(-mcfg.lr_embed))
    def label_fn(params):
        return {k: jax.tree.map(
            lambda _: "decoder" if k == "decoder" else "embed", v)
            for k, v in params.items()}
    return optax.multi_transform(
        {"decoder": decoder_tx, "embed": embed_tx}, label_fn)


def make_pose_optimizer(mcfg: MapConfig) -> optax.GradientTransformation:
    return optax.multi_transform(
        {"rot": optax.adam(mcfg.lr_rot), "trans": optax.adam(mcfg.lr_trans)},
        {"rot": "rot", "trans": "trans"})


# ---------------------------------------------------------------------------
# First-frame / new-submap initialization
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("fcfg", "mcfg", "n_iters", "n_rays",
                                   "ray_sharding"))
def init_submap_fit(field_params: Dict, map_opt_state, key: jax.Array,
                    frame_rays: jnp.ndarray, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, mcfg: MapConfig,
                    lw: sr.LossWeights, n_iters: int, n_rays: int,
                    ray_sharding=None):
    """Fit the field to one frame at the local identity pose.

    frame_rays: [H*W, 7] (direction, rgb, depth) in the camera frame =
    local frame (the frame IS the submap origin). Returns (params,
    opt_state, last losses dict).

    ``ray_sharding`` (a NamedSharding over the mesh's data axis, or
    None): when set, the per-iteration ray batch is sharded across
    devices — params stay replicated and XLA inserts the gradient
    all-reduce over ICI (ray data-parallelism, SURVEY §2.11; see
    parallel/sharding.py).
    """
    opt = make_map_optimizer(mcfg)

    def step(carry, k):
        params, opt_state = carry
        k1, k2 = jax.random.split(k)
        idx = jax.random.randint(k1, (n_rays,), 0, frame_rays.shape[0])
        rays = frame_rays[idx]
        if ray_sharding is not None:
            rays = jax.lax.with_sharding_constraint(rays, ray_sharding)

        def loss_fn(p):
            dirsT = rays[:, :3].T
            ret = sr.forward_losses_T(p, k2, jnp.zeros_like(dirsT),
                                      dirsT, rays[:, 3:6].T, rays[:, 6:7],
                                      fcfg, consts)
            return sr.total_loss(ret, lw), ret

        (loss, ret), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    keys = jax.random.split(key, n_iters)
    (params, opt_state), losses = jax.lax.scan(
        step, (field_params, map_opt_state), keys)
    return params, opt_state, losses[-1]


# ---------------------------------------------------------------------------
# Local bundle adjustment
# ---------------------------------------------------------------------------

def _kf_sampling_weights(kf_mask: jnp.ndarray, first_kf: jnp.ndarray,
                         last_kf: jnp.ndarray, sample: int,
                         pixels_cur: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-slot ray-count weights reproducing the reference quotas.

    Returns (weights [K+1], n_related): slot K (the last entry) is the
    current frame. Weights are expected ray counts (unnormalized).
    """
    K = kf_mask.shape[0]
    n = jnp.maximum(jnp.sum(kf_mask.astype(jnp.int32)), 1)
    nf = n.astype(jnp.float32)

    q_first = jnp.maximum(sample / nf, sample / 10.0)
    q_last = jnp.where(n > 2, jnp.maximum(sample / nf, sample / 5.0), 0.0)
    n_other = jnp.maximum(nf - 1.0 - jnp.where(n > 2, 1.0, 0.0), 1.0)
    q_other = jnp.maximum(sample - q_first - q_last, 0.0) / n_other

    idx = jnp.arange(K)
    w = jnp.where(idx == first_kf, q_first,
                  jnp.where((idx == last_kf) & (n > 2), q_last, q_other))
    w = w * kf_mask.astype(jnp.float32)
    w_cur = jnp.where(pixels_cur > 0,
                      jnp.maximum(sample / nf, float(pixels_cur)), 0.0)
    return jnp.concatenate([w, w_cur[None]]), n


class BAResult(NamedTuple):
    field_params: Dict
    map_opt_state: object
    kf_quat: jnp.ndarray     # [K, 4] optimized keyframe rotations (local)
    kf_trans: jnp.ndarray    # [K, 3]
    cur_quat: jnp.ndarray    # [4] current-frame pose (optimized iff optim_cur)
    cur_trans: jnp.ndarray   # [3]
    loss: jnp.ndarray


@partial(jax.jit, static_argnames=("fcfg", "mcfg", "n_total",
                                   "include_current", "ray_sharding"))
def local_ba(field_params: Dict, map_opt_state, key: jax.Array,
             kf_rays: jnp.ndarray, kf_mask: jnp.ndarray,
             first_kf: jnp.ndarray, last_kf: jnp.ndarray,
             kf_poses_local: jnp.ndarray, cur_rays: jnp.ndarray,
             cur_pose_local: jnp.ndarray, fcfg: sr.FieldConfig,
             consts: sr.FieldConsts, mcfg: MapConfig, lw: sr.LossWeights,
             n_total: int, include_current: bool = True,
             ray_sharding=None) -> BAResult:
    """Joint map+pose BA over the active submap's keyframes.

    kf_rays: [K, R, 7] full keyframe store; kf_mask: [K] bool membership;
    kf_poses_local: [K, 4, 4] local poses; cur_rays: [P, 7] current frame;
    n_total: static total rays per iteration (sample + pixels_cur).

    ``ray_sharding``: optional NamedSharding for ray data-parallelism —
    the sampled per-iteration batch (rays, poses, targets) is sharded
    across the mesh's data axis while field + pose params stay
    replicated; XLA inserts the map and pose gradient all-reduces from
    the constraint. n_total must be divisible by
    the data-axis size.
    """
    K, R, _ = kf_rays.shape
    opt_map = make_map_optimizer(mcfg)
    opt_pose = make_pose_optimizer(mcfg)

    w, _n = _kf_sampling_weights(
        kf_mask, first_kf, last_kf, mcfg.sample,
        mcfg.pixels_cur if include_current else 0)
    logits = jnp.log(w + 1e-12)

    # pose parameters for every kf slot + the current frame
    quat0 = matrix_to_quaternion(kf_poses_local[:, :3, :3])      # [K, 4]
    trans0 = kf_poses_local[:, :3, 3]                            # [K, 3]
    cq0 = matrix_to_quaternion(cur_pose_local[:3, :3])
    ct0 = cur_pose_local[:3, 3]
    pose_params0 = {"rot": jnp.concatenate([quat0, cq0[None]], 0),
                    "trans": jnp.concatenate([trans0, ct0[None]], 0)}
    pose_opt_state0 = opt_pose.init(pose_params0)

    # gradient mask: first kf frozen; invalid slots frozen; current frame
    # optimized only when optim_cur (ref mipsfusion.py:266-282)
    idx = jnp.arange(K)
    kf_free = kf_mask & (idx != first_kf)
    free = jnp.concatenate(
        [kf_free, jnp.asarray([mcfg.optim_cur])]).astype(jnp.float32)

    zero_pose_grad = jax.tree.map(jnp.zeros_like, pose_params0)

    def loss_fn(params, pose_params, k):
        k1, kr, ku, k2 = jax.random.split(k, 4)
        # choose source slot per ray: 0..K-1 = keyframes, K = current
        src = jax.random.categorical(k1, logits, shape=(n_total,))
        ray_idx = jax.random.randint(kr, (n_total,), 0, R)
        cur_idx = jax.random.randint(ku, (n_total,), 0, cur_rays.shape[0])

        from_cur = src == K
        kf_src = jnp.minimum(src, K - 1)
        rays = jnp.where(from_cur[:, None],
                         cur_rays[cur_idx],
                         kf_rays[kf_src, ray_idx])
        if ray_sharding is not None:
            # shard the per-iteration batch (and its pose-slot indices)
            # across the mesh's data axis; params stay replicated, so
            # XLA inserts the map + pose gradient all-reduce
            rays = jax.lax.with_sharding_constraint(rays, ray_sharding)
            src = jax.lax.with_sharding_constraint(src, ray_sharding)

        poses = qt_to_matrix(pose_params["rot"], pose_params["trans"])
        T = poses[src]                                            # [N,4,4]
        # points-minor layout for the fused training path ([3, N] rays,
        # scene_rep.forward_losses_T): the einsum emits transposed
        # directly; the remaining [N, .] -> [., N] flips are tiny
        rays_dT = jnp.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3],
                             precision=jax.lax.Precision.HIGHEST)
        rays_oT = T[:, :3, 3].T
        ret = sr.forward_losses_T(params, k2, rays_oT, rays_dT,
                                  rays[:, 3:6].T, rays[:, 6:7], fcfg,
                                  consts)
        return sr.total_loss(ret, lw)

    def step(carry, xs):
        params, map_state, pose_params, pose_state, pose_accum = carry
        i, k = xs
        loss, (g_map, g_pose) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(params, pose_params, k)

        # map update every map_accum_step after map_wait_step
        do_map = ((i + 1) % mcfg.map_accum_step == 0) & \
                 ((i + 1) > mcfg.map_wait_step)
        upd, new_map_state = opt_map.update(g_map, map_state, params)
        params = jax.tree.map(
            lambda p, u: jnp.where(do_map, p + u, p), params, upd)
        map_state = jax.tree.map(
            lambda n, o: jnp.where(do_map, n, o), new_map_state, map_state)

        # pose grads masked + accumulated; step every pose_accum_step
        g_pose = jax.tree.map(
            lambda g: g * free[:, None], g_pose)
        pose_accum = jax.tree.map(jnp.add, pose_accum, g_pose)
        do_pose = (i + 1) % mcfg.pose_accum_step == 0
        updp, new_pose_state = opt_pose.update(pose_accum, pose_state,
                                               pose_params)
        pose_params = jax.tree.map(
            lambda p, u: jnp.where(do_pose, p + u, p), pose_params, updp)
        pose_state = jax.tree.map(
            lambda n, o: jnp.where(do_pose, n, o), new_pose_state,
            pose_state)
        pose_accum = jax.tree.map(
            lambda a: jnp.where(do_pose, jnp.zeros_like(a), a), pose_accum)

        return (params, map_state, pose_params, pose_state, pose_accum), loss

    keys = jax.random.split(key, mcfg.iters)
    iters = jnp.arange(mcfg.iters)
    carry0 = (field_params, map_opt_state, pose_params0, pose_opt_state0,
              zero_pose_grad)
    (params, map_state, pose_params, _, _), losses = jax.lax.scan(
        step, carry0, (iters, keys))

    return BAResult(
        field_params=params, map_opt_state=map_state,
        kf_quat=pose_params["rot"][:K], kf_trans=pose_params["trans"][:K],
        cur_quat=pose_params["rot"][K], cur_trans=pose_params["trans"][K],
        loss=losses[-1])


# ---------------------------------------------------------------------------
# Switch-time BA (pose-only refinement of the loop-triggering keyframe)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("fcfg", "n_iters", "n_total",
                                   "pose_accum_step"))
def switch_ba(field_params: Dict, key: jax.Array, kf_rays: jnp.ndarray,
              kf_mask: jnp.ndarray, kf_poses_local: jnp.ndarray,
              ovlp_rays: jnp.ndarray, ovlp_pose_local: jnp.ndarray,
              fcfg: sr.FieldConfig, consts: sr.FieldConsts,
              lw: sr.LossWeights, lr_rot: float, lr_trans: float,
              n_iters: int, n_total: int, pose_accum_step: int = 5):
    """Refine ONLY the loop-triggering keyframe's pose against the
    switched-to submap (ref mipsfusion.local_BA_switch :379-444: the map
    optimizer is never stepped there, so the field stays frozen; rays
    come uniformly from the given nearest keyframes plus a quota from
    the overlapping keyframe itself).

    kf_mask selects the nearest keyframes; kf_poses_local are their
    local poses in the switched-to submap's frame. Returns the optimized
    overlapping-keyframe pose [4, 4].
    """
    K, R, _ = kf_rays.shape
    n = jnp.maximum(jnp.sum(kf_mask.astype(jnp.int32)), 1).astype(jnp.float32)
    # uniform over given kfs (sample_rays_in_given_kf semantics) + ovlp quota
    w_kf = kf_mask.astype(jnp.float32)
    w_kf = w_kf / jnp.maximum(jnp.sum(w_kf), 1.0)
    sample = n_total  # treat n_total as the reference's mapping.sample
    w_ovlp = jnp.maximum(sample / n, sample / 5.0) / sample
    logits = jnp.log(jnp.concatenate([w_kf, w_ovlp[None]]) + 1e-12)

    opt = optax.multi_transform(
        {"rot": optax.adam(lr_rot), "trans": optax.adam(lr_trans)},
        {"rot": "rot", "trans": "trans"})
    p0 = {"rot": matrix_to_quaternion(ovlp_pose_local[:3, :3]),
          "trans": ovlp_pose_local[:3, 3]}
    opt_state0 = opt.init(p0)

    kf_quats = matrix_to_quaternion(kf_poses_local[:, :3, :3])
    kf_trans = kf_poses_local[:, :3, 3]

    def loss_fn(p, k):
        k1, kr, ku, k2 = jax.random.split(k, 4)
        src = jax.random.categorical(k1, logits, shape=(n_total,))
        ray_idx = jax.random.randint(kr, (n_total,), 0, R)
        ovlp_idx = jax.random.randint(ku, (n_total,), 0, ovlp_rays.shape[0])
        from_ovlp = src == K
        kf_src = jnp.minimum(src, K - 1)
        rays = jnp.where(from_ovlp[:, None], ovlp_rays[ovlp_idx],
                         kf_rays[kf_src, ray_idx])
        quats = jnp.concatenate([kf_quats, p["rot"][None]], 0)
        trans = jnp.concatenate([kf_trans, p["trans"][None]], 0)
        T = qt_to_matrix(quats[src], trans[src])
        rays_dT = jnp.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3],
                             precision=jax.lax.Precision.HIGHEST)
        ret = sr.forward_losses_T(field_params, k2, T[:, :3, 3].T, rays_dT,
                                  rays[:, 3:6].T, rays[:, 6:7], fcfg,
                                  consts)
        return sr.total_loss(ret, lw)

    def step(carry, xs):
        i, k = xs
        p, opt_state, accum = carry
        loss, g = jax.value_and_grad(loss_fn)(p, k)
        accum = jax.tree.map(jnp.add, accum, g)
        do = (i + 1) % pose_accum_step == 0
        upd, new_state = opt.update(accum, opt_state, p)
        p = jax.tree.map(lambda a, u: jnp.where(do, a + u, a), p, upd)
        opt_state = jax.tree.map(
            lambda nn, oo: jnp.where(do, nn, oo), new_state, opt_state)
        accum = jax.tree.map(
            lambda a: jnp.where(do, jnp.zeros_like(a), a), accum)
        return (p, opt_state, accum), loss

    keys = jax.random.split(key, n_iters)
    (p, _, _), losses = jax.lax.scan(
        step, (p0, opt_state0, jax.tree.map(jnp.zeros_like, p0)),
        (jnp.arange(n_iters), keys))
    return qt_to_matrix(p["rot"], p["trans"]), losses[-1]
