"""SLAM state: one fixed-capacity device-resident pytree.

Re-expression of the reference's shared-memory tensor zoo
(/root/reference/mipsfusion.py:62-124, /root/reference/model/keyframeSet.py:11-71):
every dynamically-grown torch tensor becomes a fixed-capacity jnp array
with a validity convention, so the whole SLAM state is a single pytree
that flows through jitted steps without retraces, and the reference's
cross-process shared-memory protocol reduces to functional updates.

Conventions:
  * keyframe slot k is valid iff k < n_kf;
  * keyframe_localMLP[k] = (first submap id, second submap id) with -1
    for none (ref keyframeSet.py:55);
  * keyframe_ref[k]: -1 = first kf of a submap, -2 = overlapping kf
    (bound to two submaps), >=0 = ordinary kf (value = the kf id of its
    submap's first keyframe at bind time) (ref mipsfusion.py:75-79);
  * localMLP_info[m] = [used, center_xyz(3), axis_len(3)]
    (ref keyframeSet.py:47);
  * est_c2w[f] is frame f's pose in its submap's local frame;
    kf_c2w[k] is a world pose, authoritative only for first keyframes
    (anchors) (ref mipsfusion.py:62-74).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class StateCapacity:
    """Static capacities (hashable; part of jit static args)."""
    n_frames: int = 2100        # max sequence length
    n_keyframes: int = 160      # max keyframes (ref: num_kf from config)
    n_submaps: int = 20         # max localMLPs (ref mapping.localMLP_num)
    rays_per_kf: int = 30000    # stored rays per keyframe (150 x 200)
    kf_rays_h: int = 150        # downsample grid rows (ref kf_n_rays_h)
    kf_rays_w: int = 200        # downsample grid cols


class SlamState(NamedTuple):
    # keyframe replay store: [K, R, 7] = (direction 3, rgb 3, depth 1)
    kf_rays: jnp.ndarray
    kf_frame_ids: jnp.ndarray       # [K] int32, -1 = empty
    n_kf: jnp.ndarray               # scalar int32

    # poses
    kf_c2w: jnp.ndarray             # [K, 4, 4] world anchors
    est_c2w: jnp.ndarray            # [F, 4, 4] local poses per frame
    est_c2w_rel: jnp.ndarray        # [F, 4, 4] relative pose of non-kf frames
    keyframe_ref: jnp.ndarray       # [K] int32 type codes

    # submap tables
    localMLP_info: jnp.ndarray      # [M, 7] used, center(3), len(3)
    localMLP_max_len: jnp.ndarray   # [M, 3]
    localMLP_adjacent: jnp.ndarray  # [M, M] float 0/1
    keyframe_localMLP: jnp.ndarray  # [K, 2] int32
    localMLP_first_kf: jnp.ndarray  # [M] int32, -1 = unset

    # active registers (ref mipsfusion.py:83-89)
    active_submap_id: jnp.ndarray       # scalar int32
    prev_active_submap_id: jnp.ndarray  # scalar int32
    active_first_kf: jnp.ndarray        # scalar int32 (kf id)
    last_switch_frame: jnp.ndarray      # scalar int32


def init_state(cap: StateCapacity, localMLP_max_len) -> SlamState:
    K, F, M, R = (cap.n_keyframes, cap.n_frames, cap.n_submaps,
                  cap.rays_per_kf)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (F, 4, 4))
    eyeK = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4))
    return SlamState(
        kf_rays=jnp.zeros((K, R, 7), jnp.float32),
        kf_frame_ids=jnp.full((K,), -1, jnp.int32),
        n_kf=jnp.zeros((), jnp.int32),
        kf_c2w=eyeK,
        est_c2w=eye,
        est_c2w_rel=eye,
        keyframe_ref=jnp.zeros((K,), jnp.int32),
        localMLP_info=jnp.zeros((M, 7), jnp.float32),
        localMLP_max_len=jnp.broadcast_to(
            jnp.asarray(localMLP_max_len, jnp.float32), (M, 3)),
        localMLP_adjacent=jnp.zeros((M, M), jnp.float32),
        keyframe_localMLP=jnp.full((K, 2), -1, jnp.int32),
        localMLP_first_kf=jnp.full((M,), -1, jnp.int32),
        active_submap_id=jnp.zeros((), jnp.int32),
        prev_active_submap_id=jnp.full((), -1, jnp.int32),
        active_first_kf=jnp.zeros((), jnp.int32),
        last_switch_frame=jnp.zeros((), jnp.int32),
    )


def kf_downsample_indices(H: int, W: int, n_rows: int, n_cols: int):
    """Uniform pixel grid for keyframe ray storage.

    Mirrors sample_pixels_uniformly (ref helper_functions/sampling_helper.py)
    as used by KeyframeSet (ref keyframeSet.py:24): evenly spaced rows x
    cols covering the image.
    """
    rows = jnp.linspace(0, H - 1, n_rows).astype(jnp.int32)
    cols = jnp.linspace(0, W - 1, n_cols).astype(jnp.int32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def make_frame_rays(direction: jnp.ndarray, rgb: jnp.ndarray,
                    depth: jnp.ndarray) -> jnp.ndarray:
    """Pack a frame into the ray layout [H, W, 7] = (dir, rgb, depth)."""
    return jnp.concatenate(
        [direction, rgb, depth[..., None]], axis=-1)


def add_keyframe(state: SlamState, frame_rays: jnp.ndarray,
                 frame_id, row_idx: jnp.ndarray,
                 col_idx: jnp.ndarray) -> SlamState:
    """Insert a downsampled keyframe into slot n_kf (ref keyframeSet.py:170-175)."""
    rays = frame_rays[row_idx, col_idx]            # [R, 7]
    k = state.n_kf
    return state._replace(
        kf_rays=jax.lax.dynamic_update_index_in_dim(
            state.kf_rays, rays, k, axis=0),
        kf_frame_ids=state.kf_frame_ids.at[k].set(
            jnp.asarray(frame_id, jnp.int32)),
        n_kf=k + 1,
    )


def submap_kf_mask(state: SlamState, submap_id) -> jnp.ndarray:
    """Bool [K]: keyframes bound to the given submap (either binding)."""
    valid = jnp.arange(state.kf_frame_ids.shape[0]) < state.n_kf
    bound = jnp.any(state.keyframe_localMLP == submap_id, axis=-1)
    return valid & bound
