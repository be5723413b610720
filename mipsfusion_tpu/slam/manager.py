"""Submap manager: allocation, expansion, binding, and switch decisions.

Re-expression of the reference Manager
(/root/reference/Manager.py:10-728). The decision engine runs at
keyframe cadence (every `keyframe_every` frames) so it is host-side
control flow; the geometric predicates (containing ratios, frustum
bboxes, point-in-bbox scoring) are small jitted jnp computations.

The five-way case analysis of process_keyframe_normal (ref :373-490):
  case 1: active submap already contains the keyframe's surface
          (cr_active >= min_containing_ratio) -> bind (msg1 if also
          overlapping another submap, else msg2);
  case 2: same after axis-wise AABB expansion (expand rule :614-717);
  case 3: most-overlapping == active and still not contained -> new
          submap (msg3);
  case 4: different MO submap but cr_mo < min_containing_ratio_back ->
          new submap (msg3);
  case 5: camera re-entered a previous submap's range -> verify
          overlapping region; switch back (msg1 w/ switch) or create a
          new submap and enter the wait-loop state.
Plus the double-binding counter (>= 4 consecutive same-pair bindings
forces a switch attempt, ref :63-85) and the wait-loop re-check
(ref :494-518).

Returned flags match the reference contract (ref :361-364):
  1 = keyframe bound to 2 submaps, active switched to a previous submap;
  2 = keyframe bound, active unchanged;
  3 = new submap created and switched to.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.geometry import (get_frame_surface_bbox, pts_in_bbox,
                            rays_to_world)
from .state import SlamState


@dataclasses.dataclass
class ManagerConfig:
    min_containing_ratio: float = 0.7
    min_containing_ratio_mo: float = 0.6
    min_containing_ratio_back: float = 0.5
    min_cr_localMLP_len: Tuple[float, ...] = (5.0, 5.0, 5.0)
    localMLP_max_len: Tuple[float, ...] = (7.0, 7.0, 7.0)
    localMLP_max_len_back: Tuple[float, ...] = (7.0, 7.0, 7.0)
    near: float = 0.0
    far: float = 5.0
    thres_db_time: int = 4
    ovlp_rays_h: int = 40
    ovlp_rays_w: int = 40
    min_ovlp_pts: int = 200

    @staticmethod
    def from_dict(cfg: dict) -> "ManagerConfig":
        m = cfg["mapping"]
        ov = m.get("overlapping", {})
        return ManagerConfig(
            min_containing_ratio=m.get("min_containing_ratio", 0.7),
            min_containing_ratio_mo=m.get("min_containing_ratio_mo", 0.6),
            min_containing_ratio_back=m.get("min_containing_ratio_back", 0.5),
            min_cr_localMLP_len=tuple(m.get("min_cr_localMLP_len",
                                            (5.0, 5.0, 5.0))),
            localMLP_max_len=tuple(m["localMLP_max_len"]),
            localMLP_max_len_back=tuple(m.get("localMLP_max_len_back",
                                              m["localMLP_max_len"])),
            near=cfg["cam"]["near"], far=cfg["cam"]["far"],
            ovlp_rays_h=ov.get("n_rays_h", 40),
            ovlp_rays_w=ov.get("n_rays_w", 40),
            min_ovlp_pts=ov.get("min_pts", 200),
        )


# ---------------------------------------------------------------------------
# geometric predicates (jnp, jit-friendly)
# ---------------------------------------------------------------------------

def containing_ratio(depth_img: jnp.ndarray, rays_d_img: jnp.ndarray,
                     pose_world: jnp.ndarray, center: jnp.ndarray,
                     length: jnp.ndarray, min_len: jnp.ndarray,
                     rows: jnp.ndarray, cols: jnp.ndarray) -> jnp.ndarray:
    """Fraction of sampled valid-depth surface points inside the AABB
    (ref Manager.compute_containing_ratio :204-244; the AABB length is
    floored at min_cr_localMLP_len)."""
    d = depth_img[rows, cols][:, None]
    dirs = rays_d_img[rows, cols]
    rays_o, rays_d = rays_to_world(dirs, pose_world)
    pts = rays_o + rays_d * d
    length = jnp.maximum(length, min_len)
    lo, hi = center - 0.5 * length, center + 0.5 * length
    inside = pts_in_bbox(pts, lo[None], hi[None])[:, 0]
    valid = d[:, 0] > 0.0
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(inside & valid) / n_valid


def expand_rule(center: np.ndarray, length: np.ndarray,
                kf_center: np.ndarray, kf_len: np.ndarray,
                max_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-wise AABB expansion with per-axis max clamp.

    Vectorized re-derivation of the reference's per-axis triplicated
    logic (ref Manager.localMLP_expand_rule :614-717): grow the AABB to
    cover the keyframe surface bbox; if the union exceeds max_len on an
    axis, distribute the allowed growth proportionally to the required
    positive/negative expansion; axes already at max_len stay put.
    """
    center, length = np.asarray(center, np.float64), np.asarray(length, np.float64)
    kf_min = np.asarray(kf_center) - 0.5 * np.asarray(kf_len)
    kf_max = np.asarray(kf_center) + 0.5 * np.asarray(kf_len)
    lo, hi = center - 0.5 * length, center + 0.5 * length
    max_len = np.asarray(max_len, np.float64)

    if (kf_min >= lo).all() and (kf_max <= hi).all():
        return center.astype(np.float32), length.astype(np.float32)

    u_lo, u_hi = np.minimum(kf_min, lo), np.maximum(kf_max, hi)
    new_lo, new_hi = lo.copy(), hi.copy()

    for a in range(3):
        if length[a] >= max_len[a]:
            continue  # cannot expand this axis
        if u_hi[a] - u_lo[a] <= max_len[a]:
            new_lo[a], new_hi[a] = u_lo[a], u_hi[a]
            continue
        pos_need = abs(u_hi[a] - hi[a])
        neg_need = abs(lo[a] - u_lo[a])
        budget = max_len[a] - length[a]
        if pos_need == 0.0 or neg_need == 0.0:
            # single-direction growth up to the budget (ref case 2)
            if pos_need > 0:
                new_hi[a] = hi[a] + budget
            else:
                new_lo[a] = lo[a] - budget
        else:  # both directions, proportional (ref case 3)
            new_hi[a] = hi[a] + budget * pos_need / (pos_need + neg_need)
            new_lo[a] = lo[a] - budget * neg_need / (pos_need + neg_need)

    new_len = new_hi - new_lo
    new_center = new_lo + 0.5 * new_len
    return new_center.astype(np.float32), new_len.astype(np.float32)


def uniform_grid(H: int, W: int, n_rows: int, n_cols: int):
    rows = jnp.linspace(0, H - 1, n_rows).astype(jnp.int32)
    cols = jnp.linspace(0, W - 1, n_cols).astype(jnp.int32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


# ---------------------------------------------------------------------------
# Fused state mutators: the msg1/2/3 decisions are host-side (branchy,
# tiny), but each decision's state update is ONE jitted dispatch instead
# of an eager .at[].set chain of one dispatch per op (the predicates call
# + one device_get remain).
# ---------------------------------------------------------------------------

@jax.jit
def _msg1_apply(st: SlamState, kf_id, id1, id2, c1, l1, c2, l2,
                max_len, bind, switch):
    info = (st.localMLP_info
            .at[id1, 1:4].set(c1).at[id1, 4:7].set(l1)
            .at[id2, 1:4].set(c2).at[id2, 4:7].set(l2))
    st = st._replace(
        localMLP_info=info,
        localMLP_max_len=max_len,
        keyframe_localMLP=st.keyframe_localMLP.at[kf_id].set(bind),
        localMLP_adjacent=st.localMLP_adjacent
        .at[id1, id2].set(1.0).at[id2, id1].set(1.0),
        keyframe_ref=st.keyframe_ref.at[kf_id].set(-2),
    )
    return st._replace(
        prev_active_submap_id=jnp.where(switch, st.active_submap_id,
                                        st.prev_active_submap_id),
        active_submap_id=jnp.where(switch, jnp.asarray(id2, jnp.int32),
                                   st.active_submap_id),
        active_first_kf=jnp.where(switch, st.localMLP_first_kf[id2],
                                  st.active_first_kf),
    )


@jax.jit
def _msg2_apply(st: SlamState, kf_id, submap_id, c, ln):
    return st._replace(
        localMLP_info=st.localMLP_info
        .at[submap_id, 1:4].set(c).at[submap_id, 4:7].set(ln),
        keyframe_localMLP=st.keyframe_localMLP.at[kf_id, 0].set(submap_id),
    )


@jax.jit
def _msg3_apply(st: SlamState, kf_id, frame_id, new_id, active_id,
                kf_center, kf_len, pose_world):
    info_row = jnp.concatenate([jnp.ones(1, jnp.float32),
                                kf_center, kf_len])
    return st._replace(
        localMLP_info=st.localMLP_info.at[new_id].set(info_row),
        localMLP_first_kf=st.localMLP_first_kf.at[new_id].set(kf_id),
        keyframe_localMLP=st.keyframe_localMLP.at[kf_id].set(
            jnp.stack([jnp.asarray(new_id, jnp.int32),
                       jnp.asarray(active_id, jnp.int32)])),
        localMLP_adjacent=st.localMLP_adjacent
        .at[active_id, new_id].set(1.0).at[new_id, active_id].set(1.0),
        prev_active_submap_id=st.active_submap_id,
        active_submap_id=jnp.asarray(new_id, jnp.int32),
        active_first_kf=jnp.asarray(kf_id, jnp.int32),
        keyframe_ref=st.keyframe_ref.at[kf_id].set(-1),
        kf_c2w=st.kf_c2w.at[kf_id].set(pose_world),
        est_c2w=st.est_c2w.at[frame_id].set(jnp.eye(4)),
    )


@jax.jit
def _predicates_fused(st: SlamState, pose_local, depth, rays_d, wait_id,
                      min_cr_len, near, far, rows, cols):
    """manager_predicates with the anchor derived on device from the
    state (no host readback of active_submap_id before the dispatch);
    the active id and submap tables join the batched readback."""
    active_id = st.active_submap_id
    anchor = st.kf_c2w[st.localMLP_first_kf[active_id]]
    pred = manager_predicates(
        st.localMLP_info, st.localMLP_max_len, anchor, pose_local,
        depth, rays_d, active_id, wait_id, min_cr_len, near, far,
        rows, cols)
    pred["active_id"] = active_id
    pred["localMLP_info"] = st.localMLP_info
    pred["localMLP_max_len"] = st.localMLP_max_len
    return pred


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

class Manager:
    """Host-side per-keyframe decision engine over device state."""

    def __init__(self, cfg: ManagerConfig, H: int, W: int,
                 keyframe_every: int):
        self.cfg = cfg
        self.keyframe_every = keyframe_every
        # coarse grid for containing ratios (ref uses 150x200)
        self.cr_rows, self.cr_cols = uniform_grid(H, W, min(H, 150),
                                                  min(W, 200))
        # loop/double-binding state (ref create_loop_vars :30-38)
        self.double_binding_counter = 0
        self.db_active_id = -1
        self.db_mo_id = -1
        self.wait_loop = False
        self.localMLP_Id_wait = -1
        self.localMLP_Id_actual = -1
        # overlap-region buffers filled on a successful switch trigger
        self.ovlp_data: Optional[Dict] = None
        # host mirror of the binding each msg wrote (kf_id, (first, second))
        # so the system can track keyframe_localMLP without a readback
        self.last_binding: Optional[Tuple[int, Tuple[int, int]]] = None
        # hook installed by the system for overlap verification (phase:
        # loop closure); returns (ok, data) given candidate submaps
        self.find_overlap_fn = None
        # optional fused predicates+verify+ICP program installed by the
        # system: ONE dispatch + ONE readback per keyframe, with the
        # loop-closure verification computed SPECULATIVELY for the
        # most-overlapping candidate, so switch keyframes need no
        # second readback)
        self.predicates_fn = None
        self._last_pred: Optional[Dict] = None
        self._last_pred_state = None

    # -- helpers ----------------------------------------------------------

    def _double_binding(self, active_id: int, mo_id: int, cr_mo: float,
                        overlap_args) -> bool:
        """Double-binding counter (ref process_double_binding :63-85)."""
        if self.double_binding_counter == 0:
            self.double_binding_counter = 1
            self.db_active_id, self.db_mo_id = active_id, mo_id
            return False
        if active_id == self.db_active_id and mo_id == self.db_mo_id:
            if self.double_binding_counter >= self.cfg.thres_db_time:
                ok = self._loop_flag(mo_id, active_id, cr_mo, overlap_args,
                                     force=True)
                self.double_binding_counter = 0
                return ok
            self.double_binding_counter += 1
            return False
        self.double_binding_counter = 0
        self.db_active_id, self.db_mo_id = active_id, mo_id
        return False

    def _loop_flag(self, mo_id: int, active_id: int, cr_mo: float,
                   overlap_args, force: bool = False) -> bool:
        """Verify a pending loop trigger (ref get_loop_flag :43-59)."""
        if not (force or (self.wait_loop and self.localMLP_Id_wait == mo_id
                          and self.localMLP_Id_actual == active_id)):
            return False
        if cr_mo < self.cfg.min_containing_ratio_back:
            return False
        if self.find_overlap_fn is None:
            return False
        ok, data = self.find_overlap_fn(mo_id, active_id, *overlap_args)
        if ok:
            self.ovlp_data = data
            self.wait_loop = False
        return True if ok else False

    # -- state mutators (msg1/2/3, ref :522-606) --------------------------

    def _apply_msg1(self, st: SlamState, kf_id: int, kf_center, kf_len,
                    id1: int, id2: int, pose_world, switch: bool,
                    info=None, max_len=None):
        if info is None:
            info = np.asarray(st.localMLP_info)
        max_len = np.array(st.localMLP_max_len if max_len is None
                           else max_len)  # mutable copy
        if switch:
            max_len[id2] = self.cfg.localMLP_max_len_back
        c1, l1 = expand_rule(info[id1, 1:4], info[id1, 4:7], kf_center,
                             kf_len, max_len[id1])
        if switch:
            c2, l2 = expand_rule(info[id2, 1:4], info[id2, 4:7], kf_center,
                                 kf_len, max_len[id2])
        else:
            c2, l2 = info[id2, 1:4], info[id2, 4:7]

        bind = (id2, id1) if switch else (id1, id2)
        self.last_binding = (kf_id, (int(bind[0]), int(bind[1])))
        st = _msg1_apply(
            st, kf_id, id1, id2,
            np.asarray(c1, np.float32), np.asarray(l1, np.float32),
            np.asarray(c2, np.float32), np.asarray(l2, np.float32),
            np.asarray(max_len, np.float32),
            np.asarray(bind, np.int32), bool(switch))
        return st, (1 if switch else 2)

    def _apply_msg2(self, st: SlamState, kf_id: int, kf_center, kf_len,
                    submap_id: int, info=None, max_len=None):
        if info is None:
            info = np.asarray(st.localMLP_info)
        max_len = np.asarray(st.localMLP_max_len[submap_id]
                             if max_len is None else max_len[submap_id])
        c, ln = expand_rule(info[submap_id, 1:4], info[submap_id, 4:7],
                            kf_center, kf_len, max_len)
        st = _msg2_apply(st, kf_id, submap_id,
                         np.asarray(c, np.float32),
                         np.asarray(ln, np.float32))
        self.last_binding = (kf_id, (int(submap_id), -1))
        return st, 2

    def _apply_msg3(self, st: SlamState, kf_id: int, frame_id: int,
                    kf_center, kf_len, active_id: int, pose_world,
                    info=None):
        if info is None:
            info = np.asarray(st.localMLP_info)
        new_id = int(info[:, 0].sum())  # first unused slot
        self.last_binding = (kf_id, (new_id, int(active_id)))
        st = _msg3_apply(st, kf_id, frame_id, new_id, int(active_id),
                         np.asarray(kf_center, np.float32),
                         np.asarray(kf_len, np.float32),
                         jnp.asarray(pose_world, jnp.float32))
        return st, 3, new_id

    # -- main entry (ref process_keyframe :365-369) ------------------------

    def process_keyframe(self, st: SlamState, depth: jnp.ndarray,
                         rays_d: jnp.ndarray, pose_local: jnp.ndarray,
                         frame_id: int, kf_id: int,
                         force: bool = False):
        if self.wait_loop:
            return self._process_wait_loop(st, depth, rays_d, pose_local,
                                           frame_id, kf_id, force)
        return self._process_normal(st, depth, rays_d, pose_local,
                                    frame_id, kf_id, force)

    def _predicates(self, st: SlamState, depth, rays_d, pose_local,
                    wait_id: int, frame_id: int = 0):
        """One fused device call + one BATCHED host readback (device_get
        fetches the whole dict at once instead of one sync per array). The submap tables and the
        active id ride along so neither the msg1/2/3 mutators nor the
        case analysis ever read back again. With the system-installed
        ``predicates_fn``, the speculative loop-closure verification
        rides along too (consumed by find_overlap_fn via _last_pred)."""
        if self.predicates_fn is not None:
            pred = jax.device_get(self.predicates_fn(
                st, depth, rays_d, pose_local, wait_id, frame_id))
        else:
            pred = jax.device_get(_predicates_fused(
                st, pose_local, depth, rays_d,
                jnp.asarray(max(wait_id, 0)),
                jnp.asarray(self.cfg.min_cr_localMLP_len, jnp.float32),
                self.cfg.near, self.cfg.far, self.cr_rows, self.cr_cols))
        self._last_pred = pred
        self._last_pred_state = st   # identity tag: results are only
        # valid for the exact (immutable) state snapshot they saw
        return pred

    def _process_normal(self, st: SlamState, depth, rays_d, pose_local,
                        frame_id: int, kf_id: int, force: bool,
                        pred=None):
        if pred is None:
            pred = self._predicates(st, depth, rays_d, pose_local, -1,
                                    frame_id)
        active_id = int(pred["active_id"])
        pose_world = jnp.asarray(pred["pose_world"])
        fr_center, fr_len = pred["fr_center"], pred["fr_len"]
        info, max_len = pred["localMLP_info"], pred["localMLP_max_len"]

        used = int(info[:, 0].sum())
        import os as _os
        if _os.environ.get("MIPS_DEBUG_MANAGER"):
            print(f"[mgr kf={kf_id} f={frame_id}] active={active_id} "
                  f"used={used} cr_act={float(pred['cr_active']):.3f} "
                  f"cr_new={float(pred['cr_active_new']):.3f} "
                  f"mo={int(pred['mo_id'])} cr_mo={float(pred['cr_mo']):.3f} "
                  f"force={force}", flush=True)
        mo_id = int(pred["mo_id"]) if used > 1 else active_id
        cr_mo = float(pred["cr_mo"])
        same = (mo_id == active_id)
        overlap_args = (st, depth, rays_d, pose_world)

        # case 1: containment without expansion
        cr_active = float(pred["cr_active"])
        if force or cr_active >= self.cfg.min_containing_ratio:
            if not same and cr_mo >= self.cfg.min_containing_ratio_mo:
                switch = self._double_binding(active_id, mo_id, cr_mo,
                                              overlap_args)
                st, flag = self._apply_msg1(st, kf_id, fr_center, fr_len,
                                            active_id, mo_id, pose_world,
                                            switch, info, max_len)
            else:
                st, flag = self._apply_msg2(st, kf_id, fr_center, fr_len,
                                            active_id, info, max_len)
                self.double_binding_counter = 0
            return st, flag

        # case 2: containment after expansion
        cr_new = float(pred["cr_active_new"])
        if cr_new >= self.cfg.min_containing_ratio:
            if not same and cr_mo >= self.cfg.min_containing_ratio_mo:
                switch = self._double_binding(active_id, mo_id, cr_mo,
                                              overlap_args)
                st, flag = self._apply_msg1(st, kf_id, fr_center, fr_len,
                                            active_id, mo_id, pose_world,
                                            switch, info, max_len)
            else:
                st, flag = self._apply_msg2(st, kf_id, fr_center, fr_len,
                                            active_id, info, max_len)
                self.double_binding_counter = 0
            return st, flag

        self.double_binding_counter = 0
        # cases 3-5
        if same:  # case 3: new submap
            st, flag, _ = self._apply_msg3(st, kf_id, frame_id, fr_center,
                                           fr_len, active_id, pose_world,
                                           info)
            self.wait_loop = False
            return st, flag
        if cr_mo < self.cfg.min_containing_ratio_back:  # case 4
            st, flag, _ = self._apply_msg3(st, kf_id, frame_id, fr_center,
                                           fr_len, active_id, pose_world,
                                           info)
            self.wait_loop = False
            return st, flag
        # case 5: camera re-entered a previous submap
        ok = False
        data = None
        if self.find_overlap_fn is not None:
            ok, data = self.find_overlap_fn(mo_id, active_id, st, depth,
                                            rays_d, pose_world)
        if ok:  # case 5.1: switch back
            self.ovlp_data = data
            st, flag = self._apply_msg1(st, kf_id, fr_center, fr_len,
                                        active_id, mo_id, pose_world, True,
                                        info, max_len)
            self.wait_loop = False
            return st, flag
        # case 5.2: new submap + wait for the loop to mature
        st, flag, new_id = self._apply_msg3(st, kf_id, frame_id, fr_center,
                                            fr_len, active_id, pose_world,
                                            info)
        self.wait_loop = True
        self.localMLP_Id_wait = mo_id
        self.localMLP_Id_actual = new_id
        return st, flag

    def _process_wait_loop(self, st: SlamState, depth, rays_d, pose_local,
                           frame_id: int, kf_id: int, force: bool):
        """Wait-loop re-check (ref process_keyframe_wait_loop :494-518).

        Reuses the fused predicate dispatch (cr_wait rides along), so
        the wait-loop frames cost the same ONE dispatch + ONE readback
        as normal keyframes instead of an eager pose/cr chain."""
        pred = self._predicates(st, depth, rays_d, pose_local,
                                self.localMLP_Id_wait, frame_id)
        active_id = int(pred["active_id"])
        pose_world = jnp.asarray(pred["pose_world"])
        cr_wt = float(pred["cr_wait"])
        if force or cr_wt < self.cfg.min_containing_ratio_back:
            return self._process_normal(st, depth, rays_d, pose_local,
                                        frame_id, kf_id, force, pred=pred)
        overlap_args = (st, depth, rays_d, pose_world)
        if not self._loop_flag(self.localMLP_Id_wait, active_id, cr_wt,
                               overlap_args):
            return self._process_normal(st, depth, rays_d, pose_local,
                                        frame_id, kf_id, force, pred=pred)
        st, flag = self._apply_msg1(st, kf_id,
                                    np.asarray(pred["fr_center"]),
                                    np.asarray(pred["fr_len"]), active_id,
                                    self.localMLP_Id_wait, pose_world, True)
        return st, flag


# ---------------------------------------------------------------------------
# fused decision predicates: ONE jitted call + ONE host readback per
# keyframe instead of one eager dispatch and sync per predicate
# ---------------------------------------------------------------------------

def expand_rule_jnp(center, length, kf_center, kf_len, max_len):
    """Vectorized jnp version of expand_rule (same semantics)."""
    kf_min = kf_center - 0.5 * kf_len
    kf_max = kf_center + 0.5 * kf_len
    lo, hi = center - 0.5 * length, center + 0.5 * length

    contained = jnp.all(kf_min >= lo) & jnp.all(kf_max <= hi)
    u_lo = jnp.minimum(kf_min, lo)
    u_hi = jnp.maximum(kf_max, hi)

    can = length < max_len
    fits = (u_hi - u_lo) <= max_len
    pos_need = jnp.abs(u_hi - hi)
    neg_need = jnp.abs(lo - u_lo)
    budget = max_len - length
    single = (pos_need == 0.0) | (neg_need == 0.0)
    denom = jnp.maximum(pos_need + neg_need, 1e-12)

    hi_c2 = jnp.where(pos_need > 0, hi + budget, hi)
    lo_c2 = jnp.where(pos_need > 0, lo, lo - budget)
    hi_c3 = hi + budget * pos_need / denom
    lo_c3 = lo - budget * neg_need / denom

    new_hi = jnp.where(~can, hi,
                       jnp.where(fits, u_hi,
                                 jnp.where(single, hi_c2, hi_c3)))
    new_lo = jnp.where(~can, lo,
                       jnp.where(fits, u_lo,
                                 jnp.where(single, lo_c2, lo_c3)))
    new_hi = jnp.where(contained, hi, new_hi)
    new_lo = jnp.where(contained, lo, new_lo)
    new_len = new_hi - new_lo
    return new_lo + 0.5 * new_len, new_len


@partial(jax.jit, static_argnames=())
def manager_predicates(localMLP_info, localMLP_max_len, anchor,
                       pose_local, depth_img, rays_d_img, active_id,
                       wait_id, min_cr_len, near, far, rows, cols):
    """All per-keyframe decision quantities in one device program.

    Returns a dict of small arrays: frustum bbox, cr_active,
    cr_active_expanded (+ the expanded AABB), the most-overlapping
    submap id among the top-3 nearest (excluding active), its cr, and
    cr of the wait-loop submap.
    """
    pose_world = _mm_pose(anchor, pose_local)
    fr_center, fr_len = get_frame_surface_bbox(
        pose_world, depth_img, rays_d_img, near, far)

    # surface points shared by all predicates
    d = depth_img[rows, cols][:, None]
    dirs = rays_d_img[rows, cols]
    rays_o, rays_d = rays_to_world(dirs, pose_world)
    pts = rays_o + rays_d * d
    valid = d[:, 0] > 0.0
    n_valid = jnp.maximum(jnp.sum(valid), 1)

    def cr_of(center, length, apply_floor):
        ln = jnp.where(apply_floor, jnp.maximum(length, min_cr_len),
                       length)
        lo, hi = center - 0.5 * ln, center + 0.5 * ln
        inside = jnp.all((pts > lo) & (pts < hi), axis=-1)
        return jnp.sum(inside & valid) / n_valid

    M = localMLP_info.shape[0]
    used = localMLP_info[:, 0] > 0
    centers = localMLP_info[:, 1:4]
    lengths = localMLP_info[:, 4:7]

    cr_active = cr_of(centers[active_id], lengths[active_id], True)
    new_c, new_l = expand_rule_jnp(centers[active_id], lengths[active_id],
                                   fr_center, fr_len,
                                   localMLP_max_len[active_id])
    cr_active_new = cr_of(new_c, new_l, False)

    # most-overlapping among top-3 nearest used submaps excluding active
    dists = jnp.linalg.norm(centers - fr_center, axis=-1)
    excl = (~used) | (jnp.arange(M) == active_id)
    dists = jnp.where(excl, 1e9, dists)
    _, top3 = jax.lax.top_k(-dists, 3)
    lo3 = centers[top3] - 0.5 * lengths[top3]
    hi3 = centers[top3] + 0.5 * lengths[top3]
    inside3 = jnp.all((pts[:, None, :] > lo3[None]) &
                      (pts[:, None, :] < hi3[None]), axis=-1)   # [N,3]
    scores = jnp.sum(inside3 & valid[:, None], axis=0)
    scores = jnp.where(dists[top3] >= 1e9, -1, scores)
    mo_id = top3[jnp.argmax(scores)]
    cr_mo = cr_of(centers[mo_id], lengths[mo_id], True)
    n_avail = jnp.sum(~excl)
    mo_id = jnp.where(n_avail > 0, mo_id, active_id)

    cr_wait = cr_of(centers[wait_id], lengths[wait_id], True)

    return {
        "fr_center": fr_center, "fr_len": fr_len,
        "cr_active": cr_active, "cr_active_new": cr_active_new,
        "new_center": new_c, "new_len": new_l,
        "mo_id": mo_id, "cr_mo": cr_mo, "cr_wait": cr_wait,
        "pose_world": pose_world,
    }


def _mm_pose(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
