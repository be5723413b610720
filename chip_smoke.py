"""Bring-up check: the SLAM main path on NVIDIA GPUs, against the plain
float32 reference.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --devices 4  # the four-GPU path only

Run from the repository root. With one GPU, in one process, in order:

  1. device check: JAX must see a GPU, or the script exits non-zero;
  2. compile each stage at configs/base.yaml widths (first fit, tracking
     with RO only, GO only and both, the local-BA step, the mesher grid
     query) and print its memory analysis;
  3. the GPU field path against the plain float32 reference at highest
     matmul precision: the field query on one mesher slab, one BA loss
     and its gradients, one RO fitness batch and the particle it picks;
  4. the full-budget orbit drive (configs/synthetic/orbit.yaml): stage
     times, frames per second, peak device memory, ATE < 0.02 m;
  5. the multi-submap outback drive (configs/synthetic/outback_fast.yaml):
     submaps, switch-backs, ATE < 0.045 m, and the joint mesh.

With ``--devices 4`` it runs only the path that exists across cards:
one ray-parallel BA loss and its gradients on four cards against one
card, one sharded refine step against per-submap steps, and the outback
drive on four cards against one card.

Every line with a time or a size names the card and its power limit.
The last line, printed only when every phase passed, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The phases are functions of a ``SizeProfile``, so the tests run them at
a tiny size on the CPU; ``main`` refuses every platform but "gpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Tuple

from mipsfusion_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mipsfusion_tpu.config import apply_overrides, load_config  # noqa: E402
from mipsfusion_tpu.mesher import MeshConfig, Mesher  # noqa: E402
from mipsfusion_tpu.models import scene_rep as sr  # noqa: E402
from mipsfusion_tpu.slam import mapper, tracker  # noqa: E402
from mipsfusion_tpu.slam.system import MIPSFusionTPU, _get_ba_step  # noqa


@dataclasses.dataclass(frozen=True)
class SizeProfile:
    """Sizes of one smoke run. The defaults are the configs' own widths
    and budgets; ``overrides`` (dotted config paths) shrink them for
    CPU tests."""
    orbit_config: str = "configs/synthetic/orbit.yaml"
    orbit_frames: int = 40          # > 2 keyframe cycles (keyframe_every 15)
    outback_config: str = "configs/synthetic/outback_fast.yaml"
    outback_frames: int = 200
    overrides: Tuple[Tuple[str, object], ...] = ()
    mesh_slab: int = 131072         # MeshConfig.query_chunk
    stage_reps: int = 10
    orbit_ate_max: float = 0.02     # tests/test_slam_single.py bound
    outback_ate_max: float = 0.045  # tests/test_loop_closure_e2e.py bound
    devices_ate_delta: float = 0.02  # tests/test_sharded_whole_system.py


FULL = SizeProfile()


class Report:
    """Prints each line prefixed with the card's name and power limit."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


class CheckFailed(AssertionError):
    pass


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def device_check(n_devices: int = 1) -> Tuple[str, str, int]:
    """Exit non-zero unless JAX sees at least ``n_devices`` GPUs."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{d.platform!r}); refusing to run")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: {n_devices} GPUs requested, JAX "
                         f"sees {len(devs)}")
    return d.platform, d.device_kind, len(devs)


def gpu_card() -> str:
    """Name and power limit of the card(s), from nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _config(path: str, profile: SizeProfile, n_frames: int) -> Dict:
    cfg = apply_overrides(load_config(path), dict(profile.overrides))
    full = cfg["synthetic"]["n_frames"]
    cfg["synthetic"]["n_frames"] = n_frames
    # a shortened sequence keeps the full sequence's per-frame motion
    cfg["synthetic"]["span"] = n_frames / full
    cfg["data"]["output"] = None
    return cfg


def orbit_config(profile: SizeProfile) -> Dict:
    return _config(profile.orbit_config, profile, profile.orbit_frames)


def outback_config(profile: SizeProfile) -> Dict:
    return _config(profile.outback_config, profile, profile.outback_frames)


def _bytes(n) -> str:
    return f"{int(n) / 2**20:.1f} MiB"


def _peak_bytes() -> str:
    stats = jax.devices()[0].memory_stats()
    if not stats:
        return "not reported by this backend"
    return _bytes(stats["peak_bytes_in_use"])


def _timeit(fn: Callable, reps: int) -> float:
    """Mean ms per call: host clock around work ending in
    block_until_ready, after one warm call."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# phase 2: compile every stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    compiled: object
    args: Callable    # (slam, params, state, packed) -> (args, kwargs)


def _stage_table(slam: MIPSFusionTPU, profile: SizeProfile) -> Dict:
    """name -> (lower, args) of each stage. ``args`` builds the dynamic
    arguments of the compiled program; ``lower`` calls the jitted
    function as the system calls it (static arguments in place)."""
    mcfg = slam.mcfg
    n_init = slam._round_rays(mcfg.mapping_sample_init)
    ba = _get_ba_step(slam.fcfg, mcfg, slam.lw,
                      slam._round_rays(mcfg.sample + mcfg.pixels_cur),
                      slam._ray_sharding)
    mesher = Mesher(slam.fcfg, slam.consts,
                    MeshConfig(query_chunk=profile.mesh_slab))
    frame_idx = 2
    table = {}

    def fit_args(s, params, st, packed):
        return (params, s.map_opt_state, jax.random.PRNGKey(0),
                packed.reshape(-1, 7), s.consts, s.lw), {}

    def fit_lower(s, params, st, packed):
        p, o, k, r, c, lw = fit_args(s, params, st, packed)[0]
        return mapper.init_submap_fit.lower(
            p, o, k, r, s.fcfg, c, mcfg, lw, mcfg.first_iters, n_init,
            ray_sharding=s._ray_sharding)

    table["first_fit"] = (fit_lower, fit_args)

    def track(n_ro, n_go):
        def args(s, params, st, packed):
            return (), dict(
                field_params=params, consts=s.consts, pst=s.pst,
                key=jax.random.PRNGKey(0), rgb_img=packed[..., 3:6],
                depth_img=packed[..., 6], rays_dir_img=packed[..., :3],
                est_c2w=st.est_c2w, frame_idx=jnp.asarray(frame_idx),
                use_const_speed=jnp.asarray(True), lw=s.lw)

        def lower(s, params, st, packed):
            return tracker.track_frame.lower(
                **args(s, params, st, packed)[1], fcfg=s.fcfg_track,
                rcfg=s.rcfg, gcfg=s.gcfg, n_iter_ro=n_ro, n_iter_go=n_go)
        return lower, args

    table["track_ro"] = track(slam.rcfg.n_iters, 0)
    table["track_go"] = track(0, slam.gcfg.n_iters)
    table["track_ro_go"] = track(slam.rcfg.n_iters, slam.gcfg.n_iters)

    def ba_args(s, params, st, packed):
        return (st, params, s.map_opt_state, packed.reshape(-1, 7),
                frame_idx, s.consts, s._ba_key, s._kf_frames_dev), {}

    table["local_ba"] = (lambda *a: ba.lower(*ba_args(*a)[0]), ba_args)

    def mesh_args(s, params, st, packed):
        return (params, mesh_slab_points(s.config, profile.mesh_slab)), {}

    table["mesher_query"] = (
        lambda *a: mesher._query.lower(*mesh_args(*a)[0]), mesh_args)
    return table


def mesh_slab_points(cfg: Dict, n: int) -> jnp.ndarray:
    """n points spread uniformly over the scene bound (seeded)."""
    b = np.asarray(cfg["mapping"]["bound"], np.float32)
    u = np.random.default_rng(0).uniform(size=(n, 3)).astype(np.float32)
    return jnp.asarray(b[:, 0] + u * (b[:, 1] - b[:, 0]))


def compile_stages(slam: MIPSFusionTPU, profile: SizeProfile,
                   report: Report) -> Dict[str, Stage]:
    """Compile every stage ahead of time; print compile seconds (set-up
    time) and each program's memory analysis."""
    packed = slam.dataset.packed(0)
    stages = {}
    for name, (lower, args) in _stage_table(slam, profile).items():
        t0 = time.perf_counter()
        compiled = lower(slam, slam.initial_params, slam.state,
                         packed).compile()
        secs = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        mem = ("not reported" if ma is None else
               f"arguments {_bytes(ma.argument_size_in_bytes)}, outputs "
               f"{_bytes(ma.output_size_in_bytes)}, temporaries "
               f"{_bytes(ma.temp_size_in_bytes)}, aliased "
               f"{_bytes(ma.alias_size_in_bytes)}, code "
               f"{_bytes(ma.generated_code_size_in_bytes)}")
        report(f"compile {name}: {secs:.1f} s (set-up); memory: {mem}")
        stages[name] = Stage(compiled, args)
    return stages


def call_stage(stage: Stage, slam, params, st, packed):
    pos, kw = stage.args(slam, params, st, packed)
    return stage.compiled(*pos, **kw)


# ---------------------------------------------------------------------------
# phase 3: the GPU field path against the plain float32 reference
# ---------------------------------------------------------------------------
#
# Tolerances. The GPU path (scene_rep.for_platform) rounds the decoder's
# matmul operands to bf16 (8 significant bits, about 3 decimal digits)
# and accumulates in f32; the reference is the plain f32 path at highest
# matmul precision. The drives' ATE bounds are the accuracy check that
# matters; these catch a wrong path or precision plumbing.
#   * field query on a mesher slab: SDF (units of the truncation, in
#     [-1, 1]; one class step is 0.5) mean error 5e-3, max 0.1 — five
#     layers of 3-digit operands move a logit by up to ~0.1 where the
#     classifier is steep;
#   * BA first-surface windows: each ray's compositing window ends one
#     truncation past its first SDF sign change, a step function of the
#     SDF. A sample whose SDF lies within the paths' SDF gap of zero can
#     move it, and with it the whole ray's loss and gradient, so the
#     gradient is compared on the rays whose window is the same on both
#     paths, with the stratified jitter off so that a ray's samples do
#     not depend on the batch. At most 10% of the rays may differ:
#     rounding moved 5-6% of them on an H100 (PERF.md), a path that is
#     wrong moves most;
#   * BA loss and RO fitness: 2e-2 relative — means over 10^5 samples
#     average the rounding noise;
#   * BA gradients: 5e-2 relative L2 error of the whole gradient, and a
#     cosine of at least 0.9 per leaf — a leaf whose gradient is a
#     cancelling sum (a bias) has a large relative error but must still
#     point the same way;
#   * the RO particle picked by the GPU path must score, under the
#     reference, within 2e-2 relative of the reference's best particle.

QUERY_TOL = (0.1, 5e-3)         # (max, mean) |GPU path - reference| SDF
REL_TOL = 2e-2                  # losses, RO fitness, picked particle
GRAD_TOL = (5e-2, 0.9)          # (global relative L2, per-leaf cosine)
WINDOW_TOL = 0.1                # share of BA rays whose window differs


def reference_fcfg(cfg: Dict) -> sr.FieldConfig:
    """The plain float32 field path of ``cfg`` (built without
    ``for_platform``, so that it stays float32 whatever that chooses)."""
    fcfg = sr.FieldConfig.from_dict(cfg)
    return dataclasses.replace(
        fcfg, decoder=dataclasses.replace(fcfg.decoder, bf16=False))


def _highest(fn: Callable):
    with jax.default_matmul_precision("highest"):
        return jax.block_until_ready(fn())


def ro_batch(slam: MIPSFusionTPU, packed: jnp.ndarray, pose: jnp.ndarray):
    """One RO fitness batch at the configured width: the PST around
    ``pose`` at the initial search size, on the RO pixel grid."""
    from mipsfusion_tpu.ops.geometry import quaternion_to_matrix
    rcfg = slam.rcfg
    rows, cols = tracker.ro_pixel_grid(packed.shape[0], packed.shape[1],
                                       rcfg)
    d = packed[rows, cols, 6][:, None]
    pts_cam = packed[rows, cols, :3] * d
    valid = (d[:, 0] > 0.0).astype(jnp.float32)
    pst7 = tracker._pose_6d_to_7d(slam.pst * rcfg.initial_scaling_factor)
    rot = jnp.einsum("ij,pjk->pik", pose[:3, :3],
                     quaternion_to_matrix(pst7[:, :4]),
                     precision=jax.lax.Precision.HIGHEST)
    trans = pose[:3, 3][None, :] + pst7[:, 4:]
    return rot, trans, pts_cam, valid


def _diff(a, b) -> Tuple[float, float]:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def field_checks(slam: MIPSFusionTPU, stages: Dict[str, Stage],
                 profile: SizeProfile, report: Report) -> Dict:
    """Phase 3, on the field after the first fit of frame 0."""
    ds, consts, fcfg = slam.dataset, slam.consts, slam.fcfg
    ref = reference_fcfg(slam.config)
    params, _, _ = call_stage(stages["first_fit"], slam, slam.initial_params,
                              slam.state, ds.packed(0))
    packed = ds.packed(1)
    # frame 1's pose in the local frame of the submap anchored at frame 0
    pose = jnp.asarray(np.linalg.inv(ds.gt_pose(0)) @ ds.gt_pose(1),
                       jnp.float32)
    rot, trans, pts_cam, valid = ro_batch(slam, packed, pose)
    failures = []

    def within(name, value, tol, above=False):
        ok = value >= tol if above else value <= tol
        if not ok:
            failures.append(f"{name} {value:.3e} {'<' if above else '>'} "
                            f"{tol:.1e}")
        return f"{value:.3e} (tol {tol:.1e})"

    # the field query on one mesher slab
    pts = mesh_slab_points(slam.config, profile.mesh_slab)
    query = lambda c: jax.jit(lambda p, x: sr.run_network(  # noqa: E731
        p, x, c, consts)[:, :5])
    y_g = query(fcfg)(params, pts)
    y_r = _highest(lambda: query(ref)(params, pts))
    sdf_err = _diff(y_g[:, 3], y_r[:, 3])
    report(f"field query, mesher slab of {profile.mesh_slab} points: SDF "
           f"|GPU path - f32 reference| max "
           f"{within('query max', sdf_err[0], QUERY_TOL[0])}, mean "
           f"{within('query mean', sdf_err[1], QUERY_TOL[1])}; rgb logits "
           f"max {_diff(y_g[:, :3], y_r[:, :3])[0]:.3e}, entropy max "
           f"{_diff(y_g[:, 4], y_r[:, 4])[0]:.3e}")

    # one BA loss and its gradients at BA width, at frame 1's pose, on
    # the rays whose first-surface window is the same on both paths
    mcfg, lw = slam.mcfg, slam.lw
    n_rays = mcfg.sample + mcfg.pixels_cur
    flat = packed.reshape(-1, 7)
    idx = np.linspace(0, flat.shape[0] - 1, n_rays).astype(np.int32)
    key = jax.random.PRNGKey(3)
    # without the stratified jitter a ray's z samples depend on the ray
    # alone, so they stay the same in a subset of the batch
    fixed_z = lambda c: dataclasses.replace(c, perturb=False)  # noqa: E731

    def window(c):
        def fn(p, r):
            rd = r[:, :3] @ pose[:3, :3].T
            ro = jnp.broadcast_to(pose[:3, 3], rd.shape)
            rend = sr.render_rays_T(p, key, ro.T, rd.T, r[:, 6:7], c, consts)
            return sr.first_surface_mask(rend["rawT"][3], rend["z_vals"], c)
        return jax.jit(fn)

    rays = flat[jnp.asarray(idx)]
    w_g = np.asarray(window(fixed_z(fcfg))(params, rays))
    w_r = np.asarray(_highest(lambda: window(fixed_z(ref))(params, rays)))
    same = np.all(w_g == w_r, axis=1)
    flipped = float(1.0 - same.mean())
    rays = flat[jnp.asarray(idx[same])]
    rays_d = rays[:, :3] @ pose[:3, :3].T
    rays_o = jnp.broadcast_to(pose[:3, 3], rays_d.shape)

    def ba_grad(c):
        def loss(p, ro, rd):
            ret = sr.forward_losses_T(p, key, ro.T, rd.T, rays[:, 3:6].T,
                                      rays[:, 6:7], fixed_z(c), consts)
            return sr.total_loss(ret, lw)
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))

    l_g, g_g = ba_grad(fcfg)(params, rays_o, rays_d)
    l_r, g_r = _highest(lambda: ba_grad(ref)(params, rays_o, rays_d))
    rel = abs(float(l_g) - float(l_r)) / max(abs(float(l_r)), 1e-12)
    fg, fr = (jax.flatten_util.ravel_pytree(g)[0] for g in (g_g, g_r))
    g_rel = float(jnp.linalg.norm(fg - fr) / jnp.linalg.norm(fr))
    worst, worst_name = 1.0, ""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_g),
                            jax.tree.leaves(g_r)):
        cos = float(jnp.dot(a.ravel(), b.ravel()) / jnp.maximum(
            jnp.linalg.norm(a) * jnp.linalg.norm(b), 1e-30))
        if cos <= worst:
            worst, worst_name = cos, jax.tree_util.keystr(path)
    report(f"BA first-surface windows that differ between the paths: "
           f"{int((~same).sum())} of {n_rays} rays, share "
           f"{within('BA windows differing', flipped, WINDOW_TOL)}")
    report(f"BA loss ({int(same.sum())} rays x {fcfg.n_samples_total} "
           f"samples): GPU path {float(l_g):.6f}, f32 reference "
           f"{float(l_r):.6f}, "
           f"relative error {within('BA loss', rel, REL_TOL)}; gradient "
           f"relative L2 error {within('BA gradient', g_rel, GRAD_TOL[0])}"
           f"; lowest per-leaf cosine {worst_name} "
           f"{within('BA gradient cosine', worst, GRAD_TOL[1], above=True)}")

    # one RO fitness batch and the particle it picks
    def fitness(c):
        return jax.jit(lambda p: tracker.ro_fitness(
            p, c, consts, rot, trans, pts_cam, valid,
            slam.rcfg.sdf_weight)[0])

    f_g = np.asarray(fitness(slam.fcfg_track)(params))
    f_r = np.asarray(_highest(lambda: fitness(ref)(params)))
    f_err = float(np.abs(f_g - f_r).max() / max(np.abs(f_r).max(), 1e-12))
    i_g, i_r = int(np.argmin(f_g)), int(np.argmin(f_r))
    pick = float((f_r[i_g] - f_r[i_r]) / max(abs(f_r[i_r]), 1e-12))
    report(f"RO fitness ({len(f_g)} particles x {pts_cam.shape[0]} px): "
           f"relative error {within('RO fitness', f_err, REL_TOL)}; "
           f"picked particle GPU {i_g}, reference {i_r}, reference "
           f"fitness gap {within('RO pick', pick, REL_TOL)}")
    _check(not failures, "field checks failed: " + "; ".join(failures))
    return {"query_sdf_err": sdf_err, "ba_windows_differing": flipped,
            "ba_loss_rel": rel,
            "ba_grad_rel": g_rel, "ba_grad_cos": worst, "ro_fit_rel": f_err,
            "ro_pick": (i_g, i_r)}


# ---------------------------------------------------------------------------
# phases 4 and 5: the drives
# ---------------------------------------------------------------------------

def orbit_drive(stages: Dict[str, Stage], profile: SizeProfile,
                report: Report) -> Dict:
    """Two runs of the orbit through ``MIPSFusionTPU(cfg).run()``: the
    first compiles what phase 2 did not, the second is timed warm."""
    cfg = orbit_config(profile)
    n = cfg["synthetic"]["n_frames"]
    cold = MIPSFusionTPU(cfg).run(verbose=False)
    slam = MIPSFusionTPU(cfg)
    res = slam.run(verbose=False)
    packed = slam.dataset.packed(n - 1)
    params = slam.submap_params[slam.active_id]
    stage_ms = {
        name: _timeit(lambda name=name: call_stage(
            stages[name], slam, params, slam.state, packed),
            profile.stage_reps)
        for name in ("track_ro", "track_go", "track_ro_go", "local_ba")}
    out = {"ate": res["absolute_translational_error.rmse"],
           "ate_first_run": cold["absolute_translational_error.rmse"],
           "fps": res["fps"], "fps_first_run": cold["fps"],
           "stage_ms": stage_ms, "peak": _peak_bytes()}
    report(f"orbit {n} frames: run() {out['fps']:.2f} frames/s warm, "
           f"{out['fps_first_run']:.2f} frames/s first run (incl. "
           f"compiles); ATE {out['ate']:.5f} m warm, "
           f"{out['ate_first_run']:.5f} m first run (bound "
           f"{profile.orbit_ate_max} m); peak device memory {out['peak']}")
    report("orbit stage times (ms per call, host clock around "
           "block_until_ready): " + ", ".join(
               f"{k} {v:.2f}" for k, v in stage_ms.items())
           + f"; per frame at map_every={slam.map_every}: "
           f"{stage_ms['track_ro_go'] + stage_ms['local_ba'] / slam.map_every:.2f}")
    return out


def check_orbit(res: Dict, profile: SizeProfile) -> None:
    worst = max(res["ate"], res["ate_first_run"])
    _check(worst < profile.orbit_ate_max,
           f"orbit ATE {worst:.5f} m >= {profile.orbit_ate_max} m")


def outback_drive(profile: SizeProfile, report: Report, label: str = "",
                  parallel: Dict = None, mesh: bool = True) -> Dict:
    """The outback through ``run()``, then (with ``mesh``)
    ``extract_mesh`` called directly so that a meshing failure raises."""
    cfg = outback_config(profile)
    if parallel is not None:
        cfg["parallel"] = parallel
    slam = MIPSFusionTPU(cfg)
    backs = []
    switch = slam.active_submap_switch

    def spy(frame, i, kf_id):
        backs.append(i)
        return switch(frame, i, kf_id)

    slam.active_submap_switch = spy
    res = slam.run(verbose=False)
    t0 = time.perf_counter()
    verts, faces, _ = slam.extract_mesh() if mesh else ((), (), ())
    mesh_s = time.perf_counter() - t0
    out = {"ate": res["absolute_translational_error.rmse"],
           "fps": res["fps"], "n_submaps": res["n_submaps"],
           "switch_backs": len(backs), "mesh_s": mesh_s,
           "n_verts": len(verts), "n_faces": len(faces),
           "devices": slam.n_devices if (slam.use_dp_hot
                                         or slam.use_sharded_refine) else 1}
    report(f"outback{label} {cfg['synthetic']['n_frames']} frames on "
           f"{out['devices']} device(s): run() {out['fps']:.2f} frames/s "
           f"(incl. compiles); {out['n_submaps']} submaps, "
           f"{out['switch_backs']} switch-backs at frames {backs}; ATE "
           f"{out['ate']:.5f} m (bound {profile.outback_ate_max} m)"
           + (f"; mesh {out['n_verts']} vertices, {out['n_faces']} faces "
              f"in {mesh_s:.2f} s wall" if mesh else ""))
    return out


def check_outback(res: Dict, profile: SizeProfile) -> None:
    _check(res["switch_backs"] >= 1, "outback made no switch-back")
    _check(res["n_faces"] > 0, "outback mesh is empty")
    _check(res["ate"] < profile.outback_ate_max,
           f"outback ATE {res['ate']:.5f} m >= {profile.outback_ate_max} m")


# ---------------------------------------------------------------------------
# the four-device path
# ---------------------------------------------------------------------------

DP_TOL = (1e-4, 1e-3)   # (loss relative, gradient max-abs relative): the
# same per-ray arithmetic, summed in another order across devices


def _grad_gap(a, b) -> float:
    """Largest per-leaf max |a - b| relative to max |b|."""
    gaps = jax.tree.map(
        lambda x, y: float(jnp.max(jnp.abs(x - y))
                           / jnp.maximum(jnp.max(jnp.abs(y)), 1e-20)), a, b)
    return max(jax.tree.leaves(gaps))


def _dp_inputs(profile: SizeProfile, n: int, n_sets: int):
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.mapper import MapConfig
    cfg = outback_config(profile)
    platform = jax.default_backend()
    fcfg = sr.for_platform(sr.FieldConfig.from_dict(cfg), platform)
    mcfg, lw = MapConfig.from_dict(cfg), sr.LossWeights.from_dict(cfg)
    consts = sr.FieldConsts.from_bound(
        jnp.asarray(cfg["mapping"]["bound"], jnp.float32))
    n_rays = -(-(mcfg.sample + mcfg.pixels_cur) // n) * n
    ds = SyntheticDataset(cfg, n_frames=n_sets, trajectory="outback",
                          span=n_sets / cfg["synthetic"]["n_frames"])
    rays = []
    for f in range(n_sets):
        flat = ds.packed(f).reshape(-1, 7)
        idx = np.linspace(0, flat.shape[0] - 1, n_rays).astype(np.int32)
        rays.append(flat[jnp.asarray(idx)])
    return cfg, fcfg, mcfg, lw, consts, jnp.stack(rays)


def dp_ba_check(profile: SizeProfile, report: Report, n: int) -> None:
    """One BA loss and its gradients with the ray batch sharded over n
    devices (params replicated) against the same on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mipsfusion_tpu.parallel import sharding as sh
    cfg, fcfg, _, lw, consts, rays = _dp_inputs(profile, n, 1)
    rays = rays[0]
    params = sr.init_field_params(jax.random.PRNGKey(0), fcfg)
    key = jax.random.PRNGKey(1)
    one = jax.jit(lambda p, r, k: sh.refine_loss_and_grads(
        p, k, r, consts.bb_lo, consts.bb_inv_extent, fcfg=fcfg, lw=lw))
    l1, g1 = one(params, rays, key)
    mesh = sh.make_mesh(n)
    rep, rsh = NamedSharding(mesh, P()), sh.ray_sharded(mesh)
    multi = jax.jit(lambda p, r, k: sh.refine_loss_and_grads(
        p, k, r, consts.bb_lo, consts.bb_inv_extent, fcfg=fcfg, lw=lw),
        in_shardings=(rep, rsh, rep), out_shardings=rep)
    ln, gn = multi(jax.device_put(params, rep), jax.device_put(rays, rsh),
                   key)
    rel = abs(float(ln) - float(l1)) / max(abs(float(l1)), 1e-12)
    gap = _grad_gap(gn, g1)
    report(f"ray-DP BA loss, {rays.shape[0]} rays on {n} devices vs 1: "
           f"loss {float(ln):.6f} vs {float(l1):.6f} (relative "
           f"{rel:.2e}, tol {DP_TOL[0]:.0e}); gradients max relative gap "
           f"{gap:.2e} (tol {DP_TOL[1]:.0e})")
    _check(rel <= DP_TOL[0] and gap <= DP_TOL[1],
           "ray-DP BA loss/gradients differ from one device")


def sharded_refine_check(profile: SizeProfile, report: Report,
                         n: int) -> None:
    """One sharded refine step over n stacked submaps (one per device)
    against per-submap unsharded loss and gradients."""
    from mipsfusion_tpu.parallel import sharding as sh
    cfg, fcfg, mcfg, lw, consts, rays = _dp_inputs(profile, n, n)
    opt = mapper.make_map_optimizer(mcfg)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    stacked = jax.vmap(lambda k: sr.init_field_params(k, fcfg))(keys)
    lo = jnp.broadcast_to(consts.bb_lo, (n, 3))
    inv = jnp.broadcast_to(consts.bb_inv_extent, (n, 3))
    mesh = sh.make_mesh(n)
    ssh = sh.submap_sharded(mesh)
    put = lambda x: jax.device_put(x, ssh)            # noqa: E731
    step = sh.make_sharded_refine_step(mesh, fcfg, lw, opt)
    _, _, losses = step(put(stacked), put(jax.vmap(opt.init)(stacked)),
                        keys, put(rays), put(lo), put(inv))
    grads_sh = jax.jit(
        jax.vmap(lambda p, k, r, a, b: sh.refine_loss_and_grads(
            p, k, r, a, b, fcfg=fcfg, lw=lw)),
        in_shardings=(ssh,) * 5, out_shardings=ssh)(
            put(stacked), put(keys), put(rays), put(lo), put(inv))[1]
    one = jax.jit(lambda p, k, r, a, b: sh.refine_loss_and_grads(
        p, k, r, a, b, fcfg=fcfg, lw=lw))
    rel, gap = 0.0, 0.0
    for m in range(n):
        pm = jax.tree.map(lambda x: x[m], stacked)
        l1, g1 = one(pm, keys[m], rays[m], lo[m], inv[m])
        rel = max(rel, abs(float(losses[m]) - float(l1))
                  / max(abs(float(l1)), 1e-12))
        gap = max(gap, _grad_gap(jax.tree.map(lambda x: x[m], grads_sh), g1))
    report(f"sharded refine step, {n} submaps on {n} devices vs per-submap "
           f"steps: loss relative gap {rel:.2e} (tol {DP_TOL[0]:.0e}); "
           f"gradients max relative gap {gap:.2e} (tol {DP_TOL[1]:.0e})")
    _check(rel <= DP_TOL[0] and gap <= DP_TOL[1],
           "sharded refine differs from per-submap steps")


def devices_outback(profile: SizeProfile, report: Report, n: int) -> Dict:
    """The outback with ray-DP and sharded refine on n devices (the
    system's default when it sees several) against one device."""
    single = outback_drive(profile, report, " (1 device)",
                           parallel={"sharded_refine": False,
                                     "dp_hot_path": False}, mesh=False)
    multi = outback_drive(profile, report, f" ({n} devices)", mesh=False)
    delta = abs(multi["ate"] - single["ate"])
    report(f"outback ATE on {n} devices {multi['ate']:.5f} m vs 1 device "
           f"{single['ate']:.5f} m: |delta| {delta:.5f} m (bound "
           f"{profile.devices_ate_delta} m)")
    _check(multi["devices"] == n, f"the system did not use {n} devices")
    _check(multi["switch_backs"] >= 1,
           f"outback on {n} devices made no switch-back")
    _check(delta < profile.devices_ate_delta,
           f"outback ATE differs by {delta:.5f} m across device counts")
    return {"single": single, "multi": multi, "delta": delta}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_one_device(profile: SizeProfile, report: Report) -> None:
    slam = MIPSFusionTPU(orbit_config(profile))
    stages = compile_stages(slam, profile, report)
    field_checks(slam, stages, profile, report)
    check_orbit(orbit_drive(stages, profile, report), profile)
    check_outback(outback_drive(profile, report), profile)


def run_devices(profile: SizeProfile, report: Report, n: int) -> None:
    dp_ba_check(profile, report, n)
    sharded_refine_check(profile, report, n)
    devices_outback(profile, report, n)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-GPU path")
    args = ap.parse_args(argv)
    platform, kind, count = device_check(args.devices)
    card = gpu_card()
    report = Report(card.split(";")[0])
    report(f"JAX devices: {count} x {kind} ({platform}); jax "
           f"{jax.__version__}")
    if args.devices == 1:
        run_one_device(FULL, report)
    else:
        run_devices(FULL, report, args.devices)
    print(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}))


if __name__ == "__main__":
    main(sys.argv[1:])
