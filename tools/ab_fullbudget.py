"""A/B full-budget speed levers against ATE (VERDICT r4 item 1).

Each variant runs the orbit benchmark scene at the REFERENCE compute
budgets (5x2000x384 RO, 10x1000x75 GO, 15x2600 BA — configs/synthetic/
orbit.yaml) with ONE lever applied, reporting steady-state FPS (median
of 3 windows, bench.py methodology) and ATE. Variants that hold orbit
ATE are re-validated on the two stress scenes (outback multi-submap
switch-backs, sweep fast-motion) before being adopted.

    python tools/ab_fullbudget.py                 # orbit sweep
    python tools/ab_fullbudget.py --variant z39 --stress   # validate

Levers (VERDICT r4 next-round item 1):
  * z-importance cuts: the z-sampler is already depth-guided
    (n_range_d samples in +-range_d around measured depth + n_samples_d
    uniform free-space samples, ref model/scene_rep.py:156-176); the
    uniform tail mostly supplies free-space supervision, so it thins
    first. The fast profile's 24+15=39 holds ATE at fast budgets
    (BASELINE.md); this quantifies where 75 is actually needed at FULL
    budgets.
  * decoder width: trunk hidden_dim 128 -> 64 (decoder is ~47% of the
    fused forward kernel, tools/profile_field.py attribution).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

Z39 = {"training.n_samples_d": 24, "training.n_range_d": 15}
Z27 = {"training.n_samples_d": 16, "training.n_range_d": 11}

ZGO27 = {"tracking.n_samples_d": 16, "tracking.n_range_d": 11}
ZGO39 = {"tracking.n_samples_d": 24, "tracking.n_range_d": 15}

VARIANTS = {
    "full": {},
    "z39": Z39,
    "z27": Z27,
    "dec64": {"decoder.hidden_dim": 64},
    "pe6": {"pos.n_bins": 6},
    "z27+dec64": {**Z27, "decoder.hidden_dim": 64},
    "z27+dec64+pe6": {**Z27, "decoder.hidden_dim": 64, "pos.n_bins": 6},
    # per-stage splits (tracking.* override the z-ladder for GO only;
    # mapping keeps training.*)
    "zgo27": ZGO27,                       # GO thin, BA at the full 75
    "zgo27+zba39": {**ZGO27, **Z39},      # GO thin, BA mid
    "zgo39+zba39": {**ZGO39, **Z39},
    # two-stage RO screen: all 2000 particles on 96 px, best 512 on the
    # full 384 px (tracker.ro_optimize; identity always kept)
    "ro2": {"tracking.RO.screen_px": 96, "tracking.RO.screen_keep": 512},
    "ro2+zgo27+zba39": {"tracking.RO.screen_px": 96,
                        "tracking.RO.screen_keep": 512,
                        **ZGO27, **Z39},
    # adaptive RO search escalation (robustness, not speed): initial
    # reach scales with prev-loss/EWMA strain, capped at 4x / 8x
    "roesc4": {"tracking.RO.escalate": 4.0},
    "roesc8": {"tracking.RO.escalate": 8.0},
    "roesc4+zgo27+zba39": {"tracking.RO.escalate": 4.0, **ZGO27, **Z39},
    # anti-boiling-frog: stricter acceptance + escalated re-search
    "gate25": {"tracking.pose_gate.rel": 2.5},
    "gate25+roesc4": {"tracking.pose_gate.rel": 2.5,
                      "tracking.RO.escalate": 4.0},
    # quadratic GO anchor to the motion prediction (observability aid)
    "mp1": {"tracking.motion_prior_w": 1.0},
    "mp10": {"tracking.motion_prior_w": 10.0},
    # keyframe-poisoning guard: strained keyframes store inert rays
    "kfmask25": {"mapping.kf_strain_mask": 2.5},
    "kfmask25+roesc4": {"mapping.kf_strain_mask": 2.5,
                        "tracking.RO.escalate": 4.0},
    # frame-to-keyframe drift gate + ICP rescue (round-5 follow-up to
    # the seed-lottery diagnosis: the basin slide is invisible to every
    # EWMA-relative signal AND to the live map — tools/diag_absres.py —
    # but absolute against the last keyframe's immutable depth)
    "dgate30": {"tracking.drift_gate.thresh": 0.03},
    "dgate20": {"tracking.drift_gate.thresh": 0.02},
    "dgate50": {"tracking.drift_gate.thresh": 0.05},
    "dgate30+mp1": {"tracking.drift_gate.thresh": 0.03,
                    "tracking.motion_prior_w": 1.0},
    "dgate30+roesc4": {"tracking.drift_gate.thresh": 0.03,
                       "tracking.RO.escalate": 4.0},
}

N_WARM, N_BENCH, N_REPEAT = 16, 30, 3


def run_orbit(overrides):
    import jax
    from mipsfusion_tpu.config import apply_overrides, load_config
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU

    cfg = load_config("configs/synthetic/orbit.yaml")
    cfg["data"]["output"] = None
    cfg = apply_overrides(cfg, overrides)
    n_frames = N_WARM + N_REPEAT * N_BENCH + 1
    ds = SyntheticDataset(cfg, n_frames=n_frames, trajectory="orbit",
                          span=n_frames / 400.0)
    for i in range(n_frames):
        ds.packed(i)

    def frame(i):
        return {"frame_id": i, "c2w": ds.gt_pose(i)}

    warm = MIPSFusionTPU(cfg, dataset=ds)
    for i in range(n_frames):
        warm.process_frame(frame(i), i)
    jax.block_until_ready(warm.state.est_c2w)

    slam = MIPSFusionTPU(cfg, dataset=ds)
    slam.first_frame_mapping(frame(0), slam.mcfg.first_iters)
    for i in range(1, N_WARM + 1):
        slam.process_frame(frame(i), i)
    jax.block_until_ready(slam.state.est_c2w)

    fps_list, i0 = [], N_WARM + 1
    for _rep in range(N_REPEAT):
        t0 = time.perf_counter()
        for i in range(i0, i0 + N_BENCH):
            slam.process_frame(frame(i), i)
        jax.block_until_ready(slam.state.est_c2w)
        fps_list.append(N_BENCH / (time.perf_counter() - t0))
        i0 += N_BENCH
    ate = slam.evaluate(i0 - 1)["absolute_translational_error.rmse"]
    return sorted(fps_list)[1], ate


def run_stress(scene, overrides, mesh=False, seed=0):
    """One untimed full pass of a stress scene at full budgets + lever;
    returns (ate_m, n_switch_backs[, mesh_metrics]). ``seed`` re-draws
    the PST/sampling streams — stress-scene ATE is lottery-dominated
    (switch-back threshold crossings, RO basin escapes), so adoption
    decisions need the multi-seed spread, not one draw."""
    from mipsfusion_tpu.config import apply_overrides, load_config
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU

    cfg = load_config("configs/synthetic/outback.yaml")
    cfg["data"]["output"] = None
    cfg["seed"] = seed
    if scene == "sweep":
        cfg["synthetic"].update({"trajectory": "sweep", "n_frames": 120})
        # single room, no submap churn: isolate fast-motion tracking
        cfg["mapping"]["localMLP_max_len"] = [8.0, 8.0, 8.0]
    cfg = apply_overrides(cfg, overrides)
    n = cfg["synthetic"]["n_frames"]
    traj = cfg["synthetic"]["trajectory"]
    ds = SyntheticDataset(cfg, n_frames=n, trajectory=traj, span=1.0)
    slam = MIPSFusionTPU(cfg, dataset=ds)
    backs = []
    orig = slam.active_submap_switch
    slam.active_submap_switch = (
        lambda f, i, k: (backs.append(i), orig(f, i, k))[1])
    for i in range(n):
        slam.process_frame({"frame_id": i, "c2w": ds.gt_pose(i)}, i)
    ate = slam.evaluate(n - 1)["absolute_translational_error.rmse"]
    if not mesh:
        return float(ate), len(backs)
    from mipsfusion_tpu.eval.recon import evaluate_synthetic_mesh
    verts, _, _ = slam.extract_mesh()
    mm = evaluate_synthetic_mesh(slam, n_gt_samples=20000, verts=verts)
    return float(ate), len(backs), mm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None,
                    help="run one variant (default: all)")
    ap.add_argument("--stress", action="store_true",
                    help="also run outback+sweep validation")
    ap.add_argument("--stress-only", action="store_true",
                    help="skip the orbit speed/ATE part")
    ap.add_argument("--scenes", default="outback,sweep",
                    help="comma subset of stress scenes")
    ap.add_argument("--seeds", type=int, default=1,
                    help="stress-scene seeds (PST/sampling re-draws); "
                         "stress ATE is lottery-dominated, use >= 3 for "
                         "adoption decisions")
    args = ap.parse_args()

    names = [args.variant] if args.variant else list(VARIANTS)
    out = {}
    for name in names:
        ov = VARIANTS[name]
        row = {}
        if not args.stress_only:
            # device-time is the speed instrument (pipelined loops,
            # one sync per timed loop); one wall-clock orbit run
            # supplies the ATE
            from bench import stage_device_times
            dev = stage_device_times("configs/synthetic/orbit.yaml",
                                     reps=20, overrides=ov)
            fps, ate = run_orbit(ov)
            row = {"device_fps": dev["device_fps"],
                   "stage_ms": {k: dev[k] for k in
                                ("ro_ms", "go_ms", "ba_ms",
                                 "steady_frame_ms")},
                   "orbit_wall_fps": round(fps, 2),
                   "orbit_ate_mm": round(ate * 1e3, 2)}
        if args.stress:
            scenes = args.scenes.split(",")
            obs, sws, backs = [], [], []
            mm = None
            for s in range(args.seeds):
                if "outback" in scenes:
                    a_ob, nb, mm = run_stress("outback", ov, mesh=True,
                                              seed=s)
                    obs.append(round(a_ob * 1e3, 1))
                    backs.append(nb)
                if "sweep" in scenes:
                    a_sw, _ = run_stress("sweep", ov, seed=s)
                    sws.append(round(a_sw * 1e3, 1))
                print(f"  seed {s}: outback {obs[-1] if obs else '-'} mm "
                      f"({backs[-1] if backs else '-'} backs), "
                      f"sweep {sws[-1] if sws else '-'} mm", flush=True)
            med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
            if obs:
                row.update({"outback_ate_mm": med(obs),
                            "outback_ate_mm_seeds": obs,
                            "outback_backs": med(backs),
                            "outback_mesh_acc_mm": round(
                                mm["mesh_accuracy_m"] * 1e3, 1),
                            "outback_mesh_comp@5cm": round(
                                mm["mesh_completion@5cm"], 3)})
            if sws:
                row.update({"sweep_ate_mm": med(sws),
                            "sweep_ate_mm_seeds": sws})
        out[name] = row
        print(name, json.dumps(row), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
