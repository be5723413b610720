"""Per-stage device-time profiler for the SLAM hot path.

Times each jitted stage (RO, GO, full tracking, local BA) as a
PIPELINED loop — dispatch N times with varying inputs, block once at the
end — so the per-sync host cost is amortized out. Run on the target
backend:

    python tools/profile_stages.py --config configs/synthetic/orbit.yaml
    python tools/profile_stages.py --cpu            # force CPU
    python tools/profile_stages.py --wait_iters 3   # GO early-stop probe

Reference cost centers being attributed: tracking_render
(/root/reference/mipsfusion.py:470-563), local_BA (:259-370).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/synthetic/orbit.yaml")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--wait_iters", type=int, default=None,
                    help="override tracking.wait_iters for the GO probe")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses
    import jax.numpy as jnp

    from mipsfusion_tpu.config import load_config
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    from mipsfusion_tpu.slam import tracker

    cfg = load_config(args.config)
    cfg["data"]["output"] = None
    n_warm = 17
    ds = SyntheticDataset(cfg, n_frames=n_warm + 4, trajectory="orbit",
                          span=(n_warm + 4) / 400.0)
    for i in range(n_warm + 4):
        ds.packed(i)
    slam = MIPSFusionTPU(cfg, dataset=ds)

    def frame(i):
        return {"frame_id": i, "c2w": ds.gt_pose(i)}

    print(f"backend={jax.default_backend()} devices={len(jax.devices())}")
    slam.first_frame_mapping(frame(0), slam.mcfg.first_iters)
    for i in range(1, n_warm):
        slam.process_frame(frame(i), i)
    jax.block_until_ready(slam.state.est_c2w)

    st = slam.state
    packed = ds.packed(n_warm)
    params = slam.submap_params[slam.active_id]
    reps = args.reps

    def timeit(name, fn):
        # warm (compile) then pipelined loop with varying frame idx
        out = fn(0)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for r in range(reps):
            out = fn(r)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:<44s} {ms:8.2f} ms")
        return ms

    rcfg, gcfg, fcfg, consts, lw = (slam.rcfg, slam.gcfg, slam.fcfg,
                                    slam.consts, slam.lw)

    def track_var(n_ro, n_go, gc=gcfg):
        def fn(r):
            return tracker.track_frame(
                params, fcfg, consts, rcfg, gc, slam.pst,
                jax.random.PRNGKey(r), packed[..., 3:6], packed[..., 6],
                packed[..., :3], st.est_c2w, jnp.asarray(n_warm - 1 + 0 * r),
                jnp.asarray(True), lw, n_ro, n_go)
        return fn

    t_ro = timeit(f"RO only ({rcfg.n_iters} iters x "
                  f"{rcfg.particle_size} particles)",
                  track_var(rcfg.n_iters, 0))
    t_go = timeit(f"GO only ({gcfg.n_iters} iters x {gcfg.n_rays} rays, "
                  f"wait={gcfg.wait_iters})", track_var(0, gcfg.n_iters))
    if args.wait_iters is not None:
        gc2 = dataclasses.replace(gcfg, wait_iters=args.wait_iters)
        timeit(f"GO only (wait_iters={args.wait_iters})",
               track_var(0, gcfg.n_iters, gc2))
    t_track = timeit("track_frame (RO + GO)",
                     track_var(rcfg.n_iters, gcfg.n_iters))

    # local BA at the mapping cadence (the shared fused step program)
    from mipsfusion_tpu.slam.system import _get_ba_step
    step = _get_ba_step(
        slam.fcfg, slam.mcfg, slam.lw,
        slam._round_rays(slam.mcfg.sample + slam.mcfg.pixels_cur),
        slam._ray_sharding)
    cur_rays = packed.reshape(-1, 7)

    def ba_fn(r):
        st2, p2, o2 = step(st, params, slam.map_opt_state, cur_rays,
                           n_warm - 1, slam.consts, slam._ba_key,
                           slam._kf_frames_dev)
        return p2

    t_ba = timeit(f"local BA ({slam.mcfg.iters} iters x "
                  f"{slam.mcfg.sample}+{slam.mcfg.pixels_cur} rays)", ba_fn)

    amort = t_track + t_ba / slam.map_every
    print("-" * 56)
    print(f"{'steady frame (track + BA/' + str(slam.map_every) + ')':<44s}"
          f" {amort:8.2f} ms  -> {1e3 / amort:.1f} FPS upper bound")


if __name__ == "__main__":
    main()
