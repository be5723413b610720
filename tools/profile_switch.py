"""Profile: per-stage breakdown of switch-back frame cost.

Drives the outback multi-submap scene twice (warm, then timed with
per-stage sync) and prints mean/max/sum ms per stage. Companion to
bench.py's switch_frame_ms metric.
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax
import numpy as np
from mipsfusion_tpu.config import load_config
from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU

cfg = load_config("configs/synthetic/outback_fast.yaml")
cfg["data"]["output"] = None
n = cfg["synthetic"]["n_frames"]
ds = SyntheticDataset(cfg, n_frames=n, trajectory="outback", span=1.0)
for i in range(n):
    ds.packed(i)


def drive(timed):
    slam = MIPSFusionTPU(cfg, dataset=ds)
    tm = {}

    def wrap(name, fn, sync=True):
        def w(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            if sync:
                jax.block_until_ready(slam.state.est_c2w)
            tm.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return r
        return w

    if timed:
        for name in ["track", "do_local_ba", "inactive_refine_step",
                     "add_keyframe", "_drain_init_chunk",
                     "_flush_pending_init", "active_submap_switch",
                     "local_ba_switch", "global_ba",
                     "_find_overlapping_region", "_drain_switch_chain"]:
            setattr(slam, name, wrap(name, getattr(slam, name)))
        mgr = slam.manager
        mgr.process_keyframe = wrap("manager", mgr.process_keyframe)

    def frame(i):
        return {"frame_id": i, "c2w": ds.gt_pose(i)}

    for i in range(n):
        slam.process_frame(frame(i), i)
    jax.block_until_ready(slam.state.est_c2w)
    return tm


drive(False)   # warm all compile caches
tm = drive(True)
for k, v in tm.items():
    v = np.asarray(v)
    print(f"{k:28s} n={len(v):4d} mean={v.mean():8.2f} ms "
          f"max={v.max():8.2f} ms sum={v.sum():9.1f} ms")
