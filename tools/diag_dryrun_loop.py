"""Reproduce the multichip dryrun's whole-system outback phase on ONE
device for fast iteration.

The 8-device CPU dryrun takes ~30 min/attempt on this 1-core host; the
switch-back logic it asserts is device-count-independent (sharding only
constrains ray-batch layouts), so a single-device run of the SAME
config reproduces the manager/trajectory behavior in ~2 min.

    python tools/diag_dryrun_loop.py [--seed N] [--overrides k=v,...]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overrides", default="")
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args()

    import numpy as np

    from __graft_entry__ import _loop_system_cfg
    from mipsfusion_tpu.config import apply_overrides
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU

    cfg = _loop_system_cfg(8)
    cfg["parallel"] = {"sharded_refine": False, "dp_hot_path": False}
    cfg["sync_per_frame"] = False
    cfg["seed"] = args.seed
    cfg["debug_loop"] = args.debug
    ov = {}
    for kv in args.overrides.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
            ov[k] = v
    if ov:
        cfg = apply_overrides(cfg, ov)

    n = cfg["synthetic"]["n_frames"]
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="outback", span=1.0)
    slam = MIPSFusionTPU(cfg, dataset=ds)
    events = {"new": [], "back": []}
    orig_new = slam.active_submap_switch_new
    orig_back = slam.active_submap_switch
    slam.active_submap_switch_new = (
        lambda f, i, k: (events["new"].append(i), orig_new(f, i, k))[1])
    slam.active_submap_switch = (
        lambda f, i, k: (events["back"].append(i), orig_back(f, i, k))[1])
    for i in range(n):
        slam.process_frame({"frame_id": i, "c2w": ds.gt_pose(i)}, i)
    ate = slam.evaluate(n - 1)["absolute_translational_error.rmse"]
    kf_bind = slam._host_kf_bind[:slam._host_n_kf]
    print(f"seed {args.seed}: submaps={slam._host_used} "
          f"new@{events['new']} back@{events['back']} "
          f"ATE {float(ate)*1e3:.1f} mm")
    print("kf bindings:", kf_bind.tolist())


if __name__ == "__main__":
    main()
