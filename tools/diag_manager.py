"""Diagnose: where does the per-keyframe manager stage cost go?

Times, on a live multi-submap state (outback_fast, after the full run):
  (a) the speculative fused predicates+verify+ICP program (what every
      keyframe currently pays),
  (b) the predicates-only program (what round 3 paid, plus a separate
      verify dispatch only on switch keyframes),
each as dispatch-only and dispatch+readback (device_get), warm.
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np
from mipsfusion_tpu.config import load_config
from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from mipsfusion_tpu.slam import manager as manager_mod

cfg = load_config("configs/synthetic/outback_fast.yaml")
cfg["data"]["output"] = None
n = cfg["synthetic"]["n_frames"]
ds = SyntheticDataset(cfg, n_frames=n, trajectory="outback", span=1.0)
for i in range(n):
    ds.packed(i)

slam = MIPSFusionTPU(cfg, dataset=ds)
for i in range(n):
    slam.process_frame({"frame_id": i, "c2w": ds.gt_pose(i)}, i)
jax.block_until_ready(slam.state.est_c2w)

mgr = slam.manager
st = slam.state
i = n - 1
frame = ds[i]
depth = jnp.asarray(frame["depth"])
rays_d = jnp.asarray(frame["direction"])
pose_local = st.est_c2w[i]


def timeit(label, fn, reps=20):
    fn()  # warm/compile
    jax.block_until_ready(slam.state.est_c2w)
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    dt_dispatch = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        r = jax.device_get(fn())
    dt_sync = (time.perf_counter() - t0) / reps * 1e3
    print(f"{label:42s} dispatch {dt_dispatch:7.2f} ms   "
          f"+readback {dt_sync:7.2f} ms", flush=True)
    return r


timeit("speculative fused (predicates+verify+ICP)",
       lambda: mgr.predicates_fn(st, depth, rays_d, pose_local, -1, i))

timeit("predicates only",
       lambda: manager_mod._predicates_fused(
           st, pose_local, depth, rays_d, jnp.asarray(0),
           jnp.asarray(mgr.cfg.min_cr_localMLP_len, jnp.float32),
           mgr.cfg.near, mgr.cfg.far, mgr.cr_rows, mgr.cr_cols))

# a bare no-op readback for the dispatch + sync floor
x = jnp.zeros((4,))
timeit("dispatch + sync floor (tiny add)", lambda: x + 1.0)
