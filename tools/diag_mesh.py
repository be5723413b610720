"""Diagnose mesh quality on the outback multi-submap scene.

Runs the SLAM once and checkpoints it (output/mesh_diag/), then mesh
experiments restore via system.resume_from — so meshing changes iterate
in seconds instead of re-running the 200-frame sequence.

    python tools/diag_mesh.py [--rerun] [--config ...] [--voxel 0.03]
                              [--no-occupancy] [--single]
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
    ap.add_argument("--config", default="configs/synthetic/outback_fast.yaml")
    ap.add_argument("--rerun", action="store_true",
                    help="re-run the SLAM sequence even if a ckpt exists")
    ap.add_argument("--voxel", type=float, default=None)
    ap.add_argument("--cvox", type=float, default=None,
                    help="occupancy voxel size override")
    ap.add_argument("--dilate", type=int, default=None)
    ap.add_argument("--no-occupancy", action="store_true",
                    help="disable the surface-occupancy validity mask")
    args = ap.parse_args()

    import json

    import numpy as np

    from mipsfusion_tpu.config import load_config
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU

    cfg = load_config(args.config)
    out_dir = os.path.join("output", "mesh_diag")
    cfg["data"]["output"] = None
    n = cfg["synthetic"]["n_frames"]
    ds = SyntheticDataset(cfg, n_frames=n,
                          trajectory=cfg["synthetic"]["trajectory"],
                          span=1.0)

    ckpt_dir = os.path.join(out_dir, "ckpt_final")
    slam = MIPSFusionTPU(cfg, dataset=ds)
    if args.rerun or not os.path.exists(
            os.path.join(ckpt_dir, "ckpt.npz")):
        print("running SLAM sequence ...")
        t0 = time.time()
        for i in range(n):
            slam.process_frame(
                {"frame_id": i, "c2w": ds.gt_pose(i)}, i)
        print(f"  run: {time.time() - t0:.1f}s, "
              f"submaps={slam._host_used}")
        slam.output_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        slam.save_checkpoint("final")
        ate = slam.evaluate(n - 1)["absolute_translational_error.rmse"]
        print(f"  ATE: {ate * 1000:.2f} mm")
    else:
        slam.resume_from(ckpt_dir)
        print(f"restored ckpt: submaps={slam._host_used} "
              f"n_kf={slam._host_n_kf}")

    if args.voxel:
        cfg.setdefault("mesh", {})["voxel_final"] = args.voxel
    if args.cvox:
        cfg["mesh"]["occupancy_voxel"] = args.cvox
    if args.dilate is not None:
        cfg["mesh"]["occupancy_dilate"] = args.dilate

    if args.no_occupancy:
        cfg.setdefault("mesh", {})["use_occupancy"] = False

    t0 = time.time()
    verts, faces, colors = slam.extract_mesh()
    mesh_s = time.time() - t0

    from mipsfusion_tpu.eval.recon import evaluate_synthetic_mesh
    m = evaluate_synthetic_mesh(slam, n_gt_samples=20000, verts=verts)
    m["mesh_wall_s"] = round(mesh_s, 2)
    m["n_faces"] = int(len(faces))
    print(json.dumps(m, default=float))


if __name__ == "__main__":
    main()
