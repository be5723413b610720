"""CLI entry: python main.py --config <yaml> (ref /root/reference/main.py:10-20)."""

import argparse
import os
import random

import numpy as np

from mipsfusion_tpu.compile_cache import enable_compile_cache
from mipsfusion_tpu.config import load_config


def main():
    parser = argparse.ArgumentParser(
        description="Multi-implicit-submap neural RGB-D SLAM")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config yaml file")
    parser.add_argument("--n_frames", type=int, default=None,
                        help="Optionally cap the number of frames")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint dir to resume from")
    parser.add_argument("--profile", type=str, default=None,
                        help="Write a jax profiler trace to this dir")
    args = parser.parse_args()
    enable_compile_cache()

    cfg = load_config(args.config)
    out = cfg.get("data", {}).get("output")
    if out:
        os.makedirs(os.path.join(out, cfg["data"].get("exp_name", "exp")),
                    exist_ok=True)

    random.seed(cfg.get("seed", 0))
    np.random.seed(cfg.get("seed", 0))

    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    slam = MIPSFusionTPU(cfg)
    start = 0
    if args.resume:
        start = slam.resume_from(args.resume)
        print(f"resumed from {args.resume} at frame {start}")
    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            results = slam.run(n_frames=args.n_frames, start=start)
    else:
        results = slam.run(n_frames=args.n_frames, start=start)
    print("ATE RMSE: %.4f m | %.2f FPS" % (
        results["absolute_translational_error.rmse"], results["fps"]))


if __name__ == "__main__":
    main()
