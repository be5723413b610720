"""Offline mesh extraction CLI from a saved checkpoint.

Parity with /root/reference/vis/render_mesh.py:42-94:
``python vis/render_mesh.py --config <yaml> --seq_result <out_dir>
  --ckpt <frame|final>`` reloads the per-submap field params + state
tensors and extracts per-submap meshes plus the joint
entropy/distance-fused mesh.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--seq_result", type=str, required=True,
                        help="output dir of the SLAM run")
    parser.add_argument("--ckpt", type=str, default="final")
    parser.add_argument("--voxel_size", type=float, default=None)
    parser.add_argument("--no_joint", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend (e.g. while the GPU "
                             "is busy)")
    args = parser.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from mipsfusion_tpu.config import load_config
    from mipsfusion_tpu.mesher import Mesher, MeshConfig
    from mipsfusion_tpu.mesher.mesher import save_mesh_ply
    from mipsfusion_tpu.models import scene_rep as sr
    from mipsfusion_tpu.slam.checkpoint import load_ckpt
    import jax
    import jax.numpy as jnp

    cfg = load_config(args.config)
    ckpt_dir = os.path.join(args.seq_result, f"ckpt_{args.ckpt}")
    state, submap_params, extra = load_ckpt(ckpt_dir)

    fcfg = sr.for_platform(sr.FieldConfig.from_dict(cfg),
                           jax.default_backend())
    m = cfg["mapping"]
    if fcfg.use_bound_normalize:
        consts = sr.FieldConsts.from_bound(jnp.asarray(m["bound"]))
    else:
        consts = sr.FieldConsts.from_norm_factor(
            jnp.asarray(m["localMLP_max_len"]))

    voxel = args.voxel_size or cfg.get("mesh", {}).get("voxel_final", 0.03)
    mesher = Mesher(fcfg, consts, MeshConfig(voxel_size=voxel))
    bound = np.asarray(m.get("marching_cubes_bound", m["bound"]))

    info = np.asarray(state.localMLP_info)
    used = int(info[:, 0].sum())
    first_kf = np.asarray(state.localMLP_first_kf)
    kf_c2w = np.asarray(state.kf_c2w)
    anchors = kf_c2w[first_kf[:used]]

    # keyframe world poses + per-kf max depth for the visibility filters
    # (ref Mesher.py:245-281,360-378)
    from mipsfusion_tpu.mesher.mesher import apply_visibility_filters
    n_kf = int(np.asarray(state.n_kf))
    kf_ref = np.asarray(state.keyframe_ref)[:n_kf]
    bind0 = np.asarray(state.keyframe_localMLP)[:n_kf, 0]
    kf_frames = np.asarray(state.kf_frame_ids)[:n_kf]
    est = np.asarray(state.est_c2w)
    kf_world = np.empty((n_kf, 4, 4), np.float32)
    for k in range(n_kf):
        if kf_ref[k] == -1:
            kf_world[k] = kf_c2w[k]
        else:
            anchor = kf_c2w[first_kf[max(bind0[k], 0)]]
            kf_world[k] = anchor @ est[kf_frames[k]]
    kf_max_d = np.asarray(state.kf_rays)[:n_kf, :, 6].max(axis=1)
    cam = cfg["cam"]
    ds_f = cfg["data"].get("downsample", 1)
    H, W = cam["H"] // ds_f, cam["W"] // ds_f
    K_mat = np.asarray([[cam["fx"] / ds_f, 0, cam["cx"] / ds_f],
                        [0, cam["fy"] / ds_f, cam["cy"] / ds_f],
                        [0, 0, 1.0]])
    min_area = cfg.get("mesh", {}).get(
        "remove_small_geometry_threshold", 0.5)

    def cleanup(verts, faces, colors):
        return apply_visibility_filters(
            verts, faces, colors, kf_world, K_mat, H, W, kf_max_d,
            min_component_area=min_area)

    # observed-surface occupancy validity (same scheme as
    # system.extract_mesh): global + per-submap keyframe surface points
    from mipsfusion_tpu.mesher.mesher import (kf_surface_points,
                                              surface_occupancy)
    kf_rays_np = np.asarray(state.kf_rays)[:n_kf]
    mesh_cfg = cfg.get("mesh", {})
    cvox = mesh_cfg.get("occupancy_voxel", 0.2)
    dil = mesh_cfg.get("occupancy_dilate", 1)
    bind = np.asarray(state.keyframe_localMLP)[:n_kf]
    surf_pts = kf_surface_points(kf_world, kf_rays_np)
    observed_fn = surface_occupancy(surf_pts, bound[:, 0], bound[:, 1],
                                    cvox=cvox, dilate=dil)
    inb = ((surf_pts > bound[:, 0]) & (surf_pts < bound[:, 1])).all(1)
    sp_in = surf_pts[inb]
    grid_bounds = (sp_in.min(axis=0) - 2 * cvox,
                   sp_in.max(axis=0) + 2 * cvox) if len(sp_in) else None
    submap_fns = []
    for i in range(used):
        sel = (bind[:, 0] == i) | (bind[:, 1] == i)
        if sel.any():
            submap_fns.append(surface_occupancy(
                kf_surface_points(kf_world[sel], kf_rays_np[sel]),
                bound[:, 0], bound[:, 1], cvox=cvox, dilate=dil))
        else:
            submap_fns.append(observed_fn)

    for i in range(used):
        if submap_params[i] is None:
            continue
        verts, faces, colors = mesher.extract_single_mesh(
            submap_params[i], anchors[i], info[i, 1:4], info[i, 4:7],
            trunc=0.99, bound_world=bound, observed_fn=submap_fns[i],
            grid_bounds=grid_bounds)
        verts, faces, colors = cleanup(verts, faces, colors)
        out = os.path.join(args.seq_result, f"mesh_{i}_{args.ckpt}.ply")
        save_mesh_ply(out, verts, faces, colors)
        print(f"submap {i}: {len(verts)} verts {len(faces)} faces -> {out}")

    if not args.no_joint and used > 1:
        params = [submap_params[i] for i in range(used)]
        verts, faces, colors = mesher.extract_mesh_jointly(
            params, anchors, info[:used, 1:4], info[:used, 4:7],
            trunc=0.99, bound_world=bound, observed_fn=observed_fn,
            submap_observed_fns=submap_fns, grid_bounds=grid_bounds)
        verts, faces, colors = cleanup(verts, faces, colors)
        out = os.path.join(args.seq_result, f"mesh_joint_{args.ckpt}.ply")
        save_mesh_ply(out, verts, faces, colors)
        print(f"joint: {len(verts)} verts {len(faces)} faces -> {out}")


if __name__ == "__main__":
    main()
