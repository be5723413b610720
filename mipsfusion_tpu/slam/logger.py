"""Logger: full-image re-rendering and GT-vs-render comparison grids.

Parity with the reference Logger's observability outputs
(/root/reference/Logger.py:193-262 render_full_img / img_render_save):
volumetric re-render of a full frame through the active field and a 2x2
GT-vs-render comparison PNG, written with numpy and zlib. Trajectories
are saved as TUM text (eval/ate.py); ``tools/eval_ate.py`` plots them.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene_rep as sr


def render_full_img(params: Dict, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, c2w_local: jnp.ndarray,
                    rays_dir_img: jnp.ndarray, depth_img: jnp.ndarray,
                    key: jax.Array, chunk: int = 16384):
    """Re-render a full frame (rgb, depth) through the field
    (ref Logger.render_full_img :193-214)."""
    H, W, _ = rays_dir_img.shape
    dirs = rays_dir_img.reshape(-1, 3)
    rays_d = dirs @ c2w_local[:3, :3].T
    rays_o = jnp.broadcast_to(c2w_local[:3, 3], rays_d.shape)
    target_d = depth_img.reshape(-1, 1)

    rgbs, depths = [], []
    for s in range(0, rays_d.shape[0], chunk):
        ret = sr.render_rays(params, key, rays_o[s:s + chunk],
                             rays_d[s:s + chunk], target_d[s:s + chunk],
                             fcfg, consts)
        rgbs.append(np.asarray(ret["rgb"]))
        depths.append(np.asarray(ret["depth"]))
    rgb = np.concatenate(rgbs).reshape(H, W, 3)
    depth = np.concatenate(depths).reshape(H, W)
    return rgb, depth


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] image with values in [0, 1] as an 8-bit RGB PNG."""
    rgb = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                         axis=1).tobytes()        # filter type 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def img_render_save(params: Dict, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, c2w_local: jnp.ndarray,
                    rgb_gt: np.ndarray, depth_gt: np.ndarray,
                    rays_dir_img: jnp.ndarray, out_dir: str,
                    frame_id: int, key: Optional[jax.Array] = None):
    """2x2 comparison grid, GT rgb | GT depth over rendered rgb |
    rendered depth, depth in grey scaled to the GT maximum
    (ref Logger.img_render_save :221-262). Returns (psnr, depth_l1)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    rgb, depth = render_full_img(params, fcfg, consts, c2w_local,
                                 jnp.asarray(rays_dir_img),
                                 jnp.asarray(depth_gt), key)
    mse = float(np.mean((rgb - rgb_gt) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    valid = depth_gt > 0
    depth_l1 = float(np.abs(depth - depth_gt)[valid].mean()) \
        if valid.any() else 0.0

    vmax = max(float(depth_gt.max()), 1e-3)
    grey = lambda d: np.repeat((d / vmax)[..., None], 3, axis=-1)  # noqa
    grid = np.concatenate([
        np.concatenate([rgb_gt, grey(depth_gt)], axis=1),
        np.concatenate([rgb, grey(depth)], axis=1)], axis=0)
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"render_{frame_id:05d}.png"), grid)
    return psnr, depth_l1
