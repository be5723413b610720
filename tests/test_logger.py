"""Logger outputs: full-image render and comparison grid."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mipsfusion_tpu.models import scene_rep as sr
from mipsfusion_tpu.models.decoder import DecoderConfig
from mipsfusion_tpu.ops.encoding import FrequencyConfig, TriplaneConfig
from mipsfusion_tpu.slam import logger

pytestmark = pytest.mark.slow


def small_field():
    tri = TriplaneConfig(resolutions=(8, 16), n_features=2)
    freq = FrequencyConfig(n_frequencies=2)
    fcfg = sr.FieldConfig(
        enc="Triplane", tri=tri, freq=freq,
        decoder=DecoderConfig(input_ch=tri.out_dim,
                              input_ch_pos=freq.out_dim + 3),
        n_range_d=7, n_samples_d=8, far=5.0)
    consts = sr.FieldConsts.from_bound(
        jnp.asarray([[-3.0, 3.0], [-3.0, 3.0], [-3.0, 3.0]]))
    params = sr.init_field_params(jax.random.PRNGKey(0), fcfg)
    return params, fcfg, consts


def test_render_full_img_shapes():
    params, fcfg, consts = small_field()
    H, W = 12, 16
    dirs = np.zeros((H, W, 3), np.float32)
    dirs[..., 2] = -1.0
    depth = np.full((H, W), 2.0, np.float32)
    rgb, d = logger.render_full_img(params, fcfg, consts, jnp.eye(4),
                                    jnp.asarray(dirs), jnp.asarray(depth),
                                    jax.random.PRNGKey(0), chunk=64)
    assert rgb.shape == (H, W, 3) and d.shape == (H, W)
    assert np.isfinite(rgb).all() and np.isfinite(d).all()


def test_img_render_save_and_plot(tmp_path):
    params, fcfg, consts = small_field()
    H, W = 12, 16
    dirs = np.zeros((H, W, 3), np.float32)
    dirs[..., 2] = -1.0
    depth = np.full((H, W), 2.0, np.float32)
    rgb_gt = np.full((H, W, 3), 0.5, np.float32)

    psnr, depth_l1 = logger.img_render_save(
        params, fcfg, consts, jnp.eye(4), rgb_gt, depth, dirs,
        str(tmp_path), 3)
    assert os.path.exists(tmp_path / "render_00003.png")
    assert np.isfinite(psnr) and np.isfinite(depth_l1)

    with open(tmp_path / "render_00003.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
