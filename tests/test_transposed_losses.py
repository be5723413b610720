"""Parity of the transposed (points-minor) training pipeline.

The _T path (scene_rep.render_rays_T / forward_losses_T,
ops/losses.get_sdf_loss_T) must produce the same loss values and
gradients as the row-major reference path (forward_losses) — it is a
layout change, not a math change.
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np

from mipsfusion_tpu.models import scene_rep as sr


def _field():
    fcfg = sr.FieldConfig(
        enc="Triplane",
        tri=dataclasses.replace(sr.FieldConfig().tri,
                                resolutions=(16, 32), n_features=4,
                                cp_resolution=64, cp_components=24),
        freq=dataclasses.replace(sr.FieldConfig().freq, n_frequencies=8),
    )
    fcfg = dataclasses.replace(
        fcfg, decoder=dataclasses.replace(
            fcfg.decoder, input_ch=fcfg.tri.out_dim,
            input_ch_pos=fcfg.freq.out_dim + 3))
    params = sr.init_field_params(jax.random.PRNGKey(0), fcfg)
    params["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                        for k, v in params["planes"].items()}
    return fcfg, params


def _rays(n=37):
    key = jax.random.PRNGKey(3)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    rays_o = jax.random.uniform(k1, (n, 3), minval=0.3, maxval=0.5)
    rays_d = jax.random.normal(k2, (n, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    rgb = jax.random.uniform(k3, (n, 3))
    d = jax.random.uniform(k4, (n, 1), minval=0.3, maxval=1.5)
    # a couple of invalid-depth rays exercise the missing-depth masks
    d = d.at[1].set(0.0).at[5].set(9.0)
    return rays_o, rays_d, rgb, d


LOSS_KEYS = ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr")


def test_forward_losses_T_value_parity():
    fcfg, params = _field()
    consts = sr.FieldConsts(jnp.zeros(3), jnp.ones(3) * 0.8)
    rays_o, rays_d, rgb, d = _rays()
    key = jax.random.PRNGKey(7)

    ref = sr.forward_losses(params, key, rays_o, rays_d, rgb, d,
                            fcfg, consts, emd_w=0.01)
    out = sr.forward_losses_T(params, key, rays_o.T, rays_d.T, rgb.T, d,
                              fcfg, consts, emd_w=0.01)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(out["rgbT"]),
                               np.asarray(ref["rgb"]).T, rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(out["depth"]),
                               np.asarray(ref["depth"]), rtol=2e-5,
                               atol=2e-6)


def test_forward_losses_T_grad_parity():
    """Gradients wrt params AND the pose-side inputs (rays) must match —
    the BA/GO optimizers consume both."""
    fcfg, params = _field()
    consts = sr.FieldConsts(jnp.zeros(3), jnp.ones(3) * 0.8)
    rays_o, rays_d, rgb, d = _rays()
    key = jax.random.PRNGKey(7)
    lw = sr.LossWeights(rgb=5.0, depth=0.1, sdf=1000.0, fs=10.0)

    def loss_ref(p, ro, rd):
        ret = sr.forward_losses(p, key, ro, rd, rgb, d, fcfg, consts,
                                emd_w=0.01)
        return sr.total_loss(ret, lw)

    def loss_T(p, ro, rd):
        ret = sr.forward_losses_T(p, key, ro.T, rd.T, rgb.T, d, fcfg,
                                  consts, emd_w=0.01)
        return sr.total_loss(ret, lw)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(params, rays_o, rays_d)
    g_T = jax.grad(loss_T, argnums=(0, 1, 2))(params, rays_o, rays_d)

    flat_ref, _ = jax.flatten_util.ravel_pytree(g_ref)
    flat_T, _ = jax.flatten_util.ravel_pytree(g_T)
    scale = np.maximum(np.abs(np.asarray(flat_ref)).max(), 1e-3)
    np.testing.assert_allclose(np.asarray(flat_T) / scale,
                               np.asarray(flat_ref) / scale,
                               rtol=3e-4, atol=3e-5)

