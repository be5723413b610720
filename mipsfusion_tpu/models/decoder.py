"""SDF/RGB decoder MLP with a 5-class SDF classification head.

Behavioral parity with the reference decoder
(/root/reference/model/decoder.py:6-75):

  * shared trunk: Linear(PE+3 -> 128) -> ReLU -> Linear(-> 64+64),
    split into sdf/rgb embeddings;
  * RGB branch: Linear(64 + PE+3 -> 3) (sigmoid applied by the renderer);
  * SDF branch: Linear(64 + hash_feat -> 128) -> ReLU -> Linear(-> 5)
    -> softmax. SDF value = (sum_i p_i * i / (n_class-1) - 0.5) * 2 in
    [-1, 1]; the class-distribution entropy is also emitted (used as an
    inter-submap blending weight at meshing time).
  * output = concat[rgb(3), sdf(1), entropy(1), prob(n_class)].

Implemented as a pure-functional pytree of params so submaps can be
stacked along a leading axis and the whole field is one jit/grad region.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    input_ch: int = 32          # hash-grid feature dim (L * F)
    input_ch_pos: int = 51      # frequency PE dim + 3 (raw xyz included)
    n_hidden: int = 128
    n_hidden_rgb: int = 64
    n_hidden_sdf: int = 64
    n_hidden_branch: int = 128
    n_class: int = 5
    # bf16 matmul operands with f32 accumulation; set per platform by
    # scene_rep.for_platform, not from the config
    bf16: bool = False


def _linear_init(key, fan_in: int, fan_out: int, dtype=jnp.float32):
    """PyTorch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(fan_in)
    w = jax.random.uniform(kw, (fan_in, fan_out), minval=-bound, maxval=bound,
                           dtype=dtype)
    b = jax.random.uniform(kb, (fan_out,), minval=-bound, maxval=bound,
                           dtype=dtype)
    return {"w": w, "b": b}


def init_decoder_params(key: jax.Array, cfg: DecoderConfig,
                        dtype=jnp.float32) -> Dict:
    k = jax.random.split(key, 5)
    d_pe = cfg.input_ch_pos
    return {
        "trunk0": _linear_init(k[0], d_pe, cfg.n_hidden, dtype),
        "trunk1": _linear_init(k[1], cfg.n_hidden,
                               cfg.n_hidden_sdf + cfg.n_hidden_rgb, dtype),
        "rgb": _linear_init(k[2], cfg.n_hidden_rgb + d_pe, 3, dtype),
        "sdf0": _linear_init(k[3], cfg.n_hidden_sdf + cfg.input_ch,
                             cfg.n_hidden_branch, dtype),
        "sdf1": _linear_init(k[4], cfg.n_hidden_branch, cfg.n_class, dtype),
    }


def _dense(p, x, bf16=False):
    if bf16:
        return jnp.matmul(x.astype(jnp.bfloat16),
                          p["w"].astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32) + p["b"]
    return x @ p["w"] + p["b"]


def decoder_apply(params: Dict, embed: jnp.ndarray, embed_pos: jnp.ndarray,
                  query_pts: jnp.ndarray, cfg: DecoderConfig) -> jnp.ndarray:
    """Forward: hash feats [N,Ch], PE [N,Cp], raw pts [N,3] -> [N, 5+n_class]."""
    pe = jnp.concatenate([query_pts, embed_pos], axis=-1)
    bf = cfg.bf16

    h = jax.nn.relu(_dense(params["trunk0"], pe, bf))
    h = _dense(params["trunk1"], h, bf)
    sdf_emb = h[:, : cfg.n_hidden_sdf]
    rgb_emb = h[:, cfg.n_hidden_sdf:]

    rgb = _dense(params["rgb"], jnp.concatenate([rgb_emb, pe], axis=-1), bf)

    h2 = jax.nn.relu(_dense(params["sdf0"],
                            jnp.concatenate([sdf_emb, embed], axis=-1), bf))
    logits = _dense(params["sdf1"], h2, bf)
    prob = jax.nn.softmax(logits, axis=-1)

    entropy = -jnp.sum(prob * jnp.log2(prob + 1e-5), axis=-1, keepdims=True)

    class_ids = jnp.arange(cfg.n_class, dtype=prob.dtype)
    sdf = jnp.sum(prob * class_ids[None, :], axis=-1, keepdims=True)
    sdf = (sdf / (cfg.n_class - 1) - 0.5) * 2.0

    return jnp.concatenate([rgb, sdf, entropy, prob], axis=-1)
