"""Per-submap neural field: encode -> decode -> volume render -> losses.

Counterpart of the reference JointEncoding
(/root/reference/model/scene_rep.py:11-238). The whole ray pipeline —
depth-guided z-sampling, coordinate normalization, hash+frequency
encoding, MLP decode, SDF-to-weight compositing, and the loss stack — is
a single pure function over a params pytree, so XLA compiles one fused
region and jax.grad provides the backward (including the scatter-add
into the hash table).

Key semantics preserved:
  * z-sampling: n_range_d samples in +-range_d around the GT depth
    (falling back to near..far linspace for invalid depth) merged with
    n_samples_d uniform samples, sorted, then stratified-perturbed
    (ref scene_rep.py:153-187).
  * sdf2weights: sigmoid(sdf/tr) * sigmoid(-sdf/tr), masked after the
    first sign crossing + sc_factor*trunc, renormalized (ref :58-78).
  * losses: rgb (with rgb_missing weighting), masked depth, free-space +
    truncation SDF losses with optional EMD classification terms
    (ref :190-238).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.encoding import (FrequencyConfig, HashGridConfig, TriplaneConfig,
                            frequency_encode, hash_encode, init_hash_table,
                            init_triplane, triplane_encode)
from ..ops.losses import compute_loss, get_sdf_loss, get_sdf_loss_T, mse2psnr
from .decoder import DecoderConfig, decoder_apply, init_decoder_params


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static (hashable) configuration of the per-submap field + renderer.

    ``enc`` selects the spatial encoding: "HashGrid" (reference-parity
    hash grid) or "Triplane" (multiscale planes + CP lines, see
    ops/encoding.py TriplaneConfig).
    """
    enc: str = "HashGrid"
    grid: HashGridConfig = HashGridConfig()
    tri: TriplaneConfig = TriplaneConfig()
    freq: FrequencyConfig = FrequencyConfig()
    decoder: DecoderConfig = DecoderConfig()
    # z sampling
    n_range_d: int = 25
    range_d: float = 0.2
    n_samples_d: int = 50
    near: float = 0.0
    far: float = 5.0
    perturb: bool = True
    # losses / SDF
    trunc: float = 0.1
    sc_factor: float = 1.0
    depth_trunc: float = 100.0
    rgb_missing: float = 0.0
    norm_factor: float = 1.0
    use_bound_normalize: bool = True
    # z-merge strategy: closed-form two-sorted-merge vs jnp.sort
    # (numerically identical; chosen per backend by measurement)
    z_merge: bool = True

    @property
    def n_samples_total(self) -> int:
        return self.n_range_d + self.n_samples_d

    @staticmethod
    def from_dict(cfg: dict) -> "FieldConfig":
        """Build from a reference-style nested config dict."""
        enc = cfg["grid"].get("enc", "HashGrid")
        grid = HashGridConfig(
            log2_hashmap_size=cfg["grid"]["hash_size"],
            desired_resolution=256,
        )
        tri = TriplaneConfig(
            resolutions=tuple(cfg["grid"].get(
                "tri_resolutions", (32, 64, 128, 256))),
            n_features=cfg["grid"].get("tri_features", 4),
            cp_resolution=cfg["grid"].get("cp_resolution", 0),
            cp_components=cfg["grid"].get("cp_components", 32),
        )
        freq = FrequencyConfig(n_frequencies=cfg["pos"]["n_bins"])
        dec = cfg.get("decoder", {})
        decoder = DecoderConfig(
            input_ch=tri.out_dim if enc == "Triplane" else grid.out_dim,
            input_ch_pos=freq.out_dim + 3,
            # ref model/decoder.py:10-16 knobs: hidden_dim sizes the
            # trunk and the SDF branch, hidden_dim_color the RGB branch,
            # geo_feat_dim the two trunk output embeddings
            n_hidden=dec.get("hidden_dim", 128),
            n_hidden_branch=dec.get("hidden_dim", 128),
            n_hidden_rgb=dec.get("hidden_dim_color", 64),
            n_hidden_sdf=dec.get("geo_feat_dim", 64),
        )
        t = cfg["training"]
        return FieldConfig(
            enc=enc,
            grid=grid, tri=tri, freq=freq, decoder=decoder,
            n_range_d=t["n_range_d"], range_d=t["range_d"],
            n_samples_d=t["n_samples_d"],
            near=cfg["cam"]["near"], far=cfg["cam"]["far"],
            perturb=bool(t["perturb"]),
            trunc=t["trunc"], sc_factor=cfg["data"]["sc_factor"],
            depth_trunc=cfg["cam"]["depth_trunc"],
            rgb_missing=t["rgb_missing"], norm_factor=t["norm_factor"],
            use_bound_normalize=bool(cfg["grid"]["use_bound_normalize"]),
        )


class FieldConsts(NamedTuple):
    """Dynamic (array) normalization constants of a submap's field.

    With use_bound_normalize, bb_lo/bb_inv_extent come from the scene
    bound; otherwise from the coords_norm_factor (localMLP_max_len), i.e.
    x_norm = (x + nf) / (2 nf) == (x - (-nf)) * (1 / (2 nf)).
    """
    bb_lo: jnp.ndarray          # [3]
    bb_inv_extent: jnp.ndarray  # [3]

    @staticmethod
    def from_bound(bound: jnp.ndarray) -> "FieldConsts":
        lo = bound[:, 0]
        return FieldConsts(lo, 1.0 / (bound[:, 1] - bound[:, 0]))

    @staticmethod
    def from_norm_factor(nf: jnp.ndarray) -> "FieldConsts":
        return FieldConsts(-nf, 1.0 / (2.0 * nf))


def init_field_params(key: jax.Array, cfg: FieldConfig) -> Dict:
    k1, k2 = jax.random.split(key)
    if cfg.enc == "Triplane":
        enc_params = {"planes": init_triplane(k1, cfg.tri)}
    else:
        enc_params = {"hash": init_hash_table(k1, cfg.grid)}
    return {**enc_params, "decoder": init_decoder_params(k2, cfg.decoder)}


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def query_color_sdf(params: Dict, pts_norm: jnp.ndarray,
                    cfg: FieldConfig) -> jnp.ndarray:
    """Decode pre-normalized points [N, 3] -> [N, 5 + n_class].

    ``pts_norm`` must already be normalized to the grid domain (the
    run_network normalization); the additional training.norm_factor
    division (ref scene_rep.py:118-128) is applied here.
    """
    x = pts_norm / cfg.norm_factor
    if cfg.enc == "Triplane":
        embed = triplane_encode(params["planes"], x, cfg.tri)
    else:
        embed = hash_encode(params["hash"], x, cfg.grid)
    embed_pos = frequency_encode(x, cfg.freq)
    return decoder_apply(params["decoder"], embed, embed_pos, x, cfg.decoder)


def normalize_coords(pts: jnp.ndarray, consts: FieldConsts) -> jnp.ndarray:
    return (pts - consts.bb_lo) * consts.bb_inv_extent


def run_network(params: Dict, pts: jnp.ndarray, cfg: FieldConfig,
                consts: FieldConsts) -> jnp.ndarray:
    """Query raw local-frame points [..., 3] -> [..., 5 + n_class]."""
    flat = pts.reshape(-1, 3)
    out = query_color_sdf(params, normalize_coords(flat, consts), cfg)
    return out.reshape(pts.shape[:-1] + (out.shape[-1],))


def query_sdf(params, pts, cfg, consts):
    return run_network(params, pts, cfg, consts)[..., 3:4]


def run_network_sdf_T(params: Dict, ptsT: jnp.ndarray, cfg: FieldConfig,
                      consts: FieldConsts) -> jnp.ndarray:
    """SDF of points in [3, N] layout -> [N] (RO fitness builds its
    candidate points in this layout)."""
    return run_network(params, ptsT.T, cfg, consts)[..., 3]


def for_platform(cfg: FieldConfig, platform: str) -> FieldConfig:
    """The field path each backend runs, decided in this one place.

    ``cpu``: the plain float32 path (the reference the tests hold).
    ``gpu``: decoder matmuls with bf16 operands and f32 accumulation,
    the fastest of bf16, default (TF32) and highest f32 precision on an
    H100 at no ATE cost (PERF.md). Any other platform has no path and
    raises.
    """
    if platform == "cpu":
        return cfg
    if platform == "gpu":
        return dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, bf16=True))
    raise ValueError(f"no field path for platform {platform!r}")


def query_color(params, pts, cfg, consts):
    return jax.nn.sigmoid(run_network(params, pts, cfg, consts)[..., :3])


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def first_surface_mask(sdf: jnp.ndarray, z_vals: jnp.ndarray,
                       cfg: FieldConfig) -> jnp.ndarray:
    """1.0 on the samples up to one truncation past each ray's first SDF
    sign change, else 0.0 ([N, S])."""
    signs = sdf[:, 1:] * sdf[:, :-1]
    mask = jnp.where(signs < 0.0, 1.0, 0.0)
    inds = jnp.argmax(mask, axis=1)[:, None]
    z_min = jnp.take_along_axis(z_vals, inds, axis=1)  # first surface
    return jnp.where(z_vals < z_min + cfg.sc_factor * cfg.trunc, 1.0, 0.0)


def sdf2weights(sdf: jnp.ndarray, z_vals: jnp.ndarray,
                cfg: FieldConfig) -> jnp.ndarray:
    """SDF -> normalized compositing weights with first-crossing masking."""
    weights = (jax.nn.sigmoid(sdf / cfg.trunc)
               * jax.nn.sigmoid(-sdf / cfg.trunc))
    weights = weights * first_surface_mask(sdf, z_vals, cfg)
    return weights / (jnp.sum(weights, axis=-1, keepdims=True) + 1e-8)


def raw2outputs(raw: jnp.ndarray, z_vals: jnp.ndarray, cfg: FieldConfig):
    rgb = jax.nn.sigmoid(raw[..., :3])
    weights = sdf2weights(raw[..., 3], z_vals, cfg)
    rgb_map = jnp.sum(weights[..., None] * rgb, axis=-2)
    depth_map = jnp.sum(weights * z_vals, axis=-1)
    depth_var = jnp.sum(weights * (z_vals - depth_map[..., None]) ** 2, axis=-1)
    disp_map = 1.0 / jnp.maximum(1e-10, depth_map / jnp.sum(weights, -1))
    acc_map = jnp.sum(weights, -1)
    return rgb_map, disp_map, acc_map, weights, depth_map, depth_var


def _merge_sorted_z(z_samples: jnp.ndarray,
                    z_uniform: jnp.ndarray) -> jnp.ndarray:
    """Merge two per-ray SORTED z sequences without a bitonic sort.

    Each element's merged rank is its own index plus the count of the
    other sequence below it; both counts come from ONE pairwise
    comparison tensor (per pair exactly one of ``a < b`` / ``b <= a``
    holds, so the ranks form a permutation by construction — no
    floating-point tie hazards). O(n1*n2) elementwise work replaces
    XLA's O(M log^2 M) cross-lane sorting network, which profiled at a
    large share of per-iteration BA/GO time at the reference's
    75-sample budget.
    """
    n, n1 = z_samples.shape
    n2 = z_uniform.shape[-1]
    # C[r, i, j] = (a_j < b_i)
    C = z_samples[:, None, :] < z_uniform[:, :, None]      # [N, n2, n1]
    cnt_for_b = jnp.sum(C, axis=2)                         # #{j: a_j < b_i}
    cnt_for_a = n2 - jnp.sum(C, axis=1)                    # #{i: b_i <= a_j}
    rank_a = jnp.arange(n1)[None, :] + cnt_for_a
    rank_b = jnp.arange(n2)[None, :] + cnt_for_b

    ranks = jnp.concatenate([rank_a, rank_b], axis=-1)     # [N, M] perm
    vals = jnp.concatenate([z_samples, z_uniform], axis=-1)
    # materialize the permutation as a one-hot contraction
    M = ranks.shape[-1]
    onehot = (ranks[..., None] == jnp.arange(M)[None, None, :])
    return jnp.einsum("nj,njk->nk", vals, onehot.astype(vals.dtype))


def sample_z_vals(key: jax.Array, target_d: jnp.ndarray,
                  cfg: FieldConfig) -> jnp.ndarray:
    """Depth-guided + uniform z sampling with stratified perturbation.

    target_d: [N, 1] -> z_vals [N, n_range_d + n_samples_d].
    """
    n = target_d.shape[0]
    z_near = jnp.linspace(-cfg.range_d, cfg.range_d, cfg.n_range_d)
    z_samples = z_near[None, :] + target_d                       # [N, n_range_d]
    z_fallback = jnp.linspace(cfg.near, cfg.far, cfg.n_range_d)
    valid = target_d > 0.0
    z_samples = jnp.where(valid, z_samples, z_fallback[None, :])

    if cfg.n_samples_d > 0:
        z_uniform = jnp.broadcast_to(
            jnp.linspace(cfg.near, cfg.far, cfg.n_samples_d),
            (n, cfg.n_samples_d))
        if cfg.z_merge:
            z_vals = _merge_sorted_z(z_samples, z_uniform)
        else:
            z_vals = jnp.sort(
                jnp.concatenate([z_uniform, z_samples], axis=-1), axis=-1)
    else:
        z_vals = z_samples

    if cfg.perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = jnp.concatenate([mids, z_vals[..., -1:]], axis=-1)
        lower = jnp.concatenate([z_vals[..., :1], mids], axis=-1)
        u = jax.random.uniform(key, z_vals.shape, dtype=z_vals.dtype)
        z_vals = lower + (upper - lower) * u
    return z_vals


def render_rays(params: Dict, key: jax.Array, rays_o: jnp.ndarray,
                rays_d: jnp.ndarray, target_d: jnp.ndarray,
                cfg: FieldConfig, consts: FieldConsts) -> Dict:
    z_vals = sample_z_vals(key, target_d, cfg)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = run_network(params, pts, cfg, consts)
    rgb_map, disp_map, acc_map, weights, depth_map, depth_var = raw2outputs(
        raw, z_vals, cfg)
    return {
        "rgb": rgb_map, "depth": depth_map, "disp_map": disp_map,
        "acc_map": acc_map, "depth_var": depth_var, "z_vals": z_vals,
        "raw": raw,
    }


# ---------------------------------------------------------------------------
# Training forward (losses)
# ---------------------------------------------------------------------------

def forward_losses(params: Dict, key: jax.Array, rays_o: jnp.ndarray,
                   rays_d: jnp.ndarray, target_rgb: jnp.ndarray,
                   target_d: jnp.ndarray, cfg: FieldConfig,
                   consts: FieldConsts, emd_w: float = 0.01) -> Dict:
    """Render a ray batch and compute the training loss dict."""
    rend = render_rays(params, key, rays_o, rays_d, target_d, cfg, consts)

    td = target_d[..., 0]
    valid = (td > 0.0) & (td < cfg.depth_trunc)
    rgb_weight = jnp.where(valid[..., None], 1.0, cfg.rgb_missing)

    rgb_loss = compute_loss(rend["rgb"] * rgb_weight, target_rgb * rgb_weight)
    psnr = mse2psnr(rgb_loss)

    # masked mean over valid-depth rays only (torch indexes then means)
    nvalid = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    depth_sq = (rend["depth"] - td) ** 2 * valid.astype(jnp.float32)
    depth_loss = jnp.sum(depth_sq) / nvalid

    z_vals = rend["z_vals"]
    sdf = rend["raw"][..., 3]
    sdf_prob = rend["raw"][..., 5:]
    truncation = cfg.trunc * cfg.sc_factor
    fs_loss, sdf_loss = get_sdf_loss(
        z_vals, target_d, sdf, sdf_prob, truncation,
        cate_num=cfg.decoder.n_class, emd_w=emd_w)

    return {
        "rgb": rend["rgb"], "depth": rend["depth"],
        "rgb_loss": rgb_loss, "depth_loss": depth_loss,
        "sdf_loss": sdf_loss, "fs_loss": fs_loss, "psnr": psnr,
    }


# ---------------------------------------------------------------------------
# Transposed (points-minor) training forward
# ---------------------------------------------------------------------------
#
# The same pipeline with the point axis minor end to end — rays [3, N],
# points [3, N*S], raw [10+, N, S]. Loss semantics are identical to
# forward_losses (same reductions, same masks; parity-tested in
# tests/test_transposed_losses.py).

def query_color_sdf_T(params: Dict, ptsT_norm: jnp.ndarray,
                      cfg: FieldConfig) -> jnp.ndarray:
    """Decode pre-normalized points [3, M] -> [5 + n_class, M]."""
    return query_color_sdf(params, ptsT_norm.T, cfg).T


def raw2outputs_T(rawT: jnp.ndarray, z_vals: jnp.ndarray,
                  cfg: FieldConfig):
    """raw2outputs on [C_out, N, S] raw (same math, channel-major)."""
    rgbT = jax.nn.sigmoid(rawT[:3])                       # [3, N, S]
    weights = sdf2weights(rawT[3], z_vals, cfg)           # [N, S]
    rgb_mapT = jnp.sum(weights[None] * rgbT, axis=-1)     # [3, N]
    depth_map = jnp.sum(weights * z_vals, axis=-1)
    depth_var = jnp.sum(weights * (z_vals - depth_map[..., None]) ** 2,
                        axis=-1)
    return rgb_mapT, weights, depth_map, depth_var


def render_rays_T(params: Dict, key: jax.Array, rays_oT: jnp.ndarray,
                  rays_dT: jnp.ndarray, target_d: jnp.ndarray,
                  cfg: FieldConfig, consts: FieldConsts) -> Dict:
    """render_rays with points-minor layout: rays_oT/rays_dT [3, N]."""
    z_vals = sample_z_vals(key, target_d, cfg)            # [N, S]
    ptsT = (rays_oT[:, :, None]
            + rays_dT[:, :, None] * z_vals[None, :, :])   # [3, N, S]
    n, s = z_vals.shape
    flatT = ptsT.reshape(3, n * s)
    xT = (flatT - consts.bb_lo[:, None]) * consts.bb_inv_extent[:, None]
    rawT = query_color_sdf_T(params, xT, cfg).reshape(-1, n, s)
    rgb_mapT, weights, depth_map, depth_var = raw2outputs_T(
        rawT, z_vals, cfg)
    return {
        "rgbT": rgb_mapT, "depth": depth_map, "depth_var": depth_var,
        "weights": weights, "z_vals": z_vals, "rawT": rawT,
    }


def forward_losses_T(params: Dict, key: jax.Array, rays_oT: jnp.ndarray,
                     rays_dT: jnp.ndarray, target_rgbT: jnp.ndarray,
                     target_d: jnp.ndarray, cfg: FieldConfig,
                     consts: FieldConsts, emd_w: float = 0.01) -> Dict:
    """forward_losses with [3, N] rays/targets (identical loss values)."""
    rend = render_rays_T(params, key, rays_oT, rays_dT, target_d, cfg,
                         consts)

    td = target_d[..., 0]
    valid = (td > 0.0) & (td < cfg.depth_trunc)
    rgb_weight = jnp.where(valid[None, :], 1.0, cfg.rgb_missing)

    rgb_loss = compute_loss(rend["rgbT"] * rgb_weight,
                            target_rgbT * rgb_weight)
    psnr = mse2psnr(rgb_loss)

    nvalid = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    depth_sq = (rend["depth"] - td) ** 2 * valid.astype(jnp.float32)
    depth_loss = jnp.sum(depth_sq) / nvalid

    z_vals = rend["z_vals"]
    sdf = rend["rawT"][3]
    sdf_probT = rend["rawT"][5:]
    truncation = cfg.trunc * cfg.sc_factor
    fs_loss, sdf_loss = get_sdf_loss_T(
        z_vals, target_d, sdf, sdf_probT, truncation,
        cate_num=cfg.decoder.n_class, emd_w=emd_w)

    return {
        "rgbT": rend["rgbT"], "depth": rend["depth"],
        "rgb_loss": rgb_loss, "depth_loss": depth_loss,
        "sdf_loss": sdf_loss, "fs_loss": fs_loss, "psnr": psnr,
    }


class LossWeights(NamedTuple):
    rgb: float = 1.0
    depth: float = 0.0
    sdf: float = 1000.0
    fs: float = 10.0

    @staticmethod
    def from_dict(cfg: dict) -> "LossWeights":
        t = cfg["training"]
        return LossWeights(rgb=t["rgb_weight"], depth=t["depth_weight"],
                           sdf=t["sdf_weight"], fs=t["fs_weight"])


def total_loss(ret: Dict, w: LossWeights) -> jnp.ndarray:
    """Scalar objective from the loss dict (ref mipsfusion.py:142-152)."""
    return (w.rgb * ret["rgb_loss"] + w.depth * ret["depth_loss"]
            + w.sdf * ret["sdf_loss"] + w.fs * ret["fs_loss"])
