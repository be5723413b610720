"""Multiresolution hash-grid + frequency positional encodings (pure JAX).

This replaces the reference's tiny-cuda-nn CUDA encodings
(/root/reference/model/encodings.py:6-52):

  * The hash table is a single HBM-resident array of shape [L, T, F]
    (uniform per-level capacity so submaps can be stacked/vmapped along a
    leading axis). Levels whose dense grid fits in T index densely;
    larger levels use the classic spatial XOR-prime hash.
  * Lookup = gather + trilinear interpolation, expressed in jnp so XLA
    fuses the interpolation weights into the surrounding computation and
    autodiff yields the scatter-add backward into the table for free.

Level scaling matches tiny-cuda-nn's growth rule:
  scale_l = base_res * exp2(l * log2(per_level_scale)) - 1
  res_l   = ceil(scale_l) + 1
  pos     = x * scale_l + 0.5
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# XOR-prime spatial hash constants (Teschner et al., as used by instant-ngp)
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    desired_resolution: int = 256

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self) -> float:
        return float(
            np.exp2(
                np.log2(self.desired_resolution / self.base_resolution)
                / (self.n_levels - 1)
            )
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        l = np.arange(self.n_levels)
        return self.base_resolution * np.exp2(l * np.log2(self.per_level_scale)) - 1.0

    def level_resolutions(self) -> np.ndarray:
        return np.ceil(self.level_scales()).astype(np.int64) + 1


def init_hash_table(key: jax.Array, cfg: HashGridConfig,
                    dtype=jnp.float32) -> jnp.ndarray:
    """Uniform(-1e-4, 1e-4) init, matching tcnn's hash-grid default."""
    return jax.random.uniform(
        key, (cfg.n_levels, cfg.table_size, cfg.n_features),
        minval=-1e-4, maxval=1e-4, dtype=dtype)


# 8 corner offsets of a unit cube, shape [8, 3]
_CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    axis=-1).reshape(8, 3)


@partial(jax.jit, static_argnames=("cfg",))
def hash_encode(table: jnp.ndarray, x: jnp.ndarray,
                cfg: HashGridConfig) -> jnp.ndarray:
    """Encode points ``x`` [N, 3] (nominally in [0,1]) -> [N, L*F].

    ``table`` is [L, T, F]. Differentiable w.r.t. ``table`` (autodiff
    produces segment-sum scatter-add into the table).
    """
    N = x.shape[0]
    L, T, F = table.shape
    scales = jnp.asarray(cfg.level_scales(), dtype=x.dtype)          # [L]
    resolutions = jnp.asarray(cfg.level_resolutions(), jnp.int32)    # [L]
    dense_ok = jnp.asarray(
        cfg.level_resolutions().astype(np.int64) ** 3 <= cfg.table_size)  # [L] bool

    corners = jnp.asarray(_CORNERS, jnp.int32)                        # [8, 3]

    pos = x[:, None, :] * scales[None, :, None] + 0.5                 # [N, L, 3]
    grid0 = jnp.floor(pos)
    frac = pos - grid0                                                # [N, L, 3]
    grid0 = grid0.astype(jnp.int32)

    # corner integer coords: [N, L, 8, 3]
    cidx = grid0[:, :, None, :] + corners[None, None, :, :]
    res = resolutions[None, :, None, None]
    cidx_cl = jnp.clip(cidx, 0, res - 1)

    # dense index: x + y*res + z*res^2 (tcnn stride layout)
    dense_idx = (cidx_cl[..., 0]
                 + cidx_cl[..., 1] * resolutions[None, :, None]
                 + cidx_cl[..., 2] * resolutions[None, :, None] ** 2)
    # spatial hash (uint32 wraparound semantics)
    cu = cidx.astype(jnp.uint32)
    hashed = (cu[..., 0] * jnp.uint32(_PRIMES[0])
              ^ cu[..., 1] * jnp.uint32(_PRIMES[1])
              ^ cu[..., 2] * jnp.uint32(_PRIMES[2]))
    hash_idx = (hashed & jnp.uint32(T - 1)).astype(jnp.int32)

    idx = jnp.where(dense_ok[None, :, None], dense_idx % T, hash_idx)  # [N, L, 8]

    # gather: flatten table to [L*T, F]; offset indices per level
    flat = table.reshape(L * T, F)
    level_offsets = (jnp.arange(L, dtype=jnp.int32) * T)[None, :, None]
    feats = jnp.take(flat, (idx + level_offsets).reshape(-1), axis=0,
                     indices_are_sorted=False, unique_indices=False)
    feats = feats.reshape(N, L, 8, F)

    # trilinear weights: corners order matches _CORNERS meshgrid (x, y, z)
    w = jnp.where(corners[None, None, :, :] == 1, frac[:, :, None, :],
                  1.0 - frac[:, :, None, :])                           # [N, L, 8, 3]
    w = jnp.prod(w, axis=-1)                                           # [N, L, 8]

    out = jnp.sum(feats * w[..., None], axis=2)                        # [N, L, F]
    return out.reshape(N, L * F)


@dataclasses.dataclass(frozen=True)
class FrequencyConfig:
    n_frequencies: int = 8
    input_dim: int = 3

    @property
    def out_dim(self) -> int:
        return self.input_dim * self.n_frequencies * 2


def frequency_encode(x: jnp.ndarray, cfg: FrequencyConfig) -> jnp.ndarray:
    """NeRF-style positional encoding: [sin(2^j pi x), cos(2^j pi x)].

    Output layout groups by input dim then frequency (tcnn Frequency
    layout): [N, D * n_freq * 2].
    """
    freqs = jnp.asarray(2.0 ** np.arange(cfg.n_frequencies), x.dtype) * jnp.pi
    ang = x[..., :, None] * freqs[None, :]                 # [N, D, J]
    enc = jnp.stack([jnp.sin(ang), jnp.cos(ang)], axis=-1)  # [N, D, J, 2]
    return enc.reshape(x.shape[:-1] + (cfg.out_dim,))


# ---------------------------------------------------------------------------
# Triplane (TensoRF-style) multiscale encoding
# ---------------------------------------------------------------------------
#
# Each scale factorizes into three axis-aligned feature planes, sampled
# by bilinear interpolation (a gather of 4 taps per plane; its gradient
# is a scatter-add of 4 rows), plus optional CP line factors. Replaces
# tiny-cuda-nn's role (/root/reference/model/encodings.py:13-25).

@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    resolutions: Tuple[int, ...] = (32, 64, 128, 256)
    n_features: int = 4          # features per plane per scale
    # optional CP (rank-decomposed line) component: three 1D factor
    # lines of length cp_resolution with cp_components channels whose
    # per-point elementwise product is appended to the features; it
    # adds fine detail along each axis for a table of 3*R*C values.
    cp_resolution: int = 0       # 0 disables the CP term
    cp_components: int = 32

    @property
    def out_dim(self) -> int:
        # concat over scales; the 3 planes of a scale are summed
        # (TensoRF-VM style), keeping out_dim compact
        base = len(self.resolutions) * self.n_features
        return base + (self.cp_components if self.cp_resolution else 0)


def init_triplane(key: jax.Array, cfg: TriplaneConfig,
                  dtype=jnp.float32) -> dict:
    """Planes dict {"s<i>": [3, R, R, F]} (+ "cp": [3, Rcp, C]) with
    U(-1e-4, 1e-4) plane init (same scale as the hash table it
    replaces). CP lines init near 1/sqrt-scaled so the three-way
    product starts small but carries gradient."""
    keys = jax.random.split(key, len(cfg.resolutions) + 1)
    params = {
        f"s{i}": jax.random.uniform(
            keys[i], (3, R, R, cfg.n_features),
            minval=-1e-4, maxval=1e-4, dtype=dtype)
        for i, R in enumerate(cfg.resolutions)
    }
    if cfg.cp_resolution:
        # product of three ~0.05-scale factors ~ 1e-4, matching planes
        params["cp"] = 0.05 * jax.random.normal(
            keys[-1], (3, cfg.cp_resolution, cfg.cp_components),
            dtype=dtype)
    return params


def _interp_taps(u: jnp.ndarray, R: int):
    """Linear-interpolation taps of coords u in [0,1] on an R-sample
    axis: (lower index, upper index, upper weight)."""
    pu = jnp.clip(u * (R - 1), 0.0, R - 1 - 1e-6)
    i0f = jnp.floor(pu)
    i0 = i0f.astype(jnp.int32)
    return i0, jnp.minimum(i0 + 1, R - 1), pu - i0f


def _plane_lookup(plane: jnp.ndarray, u: jnp.ndarray,
                  v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interp on one plane [R, R, F] at N (u, v) -> [N, F]."""
    R, _, F = plane.shape
    flat = plane.reshape(R * R, F)
    u0, u1, wu = _interp_taps(u, R)
    v0, v1, wv = _interp_taps(v, R)
    out = 0.0
    for iu, iv, w in ((u0, v0, (1 - wu) * (1 - wv)), (u1, v0, wu * (1 - wv)),
                      (u0, v1, (1 - wu) * wv), (u1, v1, wu * wv)):
        out = out + flat[iu * R + iv] * w[:, None]
    return out


def _line_lookup(line: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Linear interp on a 1D factor line [R, C] at N coords -> [N, C]."""
    i0, i1, w = _interp_taps(u, line.shape[0])
    return line[i0] * (1 - w)[:, None] + line[i1] * w[:, None]


def triplane_encode(planes: dict, x: jnp.ndarray,
                    cfg: TriplaneConfig) -> jnp.ndarray:
    """Encode points x [N, 3] in [0,1]^3 -> [N, out_dim] (the 3 planes of
    a scale summed, scales and the CP product concatenated)."""
    feats = []
    for i, R in enumerate(cfg.resolutions):
        p = planes[f"s{i}"]                          # [3, R, R, F]
        f_xy = _plane_lookup(p[0], x[:, 0], x[:, 1])
        f_xz = _plane_lookup(p[1], x[:, 0], x[:, 2])
        f_yz = _plane_lookup(p[2], x[:, 1], x[:, 2])
        feats.append(f_xy + f_xz + f_yz)
    if cfg.cp_resolution:
        cp = planes["cp"]                            # [3, Rcp, C]
        fx = _line_lookup(cp[0], x[:, 0])
        fy = _line_lookup(cp[1], x[:, 1])
        fz = _line_lookup(cp[2], x[:, 2])
        feats.append(fx * fy * fz)
    return jnp.concatenate(feats, axis=-1)
