import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mipsfusion_tpu.ops.encoding import (FrequencyConfig, HashGridConfig,
                                         frequency_encode, hash_encode,
                                         init_hash_table)
from mipsfusion_tpu.models.decoder import (DecoderConfig, decoder_apply,
                                           init_decoder_params)
from mipsfusion_tpu.models.scene_rep import (FieldConfig, FieldConsts,
                                             forward_losses, init_field_params,
                                             render_rays, run_network,
                                             sdf2weights, LossWeights,
                                             total_loss)
from mipsfusion_tpu.ops.losses import get_masks, get_sdf_loss


SMALL_GRID = HashGridConfig(n_levels=4, log2_hashmap_size=10,
                            base_resolution=4, desired_resolution=32)


def small_field_cfg():
    grid = SMALL_GRID
    freq = FrequencyConfig(n_frequencies=4)
    dec = DecoderConfig(input_ch=grid.out_dim, input_ch_pos=freq.out_dim + 3,
                        n_hidden=32, n_hidden_rgb=16, n_hidden_sdf=16,
                        n_hidden_branch=32)
    return FieldConfig(grid=grid, freq=freq, decoder=dec,
                       n_range_d=5, n_samples_d=6)


def test_hash_grid_level_resolutions():
    cfg = HashGridConfig()  # defaults: 16 levels, base 16, desired 256
    res = cfg.level_resolutions()
    assert res[0] == 16
    assert res[-1] == 256
    assert np.all(np.diff(res) >= 0)
    assert cfg.out_dim == 32


def test_hash_encode_shapes_and_interpolation():
    cfg = SMALL_GRID
    key = jax.random.PRNGKey(0)
    table = init_hash_table(key, cfg)
    x = jax.random.uniform(jax.random.PRNGKey(1), (17, 3))
    out = hash_encode(table, x, cfg)
    assert out.shape == (17, cfg.out_dim)
    # continuity: tiny perturbation changes output only slightly
    out2 = hash_encode(table, x + 1e-6, cfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out2), atol=1e-6)


def test_hash_encode_grad_flows_to_table():
    cfg = SMALL_GRID
    table = init_hash_table(jax.random.PRNGKey(0), cfg)
    x = jax.random.uniform(jax.random.PRNGKey(1), (5, 3))

    def loss(t):
        return jnp.sum(hash_encode(t, x, cfg) ** 2)

    g = jax.grad(loss)(table)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).sum() > 0


def test_hash_encode_out_of_range_is_finite():
    cfg = SMALL_GRID
    table = init_hash_table(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray([[-0.5, 1.7, 0.3], [10.0, -3.0, 0.0]])
    out = hash_encode(table, x, cfg)
    assert np.isfinite(np.asarray(out)).all()


def test_frequency_encode():
    cfg = FrequencyConfig(n_frequencies=3)
    x = jnp.asarray([[0.25, 0.5, 1.0]])
    out = frequency_encode(x, cfg)
    assert out.shape == (1, 18)
    # dim 0, freq 0: sin(pi*0.25), cos(pi*0.25)
    np.testing.assert_allclose(float(out[0, 0]), np.sin(np.pi * 0.25), atol=1e-6)
    np.testing.assert_allclose(float(out[0, 1]), np.cos(np.pi * 0.25), atol=1e-6)


def test_decoder_output_structure():
    cfg = DecoderConfig(input_ch=8, input_ch_pos=27, n_hidden=32,
                        n_hidden_rgb=16, n_hidden_sdf=16, n_hidden_branch=32)
    params = init_decoder_params(jax.random.PRNGKey(0), cfg)
    embed = jax.random.normal(jax.random.PRNGKey(1), (11, 8))
    pe = jax.random.normal(jax.random.PRNGKey(2), (11, 24))
    pts = jax.random.normal(jax.random.PRNGKey(3), (11, 3))
    out = np.asarray(decoder_apply(params, embed, pe, pts, cfg))
    assert out.shape == (11, 10)
    prob = out[:, 5:]
    np.testing.assert_allclose(prob.sum(-1), 1.0, atol=1e-5)   # softmax
    sdf = out[:, 3]
    assert (sdf >= -1.0 - 1e-5).all() and (sdf <= 1.0 + 1e-5).all()
    # sdf consistent with prob expectation
    expect = (prob @ np.arange(5) / 4.0 - 0.5) * 2.0
    np.testing.assert_allclose(sdf, expect, atol=1e-5)
    # entropy nonnegative, <= log2(5)
    assert (out[:, 4] >= -1e-4).all() and (out[:, 4] <= np.log2(5) + 1e-3).all()


def test_get_masks_weights():
    z = jnp.asarray([[0.5, 1.0, 1.5, 2.0, 2.5]])
    td = jnp.asarray([[1.5]])
    front, sdfm, fsw, sdfw = get_masks(z, td, truncation=0.3)
    np.testing.assert_array_equal(np.asarray(front[0]), [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(np.asarray(sdfm[0]), [0, 0, 1, 0, 0])
    assert float(fsw) == pytest.approx(1 - 2 / 3)
    assert float(sdfw) == pytest.approx(1 - 1 / 3)


def test_sdf2weights_first_crossing():
    cfg = small_field_cfg()
    # sdf crosses zero between sample 2 and 3; later crossing must be masked
    sdf = jnp.asarray([[0.8, 0.4, 0.1, -0.2, -0.5, 0.3, 0.6]])
    z = jnp.asarray([[0.5, 0.8, 1.1, 1.4, 1.7, 2.0, 2.3]])
    w = np.asarray(sdf2weights(sdf, z, cfg))
    assert w.sum() == pytest.approx(1.0, abs=1e-4)
    # samples past z_first_crossing + trunc (1.1 + 0.1) get zero weight,
    # in particular the spurious second crossing at z=2.0
    assert w[0, -1] == 0.0 and w[0, -2] == 0.0 and w[0, 3] == 0.0
    assert w[0, 2] > 0


def test_render_and_losses_end_to_end():
    cfg = small_field_cfg()
    params = init_field_params(jax.random.PRNGKey(0), cfg)
    bound = jnp.asarray([[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]])
    consts = FieldConsts.from_bound(bound)

    n = 16
    rays_o = jnp.zeros((n, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    rays_d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    target_d = jnp.full((n, 1), 1.2)
    target_rgb = jnp.full((n, 3), 0.5)

    ret = forward_losses(params, jax.random.PRNGKey(2), rays_o, rays_d,
                         target_rgb, target_d, cfg, consts, emd_w=0.01)
    for k in ["rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr"]:
        assert np.isfinite(float(ret[k])), k
    assert ret["rgb"].shape == (n, 3)
    loss = total_loss(ret, LossWeights())
    assert np.isfinite(float(loss))

    # gradient flows into both hash table and decoder
    def f(p):
        r = forward_losses(p, jax.random.PRNGKey(2), rays_o, rays_d,
                           target_rgb, target_d, cfg, consts, emd_w=0.01)
        return total_loss(r, LossWeights())

    g = jax.grad(f)(params)
    assert np.abs(np.asarray(g["hash"])).sum() > 0
    assert np.abs(np.asarray(g["decoder"]["trunk0"]["w"])).sum() > 0


def test_training_reduces_loss():
    """A few Adam steps on a fixed ray batch must reduce the loss."""
    import optax

    cfg = small_field_cfg()
    params = init_field_params(jax.random.PRNGKey(0), cfg)
    consts = FieldConsts.from_bound(
        jnp.asarray([[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]]))

    n = 64
    key = jax.random.PRNGKey(1)
    d = jax.random.normal(key, (n, 3))
    rays_d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = jnp.zeros((n, 3))
    target_d = jnp.full((n, 1), 1.0)
    target_rgb = jnp.clip(rays_d * 0.5 + 0.5, 0, 1)
    w = LossWeights()

    opt = optax.adam(1e-2, b1=0.9, b2=0.99)
    state = opt.init(params)

    @jax.jit
    def step(params, state, key):
        def f(p):
            r = forward_losses(p, key, rays_o, rays_d, target_rgb, target_d,
                               cfg, consts)
            return total_loss(r, w)
        loss, grads = jax.value_and_grad(f)(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for i in range(30):
        params, state, loss = step(params, state, jax.random.PRNGKey(i))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


# ---------------------------------------------------------------------------
# Triplane encoding
# ---------------------------------------------------------------------------

def test_triplane_matches_direct_bilinear():
    import jax, jax.numpy as jnp
    from mipsfusion_tpu.ops.encoding import (TriplaneConfig, init_triplane,
                                             triplane_encode)
    cfg = TriplaneConfig(resolutions=(8, 16), n_features=3)
    planes = init_triplane(jax.random.PRNGKey(0), cfg)
    # overwrite with structured values for a readable check
    planes = {k: jax.random.normal(jax.random.PRNGKey(i), v.shape)
              for i, (k, v) in enumerate(planes.items())}
    rng = np.random.default_rng(0)
    x = rng.uniform(0.02, 0.98, (50, 3)).astype(np.float32)

    out = np.asarray(triplane_encode(planes, jnp.asarray(x), cfg))

    def bilerp(plane, u, v):
        R = plane.shape[0]
        pu, pv = u * (R - 1), v * (R - 1)
        i0, j0 = int(np.floor(pu)), int(np.floor(pv))
        wu, wv = pu - i0, pv - j0
        p = np.asarray(plane)
        return ((1 - wu) * (1 - wv) * p[i0, j0]
                + wu * (1 - wv) * p[i0 + 1, j0]
                + (1 - wu) * wv * p[i0, j0 + 1]
                + wu * wv * p[i0 + 1, j0 + 1])

    for n in range(0, 50, 7):
        expected = []
        for i, R in enumerate(cfg.resolutions):
            p = np.asarray(planes[f"s{i}"])
            f = (bilerp(p[0], x[n, 0], x[n, 1])
                 + bilerp(p[1], x[n, 0], x[n, 2])
                 + bilerp(p[2], x[n, 1], x[n, 2]))
            expected.append(f)
        np.testing.assert_allclose(out[n], np.concatenate(expected),
                                   atol=1e-4)


def test_triplane_chunking_consistent():
    import jax, jax.numpy as jnp
    from mipsfusion_tpu.ops.encoding import (TriplaneConfig, init_triplane,
                                             triplane_encode)
    cfg = TriplaneConfig(resolutions=(16,), n_features=2)
    planes = {k: jax.random.normal(jax.random.PRNGKey(1), v.shape)
              for k, v in init_triplane(jax.random.PRNGKey(0), cfg).items()}
    x = jax.random.uniform(jax.random.PRNGKey(2), (100, 3))
    full = triplane_encode(planes, x, cfg)
    # each point's encoding is independent of the batch it comes in
    parts = [triplane_encode(planes, x[s:s + 32], cfg)
             for s in range(0, 100, 32)]
    np.testing.assert_allclose(np.asarray(full),
                               np.concatenate([np.asarray(q) for q in parts]),
                               atol=1e-5)


def test_triplane_gradient_is_interp_weights():
    import jax, jax.numpy as jnp
    from mipsfusion_tpu.ops.encoding import (TriplaneConfig, init_triplane,
                                             triplane_encode)
    cfg = TriplaneConfig(resolutions=(8,), n_features=1)
    planes = init_triplane(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray([[0.5, 0.5, 0.5]])

    g = jax.grad(lambda p: triplane_encode(p, x, cfg).sum())(planes)
    gp = np.asarray(g["s0"])
    # gradient mass per plane must equal 1 (bilinear weights sum to 1)
    np.testing.assert_allclose(gp.reshape(3, -1).sum(-1), np.ones(3),
                               atol=1e-5)
    # and be concentrated on <= 4 cells per plane
    assert (np.abs(gp[0]) > 1e-8).sum() <= 4


def test_merge_sorted_z_equals_sort():
    """The closed-form two-sorted-merge must reproduce jnp.sort exactly,
    including exact-tie cases (invalid-depth fallback rows where both
    sequences share endpoints / coincident interior values)."""
    from mipsfusion_tpu.models.scene_rep import _merge_sorted_z

    rng = np.random.default_rng(0)
    n, n1, n2 = 64, 21, 54
    near, far = 0.0, 5.0
    d = rng.uniform(0.3, 4.5, (n, 1)).astype(np.float32)
    a = (np.linspace(-0.25, 0.25, n1, dtype=np.float32)[None] + d)
    # rows with exact collisions: fallback linspace identical ranges
    a[:8] = np.linspace(near, far, n1, dtype=np.float32)
    b = np.broadcast_to(np.linspace(near, far, n2, dtype=np.float32),
                        (n, n2)).copy()
    # a divisible-grid case with many exact interior ties
    a[8] = np.linspace(near, far, n1, dtype=np.float32)
    merged = np.asarray(_merge_sorted_z(jnp.asarray(a), jnp.asarray(b)))
    ref = np.sort(np.concatenate([a, b], axis=-1), axis=-1)
    np.testing.assert_array_equal(merged, ref)

    # degenerate n1=1 window
    a1 = d.astype(np.float32)
    merged1 = np.asarray(_merge_sorted_z(jnp.asarray(a1), jnp.asarray(b)))
    ref1 = np.sort(np.concatenate([a1, b], axis=-1), axis=-1)
    np.testing.assert_array_equal(merged1, ref1)


def _np_interp(u, R):
    pu = np.clip(u * (R - 1), 0.0, R - 1 - 1e-6)
    i0 = np.floor(pu).astype(int)
    return i0, np.minimum(i0 + 1, R - 1), pu - i0


def test_triplane_cp_lines_match_numpy():
    """The CP term is the product over axes of a linear interpolation
    of each factor line."""
    import jax, jax.numpy as jnp
    from mipsfusion_tpu.ops.encoding import (TriplaneConfig, init_triplane,
                                             triplane_encode)
    cfg = TriplaneConfig(resolutions=(8,), n_features=2, cp_resolution=20,
                         cp_components=5)
    planes = {k: jax.random.normal(jax.random.PRNGKey(i), v.shape)
              for i, (k, v) in enumerate(init_triplane(
                  jax.random.PRNGKey(0), cfg).items())}
    x = np.random.default_rng(1).uniform(-0.1, 1.1, (40, 3)).astype(
        np.float32)
    out = np.asarray(triplane_encode(planes, jnp.asarray(x), cfg))
    cp = np.asarray(planes["cp"])
    expected = np.ones((40, 5))
    for d in range(3):
        i0, i1, w = _np_interp(x[:, d], 20)
        expected *= cp[d][i0] * (1 - w)[:, None] + cp[d][i1] * w[:, None]
    np.testing.assert_allclose(out[:, 2:], expected, rtol=1e-5, atol=1e-5)


def test_triplane_point_gradient_matches_numpy():
    """d(encoding)/dx of one plane is the bilinear weights' derivative:
    (p[i1, j] - p[i0, j]) * (R - 1) blended along the other axis."""
    import jax, jax.numpy as jnp
    from mipsfusion_tpu.ops.encoding import (TriplaneConfig, init_triplane,
                                             triplane_encode)
    cfg = TriplaneConfig(resolutions=(6,), n_features=1)
    planes = {"s0": jax.random.normal(jax.random.PRNGKey(3),
                                      init_triplane(jax.random.PRNGKey(0),
                                                    cfg)["s0"].shape)}
    x = np.asarray([[0.31, 0.57, 0.83]], np.float32)
    g = np.asarray(jax.grad(lambda xx: triplane_encode(
        planes, xx, cfg).sum())(jnp.asarray(x)))[0]
    p = np.asarray(planes["s0"])[..., 0]
    R = 6

    def dplane(plane, u, v):          # (d/du, d/dv) of bilinear(plane)
        i0, i1, wu = _np_interp(np.asarray([u]), R)
        j0, j1, wv = _np_interp(np.asarray([v]), R)
        i0, i1, j0, j1, wu, wv = (a[0] for a in (i0, i1, j0, j1, wu, wv))
        du = ((plane[i1, j0] - plane[i0, j0]) * (1 - wv)
              + (plane[i1, j1] - plane[i0, j1]) * wv) * (R - 1)
        dv = ((plane[i0, j1] - plane[i0, j0]) * (1 - wu)
              + (plane[i1, j1] - plane[i1, j0]) * wu) * (R - 1)
        return du, dv

    xy, xz, yz = (dplane(p[0], x[0, 0], x[0, 1]),
                  dplane(p[1], x[0, 0], x[0, 2]),
                  dplane(p[2], x[0, 1], x[0, 2]))
    expected = [xy[0] + xz[0], xy[1] + yz[0], xz[1] + yz[1]]
    np.testing.assert_allclose(g, expected, rtol=1e-4, atol=1e-5)
