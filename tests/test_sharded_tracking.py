"""Ray/particle-DP on the TRACKING hot loops (VERDICT r3 item 7).

The per-frame hot loops — RO particle fitness over [3, P*n] points
(ref RandomOptimizer.py:113-131) and the GO render batch
(ref mipsfusion.py:490-556) — must be data-parallel over the mesh's
data axis with field params replicated, like local BA already is
(tests/test_sharded_ba.py). Structural HLO assertions + numeric parity
on the virtual 8-CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mipsfusion_tpu.models import scene_rep as sr
from mipsfusion_tpu.slam import tracker
from test_slam_single import tiny_config


def triplane_cfg(n_frames=8):
    """tiny_config on the configs' Triplane+CP encoding (the plain path
    the CPU platform runs). Tiny plane/line resolutions keep the
    virtual-mesh compiles fast."""
    cfg = tiny_config(n_frames)
    cfg["grid"] = {"enc": "Triplane", "tri_resolutions": [16, 32],
                   "tri_features": 4, "cp_resolution": 48,
                   "cp_components": 8, "hash_size": 13,
                   "tcnn_encoding": True, "use_bound_normalize": True}
    return cfg


def _setup(make_cfg=None):
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    cfg = (make_cfg or tiny_config)(8)
    fcfg = sr.FieldConfig.from_dict(cfg)
    consts = sr.FieldConsts.from_bound(
        jnp.asarray(cfg["mapping"]["bound"], jnp.float32))
    lw = sr.LossWeights.from_dict(cfg)
    rcfg = tracker.ROConfig.from_dict(cfg)
    gcfg = tracker.GOConfig.from_dict(cfg)
    key = jax.random.PRNGKey(0)
    params = sr.init_field_params(key, fcfg)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    sh = NamedSharding(mesh, P("data"))
    return cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh


def _frame(cfg, key):
    H, W = cfg["cam"]["H"], cfg["cam"]["W"]
    from mipsfusion_tpu.ops.geometry import get_camera_rays
    rays_d = get_camera_rays(H, W, cfg["cam"]["fx"], cfg["cam"]["fy"],
                             cfg["cam"]["cx"], cfg["cam"]["cy"])
    depth = 2.0 + 0.5 * jax.random.uniform(key, (H, W))
    rgb = jax.random.uniform(key, (H, W, 3))
    return rays_d, depth, rgb


def test_dp_tracking_lowering_is_sharded():
    """With the constraint, the compiled track_frame must carry sharded
    ops (all-reduce for the RO fitness means / GO pose grads); without
    it, none."""
    cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh = _setup()
    rays_d, depth, rgb = _frame(cfg, key)
    est = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))

    def lower(ray_sharding):
        return tracker.track_frame.lower(
            params, fcfg, consts, rcfg, gcfg,
            tracker.make_pst(key, rcfg), key, rgb, depth, rays_d, est,
            jnp.int32(1), jnp.asarray(True), lw, 2, 2,
            ray_sharding=ray_sharding).compile().as_text()

    hlo_dp = lower(sh)
    hlo_rep = lower(None)
    assert "all-reduce" in hlo_dp, \
        "DP tracking lowering lost the sharding constraint"
    assert "all-reduce" not in hlo_rep


def test_dp_tracking_matches_single_device():
    """The sharded tracker must return (numerically) the same pose."""
    cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh = _setup()
    rays_d, depth, rgb = _frame(cfg, key)
    est = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))
    # non-trivial previous pose for the motion model
    prev = jnp.eye(4).at[0, 3].set(0.01)
    est = est.at[0].set(prev)
    pst = tracker.make_pst(key, rcfg)

    res_dp = tracker.track_frame(
        params, fcfg, consts, rcfg, gcfg, pst, key, rgb, depth, rays_d,
        est, jnp.int32(1), jnp.asarray(False), lw, 3, 3, ray_sharding=sh)
    res_1 = tracker.track_frame(
        params, fcfg, consts, rcfg, gcfg, pst, key, rgb, depth, rays_d,
        est, jnp.int32(1), jnp.asarray(False), lw, 3, 3, ray_sharding=None)
    # identical math modulo reduction order: the poses must agree far
    # below tracking noise
    np.testing.assert_allclose(np.asarray(res_dp.pose),
                               np.asarray(res_1.pose), atol=1e-4)
    np.testing.assert_allclose(float(res_dp.loss), float(res_1.loss),
                               rtol=1e-3)


@pytest.mark.slow
def test_dp_tracking_live_system_parity():
    """Drive the live system with dp_hot_path on (now covering
    tracking, BA and init) vs off, and demand ATE parity."""
    from fixture_cache import cached_run
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam.system import MIPSFusionTPU

    results = {}
    for dp in (True, False):
        cfg = tiny_config(24)
        cfg["parallel"] = {"sharded_refine": False, "dp_hot_path": dp}

        def make_slam(cfg=cfg):
            ds = SyntheticDataset(cfg, n_frames=24, trajectory="orbit",
                                  span=24 / 200.0)
            return MIPSFusionTPU(cfg, dataset=ds)

        _, aux = cached_run(f"sharded_track_{int(dp)}", cfg, make_slam,
                            lambda s: {"results": s.run(verbose=False)},
                            extra_files=(__file__,))
        results[dp] = aux["results"]["absolute_translational_error.rmse"]
    print(f"ATE dp {results[True]*1000:.2f} mm, "
          f"single {results[False]*1000:.2f} mm")
    assert results[True] < 0.03 and results[False] < 0.03, results
    assert abs(results[True] - results[False]) < 0.01, results


# ---------------------------------------------------------------------------
# flagship Triplane+CP encoding through the multi-device proofs
# (VERDICT r4 item 3: every sharded proof previously ran HashGrid only)
# ---------------------------------------------------------------------------

def test_dp_tracking_triplane_lowering_is_sharded():
    """track_frame on the FLAGSHIP encoding must shard under the DP
    constraint (all-reduce present) and not without it."""
    cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh = _setup(triplane_cfg)
    assert fcfg.enc == "Triplane"
    rays_d, depth, rgb = _frame(cfg, key)
    est = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))

    def lower(ray_sharding):
        return tracker.track_frame.lower(
            params, fcfg, consts, rcfg, gcfg,
            tracker.make_pst(key, rcfg), key, rgb, depth, rays_d, est,
            jnp.int32(1), jnp.asarray(True), lw, 2, 2,
            ray_sharding=ray_sharding).compile().as_text()

    assert "all-reduce" in lower(sh)
    assert "all-reduce" not in lower(None)


def test_dp_tracking_triplane_matches_single_device():
    """Sharded tracking on Triplane returns the same pose as one device."""
    cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh = _setup(triplane_cfg)
    rays_d, depth, rgb = _frame(cfg, key)
    est = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))
    est = est.at[0].set(jnp.eye(4).at[0, 3].set(0.01))
    pst = tracker.make_pst(key, rcfg)

    res_dp = tracker.track_frame(
        params, fcfg, consts, rcfg, gcfg, pst, key, rgb, depth, rays_d,
        est, jnp.int32(1), jnp.asarray(False), lw, 3, 3, ray_sharding=sh)
    res_1 = tracker.track_frame(
        params, fcfg, consts, rcfg, gcfg, pst, key, rgb, depth, rays_d,
        est, jnp.int32(1), jnp.asarray(False), lw, 3, 3, ray_sharding=None)
    np.testing.assert_allclose(np.asarray(res_dp.pose),
                               np.asarray(res_1.pose), atol=1e-4)
    np.testing.assert_allclose(float(res_dp.loss), float(res_1.loss),
                               rtol=1e-3)


def test_dp_ba_triplane_plane_grad_parity():
    """One DP local-BA step on Triplane must produce the SAME updated
    plane/CP-line params as the unsharded step (the gradient all-reduce
    over the data axis must be numerically transparent)."""
    from mipsfusion_tpu.slam import mapper

    cfg, fcfg, consts, lw, rcfg, gcfg, key, params, sh = _setup(triplane_cfg)
    mcfg = mapper.MapConfig.from_dict(cfg)
    mcfg = mapper.MapConfig(**{**mcfg.__dict__, "iters": 2})
    opt_state = mapper.make_map_optimizer(mcfg).init(params)

    K, R = 8, 64
    kf_key = jax.random.PRNGKey(7)
    kf_rays = jax.random.uniform(kf_key, (K, R, 7))
    # plausible depths/dirs so the z-sampler sees valid geometry
    kf_rays = kf_rays.at[..., 6].set(1.5 + kf_rays[..., 6])
    kf_rays = kf_rays.at[..., 2].set(-1.0)
    kf_mask = jnp.arange(K) < 3
    poses = jnp.broadcast_to(jnp.eye(4), (K, 4, 4))
    cur_rays = kf_rays[0, :32]

    def step(ray_sharding):
        res = mapper.local_ba(
            params, opt_state, key, kf_rays, kf_mask,
            jnp.int32(0), jnp.int32(2), poses, cur_rays, jnp.eye(4),
            fcfg, consts, mcfg, lw, 128, ray_sharding=ray_sharding)
        return res.field_params

    p_dp, p_1 = step(sh), step(None)
    for name in ("s0", "s1", "cp"):
        np.testing.assert_allclose(
            np.asarray(p_dp["planes"][name]),
            np.asarray(p_1["planes"][name]), atol=1e-5,
            err_msg=f"plane param {name} diverged under DP")
