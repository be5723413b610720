"""Ray-DP on the live hot path (local BA + submap init), virtual 8-CPU mesh.

VERDICT r2 item 1: the mapping hot loop (ref mipsfusion.py:259-370) must
run data-parallel over rays on a multi-chip mesh IN THE LIVE SYSTEM —
params replicated, the per-iteration ray batch sharded over the data
axis, gradient all-reduce inserted by XLA. This test drives the full system
both ways and demands ATE parity.
"""

import jax
import numpy as np
import pytest

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from test_slam_single import tiny_config

def test_dp_ba_lowering_has_gradient_allreduce():
    """The compiled DP local-BA step must actually shard the ray batch.

    ATE parity alone cannot catch a dropped sharding constraint (a
    fully-replicated program computes the identical result), so this
    asserts the structural signature of ray-DP in the compiled HLO:
    with the batch sharded and params replicated, XLA must insert an
    all-reduce for the map/pose gradients; without the constraint the
    module must contain none.
    """
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mipsfusion_tpu.models import scene_rep as sr
    from mipsfusion_tpu.slam import mapper

    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    cfg = tiny_config(8)
    fcfg = sr.FieldConfig.from_dict(cfg)
    consts = sr.FieldConsts.from_bound(
        jnp.asarray(cfg["mapping"]["bound"], jnp.float32))
    lw = sr.LossWeights.from_dict(cfg)
    mcfg = mapper.MapConfig.from_dict(cfg)
    mcfg = mapper.MapConfig(**{**mcfg.__dict__, "iters": 2})

    key = jax.random.PRNGKey(0)
    params = sr.init_field_params(key, fcfg)
    opt_state = mapper.make_map_optimizer(mcfg).init(params)
    K, R, n_total = 8, 64, 128
    kf_rays = jnp.zeros((K, R, 7))
    kf_mask = jnp.arange(K) < 3
    poses = jnp.broadcast_to(jnp.eye(4), (K, 4, 4))
    cur_rays = jnp.zeros((32, 7))

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    sh = NamedSharding(mesh, P("data"))

    def lower(ray_sharding):
        return mapper.local_ba.lower(
            params, opt_state, key, kf_rays, kf_mask,
            jnp.int32(0), jnp.int32(2), poses, cur_rays, jnp.eye(4),
            fcfg, consts, mcfg, lw, n_total,
            ray_sharding=ray_sharding).compile().as_text()

    hlo_dp = lower(sh)
    hlo_rep = lower(None)
    assert "all-reduce" in hlo_dp, \
        "DP lowering lost the ray sharding constraint (no all-reduce)"
    assert "all-reduce" not in hlo_rep


def _run(dp: bool, n=24):
    from fixture_cache import cached_run
    cfg = tiny_config(n)
    cfg["parallel"] = {"sharded_refine": False, "dp_hot_path": dp}

    def make_slam():
        ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit",
                              span=n / 200.0)
        return MIPSFusionTPU(cfg, dataset=ds)

    slam, aux = cached_run(f"sharded_ba_{int(dp)}", cfg, make_slam,
                           lambda s: {"results": s.run(verbose=False)},
                           extra_files=(__file__,))
    return slam, aux["results"]


@pytest.mark.slow
def test_dp_hot_path_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    slam_dp, res_dp = _run(dp=True)
    assert slam_dp.use_dp_hot and slam_dp._ray_sharding is not None
    # the sharded batch is padded to a multiple of the mesh size
    assert slam_dp._round_rays(601) % slam_dp.n_devices == 0

    slam_sq, res_sq = _run(dp=False)
    assert slam_sq._ray_sharding is None

    ate_dp = res_dp["absolute_translational_error.rmse"]
    ate_sq = res_sq["absolute_translational_error.rmse"]
    print(f"ATE dp {ate_dp*1000:.1f} mm, single {ate_sq*1000:.1f} mm")
    # both legs must track the easy orbit tightly, and the DP path must
    # not change the result beyond reduction-order noise + the padded
    # ray count (measured: sub-mm difference)
    assert ate_dp < 0.02, f"DP-path ATE diverged: {ate_dp}"
    assert ate_sq < 0.02, f"single-path ATE diverged: {ate_sq}"
    assert abs(ate_dp - ate_sq) < 0.005

    # field params stay finite under the sharded updates
    leaves = jax.tree.leaves(slam_dp.submap_params[slam_dp.active_id])
    assert all(bool(np.isfinite(np.asarray(l)).all()) for l in leaves)
