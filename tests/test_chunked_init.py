"""Chunked deferred new-submap init (ref's concurrent first fit).

The reference runs the 500-iter first fit of a new submap CONCURRENTLY
with tracking in the mapping process (ref mipsfusion.py:198-222, the
tracking process does not wait at :470-576). The sequenced loop
re-expresses that overlap by splitting the fit into fixed-size chunks
interleaved with the tracked frames (system.py active_submap_switch_new
/ _drain_init_chunk / _flush_pending_init). These tests pin the
mechanics: chunk accounting, per-frame draining, flush-on-events, and
that tracking against the partially-fit submap stays finite.
"""

import numpy as np
import jax.numpy as jnp

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU

from test_smoke_e2e import smoke_config


def _make(n=10, first_iters=12, chunk=4):
    cfg = smoke_config(n)
    cfg["mapping"]["first_iters"] = first_iters
    cfg["mapping"]["first_iters_chunk"] = chunk
    cfg["use_manager"] = False
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit",
                          span=n / 400.0)
    slam = MIPSFusionTPU(cfg, dataset=ds)
    return slam, ds, n


def _frame(ds, i):
    return {"frame_id": i, "c2w": ds.gt_pose(i)}


def test_chunked_init_drains_per_frame():
    slam, ds, n = _make(first_iters=12, chunk=4)
    slam.process_frame(_frame(ds, 0), 0)
    for i in range(1, 4):
        slam.process_frame(_frame(ds, i), i)

    # simulate the manager's msg3 decision: a fresh submap id is active
    slam.state = slam.state._replace(
        active_submap_id=jnp.asarray(1, jnp.int32))
    slam.active_submap_switch_new(_frame(ds, 4), 4, 1)
    # one chunk ran on the switch frame, the rest is pending
    assert slam._pending_init_iters == 12 - 4
    assert slam._pending_init_rays is not None

    slam.process_frame(_frame(ds, 5), 5)
    assert slam._pending_init_iters == 4
    slam.process_frame(_frame(ds, 6), 6)
    assert slam._pending_init_iters == 0
    assert slam._pending_init_rays is None

    # tracking against the partially/freshly fit submap stayed finite
    assert np.isfinite(np.asarray(slam.state.est_c2w[:7])).all()


def test_chunk_flush_on_events():
    slam, ds, n = _make(first_iters=10, chunk=4)
    slam.process_frame(_frame(ds, 0), 0)
    slam.state = slam.state._replace(
        active_submap_id=jnp.asarray(1, jnp.int32))
    slam.active_submap_switch_new(_frame(ds, 1), 1, 0)
    # 10 iters, chunk 4: one chunk ran, 6 pending; flush overshoots to
    # the next chunk boundary (2 more chunks) and clears the carry
    assert slam._pending_init_iters == 6
    slam._flush_pending_init()
    assert slam._pending_init_iters == 0
    assert slam._pending_init_rays is None


def test_chunk_disabled_runs_whole_fit():
    slam, ds, n = _make(first_iters=8, chunk=0)
    slam.process_frame(_frame(ds, 0), 0)
    slam.state = slam.state._replace(
        active_submap_id=jnp.asarray(1, jnp.int32))
    slam.active_submap_switch_new(_frame(ds, 1), 1, 0)
    assert slam._pending_init_iters == 0
