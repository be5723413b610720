"""Multi-chip parallelism: device mesh, shardings, and sharded train steps.

The reference has no distributed code (its "parallelism" is two OS
processes on one GPU, SURVEY.md §2.11); scaling here has two axes:

  * **Ray data-parallelism (DP)** — the mapping/BA workload is
    embarrassingly parallel over rays. The ray batch is sharded along
    the mesh's ``data`` axis, field params are replicated, and XLA
    inserts the gradient all-reduce from the sharding annotations (no
    explicit collectives).

  * **Submap parallelism (the reference's "expert" analog)** — the
    stacked submap parameter axis [M, ...] is sharded across devices on
    the ``submap`` axis, so background refinement of M inactive submaps
    (ref InactiveMap.py:203-307 round-robin) proceeds concurrently,
    one (or more) submap per chip with no cross-chip traffic.

All shardings are expressed with jax.sharding.NamedSharding over a
Mesh; jit inserts the collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import scene_rep as sr


def make_mesh(n_devices: Optional[int] = None,
              data_axis: Optional[int] = None) -> Mesh:
    """1D or 2D device mesh: (data,) or (data, submap).

    Raises if fewer than ``n_devices`` devices are available — a mesh
    that silently shrinks would make sharding checks vacuous (they
    would "pass" on a single device while testing nothing).
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh({n}) needs {n} devices but only {len(devs)} are "
            f"available on backend '{jax.default_backend()}'")
    devs = np.asarray(devs[:n])
    if data_axis is None or data_axis == n:
        mesh = Mesh(devs, ("data",))
    else:
        assert n % data_axis == 0
        mesh = Mesh(devs.reshape(data_axis, n // data_axis),
                    ("data", "submap"))
    assert mesh.devices.size == n
    return mesh


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray-batch) axis along the data axis."""
    return NamedSharding(mesh, P("data"))


def submap_sharded(mesh: Mesh) -> NamedSharding:
    """Shard a stacked submap axis [M, ...] along the mesh's last axis."""
    axis = mesh.axis_names[-1] if len(mesh.axis_names) > 1 else "data"
    return NamedSharding(mesh, P(axis))


def shard_field_params(params: Dict, mesh: Mesh,
                       stacked: bool = False) -> Dict:
    """Place field params: replicated, or submap-axis sharded if stacked."""
    sh = submap_sharded(mesh) if stacked else replicated(mesh)
    return jax.device_put(params, sh)


# ---------------------------------------------------------------------------
# Sharded mapping step (DP over rays)
# ---------------------------------------------------------------------------

def make_sharded_map_step(mesh: Mesh, fcfg: sr.FieldConfig,
                          lw: sr.LossWeights, opt):
    """Build a jitted DP training step: rays sharded, params replicated.

    Returns step(params, opt_state, key, rays[N,7], consts) ->
    (params, opt_state, loss). N must be divisible by the data-axis size.
    """
    rep = replicated(mesh)
    rsh = ray_sharded(mesh)

    @partial(jax.jit,
             in_shardings=(rep, rep, rep, rsh, rep),
             out_shardings=(rep, rep, rep))
    def step(params, opt_state, key, rays, consts):
        def loss_fn(p):
            # transposed training layout; the [., N] arrays keep the
            # ray axis sharded (a transpose permutes the sharded dim,
            # no resharding)
            dirsT = rays[:, :3].T
            ret = sr.forward_losses_T(
                p, key, jnp.zeros_like(dirsT), dirsT,
                rays[:, 3:6].T, rays[:, 6:7], fcfg, consts)
            return sr.total_loss(ret, lw)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def sharded_map_step(mesh: Mesh, fcfg: sr.FieldConfig, lw: sr.LossWeights,
                     opt, params, opt_state, key, rays, consts):
    """One-shot convenience wrapper around make_sharded_map_step."""
    step = make_sharded_map_step(mesh, fcfg, lw, opt)
    return step(params, opt_state, key, rays, consts)


# ---------------------------------------------------------------------------
# Sharded submap refinement (submap-axis parallelism)
# ---------------------------------------------------------------------------

def refine_loss_and_grads(params, key, rays, consts_lo, consts_inv, *,
                          fcfg: sr.FieldConfig, lw: sr.LossWeights):
    """One submap's refinement loss on its camera-frame ray batch
    [N, 7] and the gradient wrt its field params."""
    consts = sr.FieldConsts(consts_lo, consts_inv)

    def loss_fn(p):
        dirsT = rays[:, :3].T
        ret = sr.forward_losses_T(
            p, key, jnp.zeros_like(dirsT), dirsT,
            rays[:, 3:6].T, rays[:, 6:7], fcfg, consts)
        return sr.total_loss(ret, lw)

    return jax.value_and_grad(loss_fn)(params)


def make_sharded_refine_step(mesh: Mesh, fcfg: sr.FieldConfig,
                             lw: sr.LossWeights, opt):
    """Build a jitted step refining M stacked submaps concurrently.

    params are stacked [M, ...] and sharded along the submap axis; each
    submap trains against its own ray batch rays[M, N, 7] (also
    submap-sharded). vmap over the submap axis + sharding = one chip per
    submap group, no cross-chip traffic. Inactive-submap round-robin
    (ref InactiveMap.py:203-307) becomes a single collective-free step.
    """
    ssh = submap_sharded(mesh)
    rep = replicated(mesh)
    one = partial(refine_loss_and_grads, fcfg=fcfg, lw=lw)

    @partial(jax.jit,
             in_shardings=(ssh, ssh, rep, ssh, ssh, ssh),
             out_shardings=(ssh, ssh, ssh))
    def step(params, opt_state, keys, rays, consts_lo, consts_inv):
        loss, g = jax.vmap(one)(params, keys, rays, consts_lo, consts_inv)
        updates, opt_state = jax.vmap(
            lambda gg, ss, pp: opt.update(gg, ss, pp))(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
