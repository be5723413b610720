"""Pose-graph optimization over submap anchor poses (loop closure).

Replacement for the reference's pypose Levenberg-Marquardt
pipeline (/root/reference/PoseCorrector.py:173-216, model/poseGraph.py:8-46):

  * nodes  = world poses of each submap's first keyframe;
  * edges  = current relative poses of adjacent submap pairs, plus one
    "key edge" from the loop observation, down-weighted by
    key_edge_weight (ref poseGraph.py:40-44);
  * residual per edge (i -> j with observation Z_ji):
      r = log( Z @ node_i^-1 @ node_j )   in se(3),
    node 0 held fixed (gauge freedom).

The problem is tiny (M <= ~20 nodes), so a damped Gauss-Newton with
jacobians from jax.jacfwd over tangent increments converges in a few
iterations; the whole solve is one jitted call.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.geometry import _mm, pose_inverse, se3_exp, se3_log


def _apply_increments(nodes: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiply tangent increments onto node poses [M,4,4]."""
    return jax.vmap(lambda x, T: _mm(se3_exp(x), T))(xi, nodes)


def _residuals(xi: jnp.ndarray, nodes: jnp.ndarray, edges: jnp.ndarray,
               rel_poses: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Stacked weighted residuals [E*6] at tangent offset xi."""
    n = _apply_increments(nodes, xi)
    ni = n[edges[:, 0]]
    nj = n[edges[:, 1]]
    err = jax.vmap(lambda Z, a, b: se3_log(_mm(Z, _mm(pose_inverse(a), b))))(
        rel_poses, ni, nj)                       # [E, 6]
    return (err * weights[:, None]).reshape(-1)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph(nodes: jnp.ndarray, edges: jnp.ndarray,
                        rel_poses: jnp.ndarray, weights: jnp.ndarray,
                        node_mask: jnp.ndarray,
                        n_iters: int = 10) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Damped GN over node poses.

    nodes [M,4,4]; edges [E,2] int; rel_poses [E,4,4] observations Z s.t.
    residual = log(Z node_i^-1 node_j); weights [E]; node_mask [M] bool,
    False freezes a node (node 0 = gauge anchor). Returns (optimized
    nodes [M,4,4], final cost).
    """
    M = nodes.shape[0]
    free = node_mask.astype(nodes.dtype)[:, None]

    def gn_step(nodes, _):
        xi0 = jnp.zeros((M, 6), nodes.dtype)
        r = _residuals(xi0, nodes, edges, rel_poses, weights)
        J = jax.jacfwd(_residuals)(xi0, nodes, edges, rel_poses, weights)
        J = J.reshape(r.shape[0], M * 6)
        # freeze masked nodes by zeroing their jacobian columns
        Jm = J * jnp.repeat(free[:, 0], 6)[None, :]
        H = _mm(Jm.T, Jm) + 1e-6 * jnp.eye(M * 6, dtype=nodes.dtype)
        g = Jm.T @ r
        xi = (-jnp.linalg.solve(H, g)).reshape(M, 6) * free
        new_nodes = _apply_increments(nodes, xi)
        cost = jnp.sum(r ** 2)
        return new_nodes, cost

    nodes, costs = jax.lax.scan(gn_step, nodes, None, length=n_iters)
    xi0 = jnp.zeros((M, 6), nodes.dtype)
    final_cost = jnp.sum(
        _residuals(xi0, nodes, edges, rel_poses, weights) ** 2)
    return nodes, final_cost


def build_pose_graph_problem(first_kf_poses: jnp.ndarray,
                             adjacency: jnp.ndarray,
                             key_edge: Tuple[int, int],
                             key_rel_pose: jnp.ndarray,
                             key_edge_weight: float,
                             n_used: int):
    """Assemble edges/observations as the reference does
    (ref PoseCorrector.pose_graph_optimize :186-206): one edge per
    adjacent pair carrying the CURRENT relative pose (so those edges
    start at zero residual), plus the key loop edge with its observed
    relative pose. Returns (edges [E,2], rel_poses [E,4,4], weights [E]).

    Static shapes: E = M*(M-1)/2 + 1 with zero-weight padding for
    non-adjacent pairs.
    """
    import numpy as np
    M = first_kf_poses.shape[0]
    pairs = np.asarray([(i, j) for i in range(M) for j in range(i + 1, M)],
                       np.int32).reshape(-1, 2)
    edges = jnp.asarray(np.concatenate(
        [pairs, np.asarray([key_edge], np.int32)], axis=0))

    # observation Z with residual log(Z n_i^-1 n_j): Z = n_j^-1 n_i —
    # ONE batched gather + vmapped product (a per-pair Python loop costs
    # ~3 eager dispatches x M(M-1)/2 pairs over the device link)
    Pi = first_kf_poses[jnp.asarray(pairs[:, 0])]
    Pj = first_kf_poses[jnp.asarray(pairs[:, 1])]
    rels_pairs = jax.vmap(lambda a, b: _mm(pose_inverse(b), a))(Pi, Pj)
    rels = jnp.concatenate([rels_pairs, key_rel_pose[None]], axis=0)

    adj = np.asarray(adjacency)
    w = ((adj[pairs[:, 0], pairs[:, 1]] > 0)
         & (pairs[:, 0] < n_used) & (pairs[:, 1] < n_used)
         ).astype(np.float32)
    weights = jnp.concatenate(
        [jnp.asarray(w), jnp.asarray([key_edge_weight], jnp.float32)])
    return edges, rels, weights
