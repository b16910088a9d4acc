"""Essential-graph Sim3 pose-graph optimization.

Capability parity with /root/reference/src/optimizer/pose_graph.rs (Sim3
nodes, spanning-tree + covisibility + loop edges, anchor fixed) — with two
upgrades: jacfwd-exact Jacobians instead of numerical differencing
(pose_graph.rs:478-533), and this optimizer is actually INVOKED by the loop
closer (the reference exports but never calls it; SURVEY.md §2.1 #23).

Fixed-shape formulation: edges come as padded index/measurement arrays;
the dense (7K, 7K) normal system is assembled by batched block scatters and
solved Jacobi-preconditioned. K<=256 keyframes -> 1792^2 system, small
for a dense solve; no sparse machinery needed at this scale.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_tpu.geometry.sim3 import Sim3


class PoseGraphProblem(NamedTuple):
    nodes: Sim3  # batched (K,) initial node poses (world-from-body)
    node_valid: jnp.ndarray  # (K,)
    node_fixed: jnp.ndarray  # (K,) — gauge anchors (at least one)
    e_i: jnp.ndarray  # (E,) int32 edge endpoints
    e_j: jnp.ndarray  # (E,)
    e_meas: Sim3  # batched (E,) measured S_ij = S_i^-1 S_j
    e_weight: jnp.ndarray  # (E,) information weight
    e_valid: jnp.ndarray  # (E,)


def edge_residual(S_i: Sim3, S_j: Sim3, S_meas: Sim3):
    """7-D residual log(S_meas^-1 * (S_i^-1 * S_j))."""
    rel = S_i.inverse().compose(S_j)
    err = S_meas.inverse().compose(rel)
    return err.log()


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def solve_pose_graph(prob: PoseGraphProblem, iters: int = 12,
                     fix_scale: bool = True, scale_prior: float = 1e3):
    """GN over Sim3 node corrections. Returns optimized batched Sim3 nodes."""
    K = prob.node_valid.shape[0]
    E = prob.e_i.shape[0]
    D = 7

    def retract_all(nodes: Sim3, dx):
        """dx: (K, 7) tangent updates (zeroed for fixed nodes)."""
        free = (prob.node_valid & ~prob.node_fixed).astype(jnp.float32)
        dx = dx * free[:, None]
        return jax.vmap(lambda n, x: n.retract(x))(nodes, dx)

    def residual_of(nodes: Sim3, e):
        S_i = jax.tree.map(lambda a: a[prob.e_i[e]], nodes)
        S_j = jax.tree.map(lambda a: a[prob.e_j[e]], nodes)
        S_m = jax.tree.map(lambda a: a[e], prob.e_meas)
        return edge_residual(S_i, S_j, S_m)

    def gn_step(nodes: Sim3, _):
        def edge_r_wrt(dxi, dxj, e):
            S_i = jax.tree.map(lambda a: a[prob.e_i[e]], nodes)
            S_j = jax.tree.map(lambda a: a[prob.e_j[e]], nodes)
            S_m = jax.tree.map(lambda a: a[e], prob.e_meas)
            return edge_residual(S_i.retract(dxi), S_j.retract(dxj), S_m)

        zero = jnp.zeros(D, jnp.float32)
        es = jnp.arange(E)
        r = jax.vmap(lambda e: edge_r_wrt(zero, zero, e))(es)  # (E, 7)
        Ji = jax.vmap(lambda e: jax.jacfwd(edge_r_wrt, 0)(zero, zero, e))(es)
        Jj = jax.vmap(lambda e: jax.jacfwd(edge_r_wrt, 1)(zero, zero, e))(es)

        w = prob.e_weight * prob.e_valid
        Ji_w = Ji * w[:, None, None]
        Jj_w = Jj * w[:, None, None]

        H = jnp.zeros((K, D, K, D))
        H = H.at[prob.e_i, :, prob.e_i, :].add(
            jnp.einsum("eri,erj->eij", Ji_w, Ji, precision="highest")
        )
        H = H.at[prob.e_j, :, prob.e_j, :].add(
            jnp.einsum("eri,erj->eij", Jj_w, Jj, precision="highest")
        )
        H = H.at[prob.e_i, :, prob.e_j, :].add(
            jnp.einsum("eri,erj->eij", Ji_w, Jj, precision="highest")
        )
        H = H.at[prob.e_j, :, prob.e_i, :].add(
            jnp.einsum("eri,erj->eij", Jj_w, Ji, precision="highest")
        )
        b = jnp.zeros((K, D))
        b = b.at[prob.e_i].add(jnp.einsum("eri,er->ei", Ji_w, r, precision="highest"))
        b = b.at[prob.e_j].add(jnp.einsum("eri,er->ei", Jj_w, r, precision="highest"))

        H = H.reshape(K * D, K * D)
        b = b.reshape(K * D)
        if fix_scale:
            # strong prior keeping sigma (the 7th coordinate) at zero
            sidx = jnp.arange(K) * D + 6
            H = H.at[sidx, sidx].add(scale_prior)

        free = (prob.node_valid & ~prob.node_fixed).astype(jnp.float32)
        freeD = jnp.repeat(free, D)
        H = H * freeD[:, None] * freeD[None, :] + jnp.diag(1.0 - freeD)
        H = H + jnp.eye(K * D) * 1e-5
        b = b * freeD

        d = jnp.sqrt(jnp.clip(jnp.diag(H), 1e-9, None))
        dx = -(jnp.linalg.solve(H / d[:, None] / d[None, :], b / d) / d)
        nodes = retract_all(nodes, dx.reshape(K, D))
        return nodes, jnp.sum(r * r * w[:, None])

    nodes, costs = jax.lax.scan(gn_step, prob.nodes, None, length=iters)
    return nodes, costs
