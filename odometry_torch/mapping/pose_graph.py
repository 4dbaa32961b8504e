"""SE(3) pose-graph optimization over odometry chains and loop closures
(port of ``mapping/pose_graph.py``).

Nodes are keyframe poses T_k (cam-to-world); edge e is a relative-pose
measurement Z_e between nodes (i_e, j_e) with residual

    r_e = log( Z_e^-1  T_i^-1 T_j )        (6-vector twist [v, w])

minimized by damped Gauss-Newton under right-multiplicative perturbations
T <- T exp(xi), with the small-residual Jacobians J_j = I and J_i =
-Adj(T_j^-1 T_i). All edges are one batch; the block Hessian is assembled with
one-hot products over the edges (so edges that share a node add up, in a
fixed order on the CPU and on the card alike), and the dense 6N x 6N system
is solved by ``torch.linalg.solve_ex``, as the reference leaves its solve to
XLA. Node 0 is pinned by a strong diagonal prior (the gauge). The
reference's ``lax.scan`` over the iterations is a Python loop; a step that
is not finite is zeroed on the device, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from odometry_torch.geometry import se3_adjoint, se3_exp, se3_inverse, se3_log


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4)
    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,) int32
    edge_T: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) scalar information weight (0 disables)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor
    cost_initial: torch.Tensor
    cost_final: torch.Tensor


def odometry_edges(poses: torch.Tensor, weight: float = 1.0):
    """Consecutive-pose edges of a trajectory (measurement = current chain):
    (edge_i, edge_j, edge_T, edge_weight)."""
    n = poses.shape[0]
    i = torch.arange(n - 1, dtype=torch.int32, device=poses.device)
    Z = se3_inverse(poses[:-1]) @ poses[1:]
    w = torch.full((n - 1,), weight, dtype=torch.float32, device=poses.device)
    return i, i + 1, Z, w


def _residuals(graph: PoseGraph):
    Ti = graph.poses[graph.edge_i.long()]
    Tj = graph.poses[graph.edge_j.long()]
    rel = se3_inverse(Ti) @ Tj
    r = se3_log(se3_inverse(graph.edge_T) @ rel)  # (E, 6)
    return r, rel


def pose_graph_cost(graph: PoseGraph) -> torch.Tensor:
    r, _ = _residuals(graph)
    return torch.sum(graph.edge_weight[:, None] * r * r)


def optimize_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
                        gauge_prior: float = 1e9) -> PoseGraphResult:
    """`iters` damped Gauss-Newton steps; cost_initial is the cost before the
    first step, cost_final after the last."""
    if iters < 1:
        raise ValueError(f"optimize_pose_graph: iters={iters}, needs at least one")
    N = graph.poses.shape[0]
    dev = graph.poses.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = graph.edge_weight
    oi = torch.nn.functional.one_hot(graph.edge_i.long(), N).to(torch.float32)  # (E, N)
    oj = torch.nn.functional.one_hot(graph.edge_j.long(), N).to(torch.float32)
    gauge = torch.zeros(6 * N, **f32)
    gauge[:6] = gauge_prior
    prior = torch.diag(gauge) + damping * torch.eye(6 * N, **f32)
    w_eye = w[:, None, None] * torch.eye(6, **f32)

    def blocks(a, b, M):
        """(N, N, 6, 6): M[e] added at block (i_e, j_e) for one-hot rows a, b."""
        return torch.einsum("em,en,ebc->mnbc", a, b, M)

    poses = graph.poses
    cost0 = None
    for _ in range(iters):
        r, rel = _residuals(graph._replace(poses=poses))
        if cost0 is None:
            cost0 = torch.sum(w[:, None] * r * r)
        # J_j = I ; J_i = -Adj(T_j^-1 T_i) = -Adj(rel^-1).
        Ji = -se3_adjoint(se3_inverse(rel))  # (E, 6, 6)
        wJi = Ji * w[:, None, None]
        HijT = Ji.transpose(1, 2) * w[:, None, None]  # off-diagonal block H[i, j] = Ji^T W
        H = (blocks(oi, oi, torch.einsum("eab,eac->ebc", wJi, Ji)) + blocks(oj, oj, w_eye)
             + blocks(oi, oj, HijT) + blocks(oj, oi, HijT.transpose(1, 2)))
        wr = w[:, None] * r
        b = (-torch.einsum("en,eba,eb->na", oi, Ji, wr) - torch.einsum("en,ea->na", oj, wr))
        Hfull = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N) + prior
        dxi, _ = torch.linalg.solve_ex(Hfull, b.reshape(-1))
        dxi = torch.where(torch.isfinite(dxi).all(), dxi, torch.zeros_like(dxi))
        poses = poses @ se3_exp(dxi.reshape(N, 6))
    final = pose_graph_cost(graph._replace(poses=poses))
    return PoseGraphResult(poses, cost0, final)
