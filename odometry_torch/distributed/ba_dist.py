"""Windowed BA with the point lanes split over ranks (port of
``distributed/ba_dist.py``).

The Schur-reduced pose system is a sum over point lanes,

    Hred = Hpp - sum_p B_p B_p' / Hdd_p,     bred = bp - sum_p B_p bd_p / Hdd_p,

so each rank of the mesh's "model" axis linearizes and reduces its own lanes
on its device. The reference's ``psum`` over "model" becomes one sum of the
ranks' partials in rank order on rank 0's device, copied back to every rank;
every rank then solves the (6K x 6K) system redundantly, as the reference
does, and back-substitutes its own depths. A fixed order makes the sum
deterministic, but it is not the unsharded sum's order, so the costs differ
from :func:`~odometry_torch.mapping.ba.ba_solve` in the last bits.

When the "model" ranks span processes (a mesh built after
``initialize_multihost``), every process calls :func:`ba_solve_sharded`
with the whole problem and works its own ranks' lanes; each partial is
all-gathered across the processes by B3 (``ring_exchange.ring_all_gather``:
the kernel through CUDA IPC on cards, the plain ring over gloo on the CPU),
and every rank sums the gathered partials in rank order: the same IEEE
operations in the same order as one process's sum, so the same bits.
"""

from __future__ import annotations

import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.distributed import ring_exchange
from odometry_torch.distributed.mesh import Mesh
from odometry_torch.mapping.ba import (
    BAConfig,
    BAProblem,
    BAResult,
    _apply_step,
    _assemble_and_reduce,
    _linearize,
    _pose_step,
)


def _rank_sum(parts: list, devs: list, model: Mesh | None = None) -> list:
    """The reference's psum: the ranks' partials summed in rank order on
    rank 0's device, then one copy per rank on its device. With `model`, a
    "model" mesh that spans processes, `parts` are this process's ranks'
    and each is all-gathered (one row per rank) before every rank of this
    process sums the rows in rank order on its device."""
    if model is None:
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(devs[0])
        return [total.to(d) for d in devs]
    shape = parts[0].shape
    rows = ring_exchange.ring_all_gather([p.reshape(1, -1) for p in parts], model, "model")
    sums = []
    for g in rows:
        g = g.reshape((model.size,) + shape)
        total = g[0]
        for j in range(1, model.size):
            total = total + g[j]
        sums.append(total)
    return sums


def _shard(problem: BAProblem, m: int, lanes: int, dev) -> BAProblem:
    """Rank m's problem: its `lanes` point lanes, images and poses replicated."""
    cut = lambda a: a[:, m * lanes:(m + 1) * lanes].contiguous().to(dev)
    return BAProblem(
        images=problem.images.to(dev), xs=cut(problem.xs), ys=cut(problem.ys),
        inv_depth=cut(problem.inv_depth), intensity=cut(problem.intensity),
        point_valid=cut(problem.point_valid), pose=problem.pose.to(dev),
        kf_valid=problem.kf_valid.to(dev))


def ba_solve_sharded(problem: BAProblem, cam: Pinhole, mesh: Mesh,
                     cfg: BAConfig = BAConfig()) -> BAResult:
    """:func:`~odometry_torch.mapping.ba.ba_solve` with the point lanes
    split over the mesh's "model" ranks. P must be divisible by their number.
    Returns the poses and costs of rank 0 and the inverse depths gathered on
    rank 0's device. Across processes (see the module docstring) every
    process returns its first rank's poses and costs, equal to rank 0's,
    and every rank's inverse depths gathered (by B3) on that rank's device."""
    if cfg.iters < 1:
        raise ValueError(f"ba_solve_sharded: iters={cfg.iters}, needs at least one")
    K, Ptotal = problem.xs.shape
    axis = mesh.axis_mesh("model")
    n = axis.size
    if Ptotal % n != 0:
        raise ValueError(f"ba_solve_sharded: {Ptotal} point lanes not divisible by the "
                         f"{n} ranks of 'model'")
    axis.require_every_process("model")
    across = axis if axis.processes is not None else None
    ranks = axis.local_ranks()
    devs = [axis.devices[m] for m in ranks]
    sum_ = lambda parts: _rank_sum(parts, devs, across)
    lanes = Ptotal // n
    probs = [_shard(problem, m, lanes, d) for m, d in zip(ranks, devs)]
    pose = [p.pose for p in probs]
    inv_depth = [p.inv_depth for p in probs]
    cost0 = None
    for _ in range(cfg.iters):
        lin = [_linearize(p._replace(pose=pose[m], inv_depth=inv_depth[m]), cam, cfg)
               for m, p in enumerate(probs)]
        sq = sum_([torch.sum(w * r * r) for r, w, *_ in lin])
        nres = sum_([torch.sum(w > 0) for _, w, *_ in lin])
        cost = [s / torch.clamp(c, min=1).to(s.dtype) for s, c in zip(sq, nres)]
        red = [_assemble_and_reduce(r, w, J_i, J_j, J_d, K, cfg)
               for r, w, J_i, J_j, J_d, _ in lin]
        # THE collective: the Schur system reduced over the point shards.
        Hred = sum_([h for h, *_ in red])
        bred = sum_([b for _, b, *_ in red])

        cand = []
        for m, p in enumerate(probs):
            _, _, _, bd, B, inv_Hdd = red[m]
            dxi_k = _pose_step(Hred[m], bred[m], K, cfg)
            cand.append(_apply_step(pose[m], inv_depth[m], dxi_k, bd, B, inv_Hdd, cfg))
        lin2 = [_linearize(p._replace(pose=cp, inv_depth=ci), cam, cfg, jac=False)
                for p, (cp, ci) in zip(probs, cand)]
        sq2 = sum_([torch.sum(w * r * r) for r, w, *_ in lin2])
        n2 = sum_([torch.sum(w > 0) for _, w, *_ in lin2])
        out_cost = []
        for m in range(len(probs)):
            cand_cost = sq2[m] / torch.clamp(n2[m], min=1).to(sq2[m].dtype)
            accept = cand_cost <= cost[m]
            pose[m] = torch.where(accept, cand[m][0], pose[m])
            inv_depth[m] = torch.where(accept, cand[m][1], inv_depth[m])
            out_cost.append(torch.where(accept, cand_cost, cost[m]))
        if cost0 is None:
            cost0 = cost[0]
    if across is None:
        depths = torch.cat([d.to(devs[0]) for d in inv_depth], 1)
    else:  # every rank's (K, lanes) block, gathered lane-major: (P, K) -> (K, P)
        depths = ring_exchange.ring_all_gather([d.t().contiguous() for d in inv_depth],
                                               across, "model")[0].t()
    return BAResult(pose=pose[0], inv_depth=depths, cost_initial=cost0,
                    cost_final=out_cost[0], num_residuals=nres[0])
