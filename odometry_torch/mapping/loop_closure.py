"""Loop closure: proximity proposal -> photometric verification -> pose graph
(port of ``mapping/loop_closure.py``).

1. **Proposal** (host numpy over the small keyframe ring): when a keyframe is
   inserted, earlier keyframes whose estimated position lies within a
   drift-scaled radius, excluding the `min_separation` most recent ones, and
   whose thumbnail looks like the newest's, are loop candidates; the most
   similar wins (the nearest when the store keeps no images).
2. **Verification** (on the store's device): a coarse-to-fine photometric LM
   solve of the candidate keyframe's point lanes against the new keyframe's
   level-0 image, through the tracker's own ``_solve_level_points``, warm
   started from the currently estimated relative pose. Accepted only if it
   finds residuals on every level, ends below `max_cost` with enough inliers,
   and stays within the drift budget of its warm start.
3. **Correction**: the verified relative pose becomes one extra edge of an
   SE(3) pose graph over the ring (odometry edges = the current chain),
   solved by ``mapping/pose_graph.py``; the refined poses are written back
   into a new store.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole, intrinsic_pyramid
from odometry_torch.config import TrackerConfig
from odometry_torch.geometry import se3_inverse
from odometry_torch.image.pyramid import gaussian_image_pyramid
from odometry_torch.image.sampling import sample_bilinear
from odometry_torch.kernels.points import PointSet
from odometry_torch.mapping.keyframe import KeyframeStore
from odometry_torch.mapping.pose_graph import PoseGraph, optimize_pose_graph
from odometry_torch.tracking.tracker import KeyframeLevel, _solve_level_points


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    radius: float = 3.0  # proposal: max distance between keyframe positions (m)
    min_separation: int = 4  # proposal: skip this many most-recent keyframes
    max_iters: int = 40  # verification LM budget per pyramid level
    max_cost: float = 120.0  # verification: max final mean robust cost
    min_inliers: int = 200  # verification: min valid reprojected points
    # Consistency gate: the verified pose may differ from the proposal prior
    # only by a bounded correction (the accumulated drift); a solve that lands
    # far from the prior means the proposal itself was wrong.
    max_correction_t: float = 1.0  # meters
    max_correction_r: float = 0.3  # radians (angle of the rotation correction)
    edge_weight: float = 1.0  # pose-graph information weight of a loop edge
    graph_iters: int = 10
    # Drift grows with the distance travelled, so the proposal radius and the
    # translation gate grow by drift_per_meter * (path_new - path_cand), the
    # rotation gate by a tenth of that. 0 keeps the fixed gates.
    drift_per_meter: float = 0.03
    # Minimum NCC between the standardized keyframe thumbnails for a proposal;
    # <= -1 disables it (stores built without images skip it anyway).
    appearance_ncc: float = 0.5


class LoopVerification(NamedTuple):
    T_rel: torch.Tensor  # (4, 4) candidate-kf cam -> new-kf cam
    ok: torch.Tensor  # bool
    cost: torch.Tensor  # final photometric cost
    inliers: torch.Tensor  # int32 valid reprojections at the solution


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def propose_loop(store: KeyframeStore, lc: LoopClosureConfig,
                 view: dict | None = None) -> tuple[int, int] | None:
    """(candidate_slot, newest_slot) as host ints, or None.

    Host numpy over the ring. `view`, when given, is a host mirror of the
    store's metadata {occupied, frame_id, pos (K, 3), path, thumb} (run_slam
    keeps one, so a proposal reads nothing from the device); otherwise the
    store's fields are read. Among admissible candidates (within the
    drift-scaled radius and, when thumbnails exist, at least
    `appearance_ncc` alike) the most alike wins, or the nearest when the
    store has no thumbnails.
    """
    if view is not None:
        occ, fid = view["occupied"], view["frame_id"]
        pos, path = view["pos"], view["path"]
        thumbs = view["thumb"]
    else:
        occ = _host(store.occupied)
        fid = _host(store.frame_id)
        pos = _host(store.pose)[:, :3, 3]
        path = _host(store.path)
        thumbs = None
    if occ.sum() < lc.min_separation + 2:
        return None
    order = np.argsort(fid)  # empty slots (fid=-1) sort first
    order = order[occ[order]]
    newest = order[-1]
    old = order[: -1 - lc.min_separation]
    if len(old) == 0:
        return None
    d = np.linalg.norm(pos[old] - pos[newest], axis=1)
    radius = lc.radius + lc.drift_per_meter * np.maximum(path[newest] - path[old], 0.0)
    admissible = d <= radius
    if store.thumb.numel() > 0 and lc.appearance_ncc > -1.0:
        if thumbs is None:
            thumbs = _host(store.thumb)
        score = np.einsum("kij,ij->k", thumbs[old], thumbs[newest])
        admissible = admissible & (score >= lc.appearance_ncc)
    else:
        score = -d
    if not admissible.any():
        return None
    best = int(np.argmax(np.where(admissible, score, -np.inf)))
    return int(old[best]), int(newest)


def verify_loop(store: KeyframeStore, cand_slot, new_slot, cam: Pinhole, tcfg: TrackerConfig,
                lc: LoopClosureConfig) -> LoopVerification:
    """Coarse-to-fine photometric solve of the candidate keyframe's points
    against the new keyframe's image, warm started at T_init = inv(T_new) @
    T_cand (both cam-to-world), so the solve only absorbs the drift.

    Both stored level-0 images are re-pyramided and the candidate's point
    lanes rescaled at each level (their backprojection is level-invariant);
    each level runs ``lc.max_iters`` LM iterations at most with
    ``step_tol=0``. The slots (host ints or device scalars) become device
    indices here; the result stays on the device.
    """
    dev = store.pose.device
    ci = torch.as_tensor(cand_slot, device=dev).long().reshape(1)
    ni = torch.as_tensor(new_slot, device=dev).long().reshape(1)
    row = lambda a, s: a.index_select(0, s)[0]
    valid = row(store.point_valid, ci)
    pts = PointSet(xs=row(store.xs, ci), ys=row(store.ys, ci), inv_depth=row(store.inv_depth, ci),
                   valid=valid, num=torch.sum(valid).to(torch.int32))
    T_init = se3_inverse(row(store.pose, ni)) @ row(store.pose, ci)
    solve_cfg = dataclasses.replace(tcfg, step_tol=0.0)
    L = tcfg.num_levels
    cams = intrinsic_pyramid(cam, L)
    pyr_new = gaussian_image_pyramid(row(store.image, ni), L, smooth=True)
    pyr_cand = gaussian_image_pyramid(row(store.image, ci), L, smooth=True)
    T = T_init
    failed = torch.tensor(False, device=dev)
    stats = None
    for l in range(L - 1, -1, -1):
        cam_l = cams[l]
        xs_l = cam_l.cx + (pts.xs - cam.cx) * (cam_l.fx / cam.fx)
        ys_l = cam_l.cy + (pts.ys - cam.cy) * (cam_l.fy / cam.fy)
        pts_l = PointSet(xs_l, ys_l, pts.inv_depth, pts.valid, pts.num)
        inten_l = sample_bilinear(pyr_cand[l], xs_l, ys_l)
        T, failed_l, stats = _solve_level_points(KeyframeLevel(pts_l, inten_l), pyr_new[l],
                                                 cam_l, T, lc.max_iters, solve_cfg)
        failed = failed | failed_l

    # Inliers at the solution: valid points that reproject in the image with
    # positive depth (the residual's own mask).
    d = pts.inv_depth
    Z0 = 1.0 / torch.where(torch.abs(d) < 1e-12, torch.ones_like(d), d)
    X = Z0 * (pts.xs - cam.cx) / cam.fx
    Y = Z0 * (pts.ys - cam.cy) / cam.fy
    Q = T @ torch.stack([X, Y, Z0, torch.ones_like(X)])
    H, W = store.image.shape[1:]
    Zs = torch.where(Q[2] == 0, torch.ones_like(Q[2]), Q[2])
    u = cam.fx * Q[0] / Zs + cam.cx
    v = cam.fy * Q[1] / Zs + cam.cy
    inl = pts.valid & (Q[2] > 0) & (u >= 0) & (v >= 0) & (u < float(W)) & (v < float(H))
    inliers = torch.sum(inl).to(torch.int32)
    # The correction gate: the solved pose must stay within the drift budget
    # of its warm start, a budget that grows with the path travelled between
    # the two keyframes.
    C = T @ se3_inverse(T_init)
    dt = torch.linalg.norm(C[:3, 3])
    dr = torch.arccos(torch.clamp(0.5 * (torch.trace(C[:3, :3]) - 1.0), -1.0, 1.0))
    dpath = torch.clamp(row(store.path, ni) - row(store.path, ci), min=0.0)
    t_gate = lc.max_correction_t + lc.drift_per_meter * dpath
    r_gate = lc.max_correction_r + 0.1 * lc.drift_per_meter * dpath
    ok = ((~failed) & (stats.err_final <= lc.max_cost) & (inliers >= lc.min_inliers)
          & (dt <= t_gate) & (dr <= r_gate))
    return LoopVerification(T, ok, stats.err_final, inliers)


def close_loop(store: KeyframeStore, cand_slot: int, new_slot: int, T_rel, lc: LoopClosureConfig,
               pose_np: np.ndarray | None = None) -> KeyframeStore:
    """Pose-graph solve over the ring with one loop edge; returns a new store.

    Nodes are the occupied slots in chronological order; odometry edges
    carry the current chain (so only the loop edge's inconsistency, the
    drift, is spread along it); the loop edge between candidate node i and
    newest node j measures Z = T_i^-1 T_j = inv(T_rel). The graph is built in
    host numpy over fixed K-node / K-edge padded arrays (unoccupied nodes
    carry identity poses and zero-weight edges, the loop edge is slot K - 1),
    so the correction is one solve and one write-back. `pose_np` spares the
    read of ``store.pose`` for a caller that has it.
    """
    occ = _host(store.occupied)
    fid = _host(store.frame_id)
    if pose_np is None:
        pose_np = _host(store.pose)
    T_rel_np = _host(T_rel) if isinstance(T_rel, torch.Tensor) else np.asarray(T_rel)
    order = np.argsort(fid)
    order = order[occ[order]]  # chronological occupied slots
    idx_of = {int(s): k for k, s in enumerate(order)}
    n = len(order)
    K = store.pose.shape[0]

    P = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    P[:n] = pose_np[order]
    ei = np.zeros((K,), np.int32)
    ej = np.zeros((K,), np.int32)
    Z = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    w = np.zeros((K,), np.float32)
    ks = np.arange(n - 1)
    ei[: n - 1] = ks
    ej[: n - 1] = ks + 1
    Z[: n - 1] = np.linalg.inv(P[: n - 1]) @ P[1:n]
    w[: n - 1] = 1.0
    ei[K - 1] = idx_of[int(cand_slot)]
    ej[K - 1] = idx_of[int(new_slot)]
    Z[K - 1] = np.linalg.inv(T_rel_np)
    w[K - 1] = lc.edge_weight

    dev = store.pose.device
    t = lambda a: torch.as_tensor(a, device=dev)
    res = optimize_pose_graph(PoseGraph(t(P), t(ei), t(ej), t(Z), t(w)), iters=lc.graph_iters)
    pose = store.pose.index_copy(0, t(order).long(), res.poses[:n])
    return dataclasses.replace(store, pose=pose)
