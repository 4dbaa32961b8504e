"""Coarse-to-fine direct photometric SE(3) tracker, point and dense engines
(port of ``tracking/tracker.py``; reference ``lm_optimizer.cpp:54-160``).

The tracker solves one frame or a batch of frames (a leading axis B on the
images, point lists and poses), the counterpart of the reference's
``jax.vmap``. The per-level LM ``lax.while_loop`` becomes a Python loop with
one ``active`` flag per frame of the batch: the loop runs while any frame is
active, reading ``active.any()`` on the host once per iteration for the
whole batch, and a frame's carry is updated only on the iterations where it
was active. So each frame's carry is frozen exactly where the reference's
loop exits for it, and ``LevelStats.iters`` counts its own iterations. The
lambda schedule is the reference's:

* err_now > err_last -> lambda *= 5, bail out when lambda would exceed 1e5,
  roll back to the last good pose;
* else -> accept, stop when err_now/err_last > precision,
  lambda = max(lambda/5, 1e-5);
* always solve (JtWJ + lambda diag(JtWJ)) delta = -JtWr and retry from
  exp(delta) @ current.

Both engines share that loop: ``solve_pose_points`` linearizes at the
keyframe's extracted point lists, ``solve_pose`` (the dense engine) at every
pixel of each level (``kernels/photometric.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from odometry_torch.camera.pinhole import Pinhole, intrinsic_pyramid
from odometry_torch.config import TrackerConfig
from odometry_torch.geometry import se3_compose, se3_exp, se3_identity
from odometry_torch.image.pyramid import central_gradients
from odometry_torch.image.sampling import clip_gather_2d
from odometry_torch.kernels.photometric import normal_equations, residual_jacobian
from odometry_torch.kernels.points import (
    PointSet,
    depth_point_pyramid,
    fit_affine_ab,
    normal_equations_points,
    residual_jacobian_points,
)
from odometry_torch.solvers.linear6 import solve_spd6
from odometry_torch.solvers.robust import robust_weights
from odometry_torch.utils.batch import batch_of_one, lane, one_lane_unbatched
from odometry_torch.utils.profiling import span

# The products of the LM loop; a batch of one takes the unbatched kernels, so
# one frame's solve rounds as the unbatched code does (utils/batch.py).
_compose = one_lane_unbatched(se3_compose)
_exp = one_lane_unbatched(se3_exp)
_normal_equations = one_lane_unbatched(normal_equations)
_normal_equations_points = one_lane_unbatched(normal_equations_points)


class LevelStats(NamedTuple):
    """One frame's; a batch leads each field with B."""

    iters: torch.Tensor  # int32: LM iterations run
    err_first: torch.Tensor  # cost at first evaluation
    err_final: torch.Tensor  # final accepted cost


class TrackResult(NamedTuple):
    T: torch.Tensor  # (4, 4) keyframe-cam -> current-cam ((B, 4, 4) for a batch)
    ok: torch.Tensor  # bool: False == the reference's "Optimize failed" identity path
    stats: Tuple[LevelStats, ...]  # per level, coarsest first


class KeyframeLevel(NamedTuple):
    """Per-level sparse tracking data, prepared once per keyframe (a batch
    of keyframes leads each field with B)."""

    pts: PointSet
    intensity: torch.Tensor  # keyframe image value at each point (cap,)


def prepare_keyframe(pyr_kf: Sequence[torch.Tensor], dpyr_kf: Sequence[torch.Tensor],
                     cfg: TrackerConfig) -> Tuple[KeyframeLevel, ...]:
    """Extract valid-depth pixels of every level into capacity-bounded lists
    (of one keyframe's pyramids, or of each keyframe of a batch)."""
    ppyr = depth_point_pyramid(dpyr_kf, cfg.boundary, cfg.min_inv_depth_valid,
                               cfg.point_capacity, order=cfg.point_order)
    return tuple(
        KeyframeLevel(pts, clip_gather_2d(pyr_kf[l], pts.ys.long(), pts.xs.long()))
        for l, pts in enumerate(ppyr)
    )


def _solve_level(img_kf: torch.Tensor, dep_kf: torch.Tensor, img_cur: torch.Tensor,
                 cam_l: Pinhole, T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
                 step_tol: float | None = None):
    """One level of the dense engine for a batch (B, H, W): every pixel of
    the keyframe level."""

    def system(T):
        sys = residual_jacobian(img_kf, dep_kf, img_cur, cam_l, T, boundary=cfg.boundary,
                                min_inv_depth=cfg.min_inv_depth_valid, interp=cfg.interp)
        if cfg.affine_light:
            # Refit every iteration, as the reference's code does.
            B = img_kf.shape[0]
            a_fit, b_fit = fit_affine_ab(sys.r.reshape(B, -1), img_kf.reshape(B, -1),
                                         sys.valid.reshape(B, -1))
            vf = sys.valid.to(sys.r.dtype)
            sys = sys._replace(r=sys.r - vf * ((a_fit[:, None, None] - 1.0) * img_kf
                                               + b_fit[:, None, None]))
        w = robust_weights(cfg.robust, sys.r, sys.valid, huber_delta=cfg.huber_delta,
                           tdist_dof=cfg.tdist_dof, tdist_sigma_init=cfg.tdist_sigma_init,
                           batch_dims=1)
        return _normal_equations(sys, w)

    return _lm_loop(system, T_init, max_iters, cfg, step_tol)


def _solve_level_points(kf_level: KeyframeLevel, img_cur: torch.Tensor, cam_l: Pinhole,
                        T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
                        step_tol: float | None = None):
    """One level of the point engine, of one frame (H, W) or a batch
    (B, H, W); returns (T, failed, LevelStats)."""
    if img_cur.dim() == 2:
        return lane(_solve_level_points(*batch_of_one((kf_level, img_cur)), cam_l,
                                        T_init[None], max_iters, cfg, step_tol), 0)
    grads = central_gradients(img_cur)
    chan = torch.stack([img_cur, grads[0], grads[1]], dim=-3) if cfg.interp == "mm" else None

    def system(T):
        sys = residual_jacobian_points(kf_level.pts, img_cur, cam_l, T,
                                       kf_intensity=kf_level.intensity, interp=cfg.interp,
                                       grads=grads, chan=chan)
        if cfg.affine_light:
            # Refit every iteration, as the reference's code does.
            a_fit, b_fit = fit_affine_ab(sys.r, kf_level.intensity, sys.valid)
            vf = sys.valid.to(sys.r.dtype)
            sys = sys._replace(r=sys.r - vf * ((a_fit[:, None] - 1.0) * kf_level.intensity
                                               + b_fit[:, None]))
        w = robust_weights(cfg.robust, sys.r, sys.valid, huber_delta=cfg.huber_delta,
                           tdist_dof=cfg.tdist_dof, tdist_sigma_init=cfg.tdist_sigma_init,
                           batch_dims=1)
        return _normal_equations_points(sys, w)

    return _lm_loop(system, T_init, max_iters, cfg, step_tol)


def _lm_loop(system, T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
             step_tol: float | None = None):
    """Levenberg-Marquardt over `system(T) -> (Point)NormalEqs` for a batch
    of poses T_init (B, 4, 4); returns (T, failed, LevelStats), each leading
    with B. One host read per iteration: ``active.any()``."""
    if step_tol is None:
        step_tol = cfg.step_tol
    dev = T_init.device
    B = T_init.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, **f32)
    inc = current = last = T_init
    err_last = torch.full((B,), 1e10, **f32)
    err_first = torch.zeros((B,), **f32)
    err_final = torch.zeros((B,), **f32)
    lam = torch.full((B,), cfg.lambda_init, **f32)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    it = 0
    going = True
    while going and it < max_iters:
        pose = lambda new, old: torch.where(active[:, None, None], new, old)
        eqs = system(inc)
        no_residuals = eqs.num_valid == 0
        err_now = eqs.err
        bad = err_now > err_last
        lam_up = lam * cfg.lambda_up
        lam_down = torch.clamp(lam / cfg.lambda_down, min=cfg.lambda_min)
        lam_n = torch.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current_n = torch.where(bad[:, None, None], last, inc)
        break_good = (~bad) & (err_now / err_last > cfg.precision)
        act = ~(break_bad | break_good | no_residuals)

        JtWJ = eqs.JtWJ
        A = JtWJ + lam_n[:, None, None] * torch.diag_embed(torch.diagonal(JtWJ, dim1=-2, dim2=-1))
        A = A + 1e-12 * eye6
        delta = solve_spd6(A, -eqs.JtWr)
        delta = torch.where(torch.all(torch.isfinite(delta), dim=-1, keepdim=True), delta,
                            torch.zeros_like(delta))
        inc_n = _compose(_exp(delta), current_n)
        if step_tol > 0:
            act = act & (torch.amax(torch.abs(delta), dim=-1) >= step_tol)

        # Frames that were active take this iteration; the others keep theirs.
        if it == 0:
            err_first = err_now
        current = last = pose(current_n, current)
        inc = pose(inc_n, inc)
        lam = torch.where(active, lam_n, lam)
        err_final = torch.where(active & ~bad, err_now, err_final)
        err_last = torch.where(active & ~bad, err_now, err_last)
        failed = failed | (active & no_residuals)
        iters = iters + active.to(torch.int32)
        active = active & act
        it += 1
        with span("read.lm_active"):
            going = bool(active.any())
    return current, failed, LevelStats(iters, err_first, err_final)


def _coarse_to_fine(solve_level, cfg: TrackerConfig, cam: Pinhole,
                    T: torch.Tensor) -> TrackResult:
    """Run `solve_level(l, cam_l, T, max_iters, step_tol)` coarsest level
    first, chaining the poses (B, 4, 4); a level that found no residuals
    fails a frame's solve and its result is identity
    (``lm_optimizer.cpp:54-69``)."""
    num_levels = cfg.num_levels
    cams = intrinsic_pyramid(cam, num_levels)
    dev = T.device
    failed = torch.zeros(T.shape[:-2], dtype=torch.bool, device=dev)
    stats = []
    for l in range(num_levels - 1, -1, -1):
        tol = cfg.step_tol if l == 0 else max(cfg.step_tol, cfg.coarse_step_tol)
        T, failed_l, st = solve_level(l, cams[l], T, cfg.max_iterations[l], tol)
        failed = failed | failed_l
        stats.append(st)
    ok = ~failed
    T_out = torch.where(ok[:, None, None], T, se3_identity(dtype=T.dtype, device=dev))
    return TrackResult(T_out, ok, tuple(stats))


def _initial_pose(pyr_cur, T_init):
    if T_init is not None:
        return T_init
    return se3_identity(batch=pyr_cur[0].shape[:-2], device=pyr_cur[0].device)


def solve_pose(pyr_kf: Sequence[torch.Tensor], dpyr_kf: Sequence[torch.Tensor],
               pyr_cur: Sequence[torch.Tensor], cam: Pinhole, cfg: TrackerConfig,
               T_init: torch.Tensor | None = None) -> TrackResult:
    """Dense engine: track the current frame against the keyframe's image and
    inverse-depth pyramids, coarsest level first (``lm_optimizer.cpp:54-160``).
    Levels (H, W) track one frame, (B, H, W) a batch (T_init (B, 4, 4))."""
    T = _initial_pose(pyr_cur, T_init)
    if pyr_cur[0].dim() == 2:
        return lane(solve_pose(*batch_of_one((pyr_kf, dpyr_kf, pyr_cur)), cam, cfg, T[None]), 0)
    with span("tracker.solve"):
        return _coarse_to_fine(
            lambda l, cam_l, T_, iters, tol: _solve_level(pyr_kf[l], dpyr_kf[l], pyr_cur[l],
                                                           cam_l, T_, iters, cfg, tol),
            cfg, cam, T)


def solve_pose_points(kf_levels: Tuple[KeyframeLevel, ...], pyr_cur: Sequence[torch.Tensor],
                      cam: Pinhole, cfg: TrackerConfig,
                      T_init: torch.Tensor | None = None) -> TrackResult:
    """Track the current frame against the prepared keyframe point lists,
    coarsest level first (``lm_optimizer.cpp:54-160``). Levels (H, W) track
    one frame, (B, H, W) a batch (point lists (B, cap), T_init (B, 4, 4))."""
    T = _initial_pose(pyr_cur, T_init)
    if pyr_cur[0].dim() == 2:
        return lane(solve_pose_points(*batch_of_one((kf_levels, pyr_cur)), cam, cfg, T[None]),
                    0)
    with span("tracker.solve"):
        return _coarse_to_fine(
            lambda l, cam_l, T_, iters, tol: _solve_level_points(kf_levels[l], pyr_cur[l],
                                                                  cam_l, T_, iters, cfg, tol),
            cfg, cam, T)
