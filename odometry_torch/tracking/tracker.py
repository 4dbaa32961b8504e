"""Coarse-to-fine direct photometric SE(3) tracker, point engine (port of
``tracking/tracker.py``; reference ``lm_optimizer.cpp:54-160``).

The per-level LM ``lax.while_loop`` becomes a Python loop that reads the
``active`` flag on the host once per iteration and stops when it clears, so
the carry is frozen exactly where the reference's loop exits and
``LevelStats.iters`` counts the same iterations. The lambda schedule is the
reference's:

* err_now > err_last -> lambda *= 5, bail out when lambda would exceed 1e5,
  roll back to the last good pose;
* else -> accept, stop when err_now/err_last > precision,
  lambda = max(lambda/5, 1e-5);
* always solve (JtWJ + lambda diag(JtWJ)) delta = -JtWr and retry from
  exp(delta) @ current.

The dense ``solve_pose`` (``kernels/photometric.py``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from odometry_torch.camera.pinhole import Pinhole, intrinsic_pyramid
from odometry_torch.config import TrackerConfig
from odometry_torch.geometry import se3_compose, se3_exp, se3_identity
from odometry_torch.image.pyramid import central_gradients
from odometry_torch.image.sampling import clip_gather_2d
from odometry_torch.kernels.points import (
    PointSet,
    depth_point_pyramid,
    fit_affine_ab,
    normal_equations_points,
    residual_jacobian_points,
)
from odometry_torch.solvers.linear6 import solve_spd6
from odometry_torch.solvers.robust import robust_weights


class LevelStats(NamedTuple):
    iters: torch.Tensor  # int32: LM iterations run
    err_first: torch.Tensor  # cost at first evaluation
    err_final: torch.Tensor  # final accepted cost


class TrackResult(NamedTuple):
    T: torch.Tensor  # (4, 4) keyframe-cam -> current-cam
    ok: torch.Tensor  # bool: False == the reference's "Optimize failed" identity path
    stats: Tuple[LevelStats, ...]  # per level, coarsest first


class KeyframeLevel(NamedTuple):
    """Per-level sparse tracking data, prepared once per keyframe."""

    pts: PointSet
    intensity: torch.Tensor  # keyframe image value at each point (cap,)


def prepare_keyframe(pyr_kf: Sequence[torch.Tensor], dpyr_kf: Sequence[torch.Tensor],
                     cfg: TrackerConfig) -> Tuple[KeyframeLevel, ...]:
    """Extract valid-depth pixels of every level into capacity-bounded lists."""
    ppyr = depth_point_pyramid(dpyr_kf, cfg.boundary, cfg.min_inv_depth_valid,
                               cfg.point_capacity, order=cfg.point_order)
    return tuple(
        KeyframeLevel(pts, clip_gather_2d(pyr_kf[l], pts.ys.long(), pts.xs.long()))
        for l, pts in enumerate(ppyr)
    )


def _solve_level_points(kf_level: KeyframeLevel, img_cur: torch.Tensor, cam_l: Pinhole,
                        T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
                        step_tol: float | None = None):
    grads = central_gradients(img_cur)
    chan = torch.stack([img_cur, grads[0], grads[1]]) if cfg.interp == "mm" else None

    def system(T):
        sys = residual_jacobian_points(kf_level.pts, img_cur, cam_l, T,
                                       kf_intensity=kf_level.intensity, interp=cfg.interp,
                                       grads=grads, chan=chan)
        if cfg.affine_light:
            # Refit every iteration, as the reference's code does.
            a_fit, b_fit = fit_affine_ab(sys.r, kf_level.intensity, sys.valid)
            vf = sys.valid.to(sys.r.dtype)
            sys = sys._replace(r=sys.r - vf * ((a_fit - 1.0) * kf_level.intensity + b_fit))
        w = robust_weights(cfg.robust, sys.r, sys.valid, huber_delta=cfg.huber_delta,
                           tdist_dof=cfg.tdist_dof, tdist_sigma_init=cfg.tdist_sigma_init)
        return normal_equations_points(sys, w)

    return _lm_loop(system, T_init, max_iters, cfg, step_tol)


def _lm_loop(system, T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
             step_tol: float | None = None):
    """Levenberg-Marquardt over `system(T) -> PointNormalEqs`; returns
    (T, failed, LevelStats)."""
    if step_tol is None:
        step_tol = cfg.step_tol
    dev = T_init.device
    f32 = dict(dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, **f32)
    inc = current = last = T_init
    err_last = torch.tensor(1e10, **f32)
    err_first = torch.tensor(0.0, **f32)
    err_final = torch.tensor(0.0, **f32)
    lam = torch.tensor(cfg.lambda_init, **f32)
    failed = torch.tensor(False, device=dev)
    it = 0
    active = True
    while active and it < max_iters:
        eqs = system(inc)
        no_residuals = eqs.num_valid == 0
        err_now = eqs.err
        bad = err_now > err_last
        lam_up = lam * cfg.lambda_up
        lam_down = torch.clamp(lam / cfg.lambda_down, min=cfg.lambda_min)
        lam = torch.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current = torch.where(bad, last, inc)
        last = current
        break_good = (~bad) & (err_now / err_last > cfg.precision)
        err_first = err_now if it == 0 else err_first
        err_final = torch.where(bad, err_final, err_now)
        err_last = torch.where(bad, err_last, err_now)
        act = ~(break_bad | break_good | no_residuals)

        A = eqs.JtWJ + lam * torch.diag(torch.diag(eqs.JtWJ))
        A = A + 1e-12 * eye6
        delta = solve_spd6(A, -eqs.JtWr)
        delta = torch.where(torch.all(torch.isfinite(delta)), delta, torch.zeros_like(delta))
        inc = se3_compose(se3_exp(delta), current)
        if step_tol > 0:
            act = act & (torch.amax(torch.abs(delta)) >= step_tol)
        failed = failed | no_residuals
        it += 1
        active = bool(act)
    stats = LevelStats(torch.tensor(it, dtype=torch.int32, device=dev), err_first, err_final)
    return current, failed, stats


def solve_pose_points(kf_levels: Tuple[KeyframeLevel, ...], pyr_cur: Sequence[torch.Tensor],
                      cam: Pinhole, cfg: TrackerConfig,
                      T_init: torch.Tensor | None = None) -> TrackResult:
    """Track the current frame against the prepared keyframe point lists,
    coarsest level first (``lm_optimizer.cpp:54-160``)."""
    num_levels = cfg.num_levels
    cams = intrinsic_pyramid(cam, num_levels)
    dev = pyr_cur[0].device
    T = T_init if T_init is not None else se3_identity(device=dev)
    failed = torch.tensor(False, device=dev)
    stats = []
    for l in range(num_levels - 1, -1, -1):
        tol = cfg.step_tol if l == 0 else max(cfg.step_tol, cfg.coarse_step_tol)
        T, failed_l, st = _solve_level_points(kf_levels[l], pyr_cur[l], cams[l], T,
                                              cfg.max_iterations[l], cfg, tol)
        failed = failed | failed_l
        stats.append(st)
    ok = ~failed
    T_out = torch.where(ok, T, se3_identity(dtype=T.dtype, device=dev))
    return TrackResult(T_out, ok, tuple(stats))
