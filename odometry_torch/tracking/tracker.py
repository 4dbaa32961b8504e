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

One iteration is a function of the loop's carry (:func:`_lm_step`). On a
card it is captured once per level and batch shape in a CUDA graph
(:class:`_LMGraph`, cached) and each iteration replays it: the same
operators in the same order, so the same bits, with one graph launch where
the host dispatched some 470 kernels. Each level solve copies its inputs into
the graph's static tensors. The t-distribution's scale loop reads the host,
so with ``robust="tdist"``, as on the CPU, every iteration is dispatched.

The dense engine counts its work: the pixels its systems evaluated
(``DENSE_PX``, on the host), those of them that carried weight (summed on
the device inside the iteration, :func:`dense_weighted`) and its iterations
(``DENSE_ITERS``); each dense level solve is the span
``tracker.dense_level``.
"""

from __future__ import annotations

from collections import OrderedDict
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
from odometry_torch.utils.batch import batch_of_one, lane, one_lane_unbatched, tree_map
from odometry_torch.utils.profiling import capture, span

# The products of the LM loop; a batch of one takes the unbatched kernels, so
# one frame's solve rounds as the unbatched code does (utils/batch.py).
_compose = one_lane_unbatched(se3_compose)
_exp = one_lane_unbatched(se3_exp)
_normal_equations = one_lane_unbatched(normal_equations)
_normal_equations_points = one_lane_unbatched(normal_equations_points)

# Program counters: every LM iteration the host loop ran, those replayed from
# a CUDA graph, and the graphs captured.
LM_ITERS = 0
GRAPH_ITERS = 0
GRAPH_CAPTURES = 0
# The dense engine's: the pixels its systems evaluated (B * H_l * W_l an
# iteration, replayed or dispatched) and its iterations, on the host; the
# pixels that carried weight (every lane's num_valid), an int64 accumulator
# a device, added to inside the iteration so that a replay adds too (read
# with dense_weighted()).
DENSE_PX = 0
DENSE_ITERS = 0
DENSE_WEIGHTED: "dict[torch.device, torch.Tensor]" = {}


def _weighted_acc(device: torch.device) -> torch.Tensor:
    """The dense engine's weighted-pixel accumulator of `device`."""
    acc = DENSE_WEIGHTED.get(device)
    if acc is None:
        acc = DENSE_WEIGHTED[device] = torch.zeros((), dtype=torch.int64, device=device)
    return acc


def dense_weighted() -> int:
    """The pixels of the dense engine's systems that carried weight, over
    every device (one host read a device)."""
    return sum(int(acc) for acc in DENSE_WEIGHTED.values())


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


def _dense_system(T, inputs, cam_l: Pinhole, cfg: TrackerConfig):
    """The dense engine's normal equations at the poses T (B, 4, 4), from
    `inputs` = (keyframe image, keyframe inverse depth, current image), each
    (B, H, W)."""
    img_kf, dep_kf, img_cur = inputs
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
    eqs = _normal_equations(sys, w)
    _weighted_acc(img_kf.device).add_(eqs.num_valid.sum())
    return eqs


def _points_system(T, inputs, cam_l: Pinhole, cfg: TrackerConfig):
    """The point engine's normal equations at the poses T (B, 4, 4), from
    `inputs` = (KeyframeLevel, current image (B, H, W), its gradients (gx,
    gy), the stack [image, gx, gy] (B, 3, H, W)); with "mm" the gradients,
    else the stack, are None."""
    kf_level, img_cur, grads, chan = inputs
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


def _solve_level(img_kf: torch.Tensor, dep_kf: torch.Tensor, img_cur: torch.Tensor,
                 cam_l: Pinhole, T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
                 step_tol: float | None = None):
    """One level of the dense engine for a batch (B, H, W): every pixel of
    the keyframe level, each iteration counted in ``DENSE_PX`` and
    ``DENSE_ITERS``. The span ``tracker.dense_level``."""
    global DENSE_PX, DENSE_ITERS
    with span("tracker.dense_level"):
        iters0 = LM_ITERS
        out = _lm_loop(_dense_system, (img_kf, dep_kf, img_cur), cam_l, T_init, max_iters,
                       cfg, step_tol)
        iters = LM_ITERS - iters0
        DENSE_ITERS += iters
        DENSE_PX += iters * img_kf.numel()
        return out


def _solve_level_points(kf_level: KeyframeLevel, img_cur: torch.Tensor, cam_l: Pinhole,
                        T_init: torch.Tensor, max_iters: int, cfg: TrackerConfig,
                        step_tol: float | None = None):
    """One level of the point engine, of one frame (H, W) or a batch
    (B, H, W); returns (T, failed, LevelStats)."""
    if img_cur.dim() == 2:
        return lane(_solve_level_points(*batch_of_one((kf_level, img_cur)), cam_l,
                                        T_init[None], max_iters, cfg, step_tol), 0)
    grads, chan = central_gradients(img_cur), None
    if cfg.interp == "mm":
        # The "mm" sampler reads the gradients from the stack alone.
        grads, chan = None, torch.stack([img_cur, grads[0], grads[1]], dim=-3)
    return _lm_loop(_points_system, (kf_level, img_cur, grads, chan), cam_l, T_init,
                    max_iters, cfg, step_tol)


class _Carry(NamedTuple):
    """The LM loop's state, each field leading with B. The reference's
    rollback pose ("last") is always the last accepted pose, ``current``."""

    inc: torch.Tensor  # (B, 4, 4) the pose the next system is linearized at
    current: torch.Tensor  # (B, 4, 4) the last accepted pose
    err_last: torch.Tensor  # cost at the last accepted pose
    err_first: torch.Tensor
    err_final: torch.Tensor
    lam: torch.Tensor
    failed: torch.Tensor  # bool: a system had no residuals
    iters: torch.Tensor  # int32: the iterations the lane took
    active: torch.Tensor  # bool: the lane takes the next iteration


def _lm_start(T_init: torch.Tensor, cfg: TrackerConfig) -> _Carry:
    B, dev = T_init.shape[0], T_init.device
    f32 = dict(dtype=torch.float32, device=dev)
    return _Carry(inc=T_init, current=T_init,
                  err_last=torch.full((B,), 1e10, **f32),
                  err_first=torch.zeros((B,), **f32),
                  err_final=torch.zeros((B,), **f32),
                  lam=torch.full((B,), cfg.lambda_init, **f32),
                  failed=torch.zeros((B,), dtype=torch.bool, device=dev),
                  iters=torch.zeros((B,), dtype=torch.int32, device=dev),
                  active=torch.ones((B,), dtype=torch.bool, device=dev))


def _lm_step(system, inputs, cam_l: Pinhole, c: _Carry, cfg: TrackerConfig,
             step_tol: float) -> _Carry:
    """One LM iteration of the batch: the carry after it. Lanes that were
    active take the iteration, the others keep their carry, so an iteration
    after every lane has stopped changes nothing. Reads nothing from the
    host, so a CUDA graph can replay it."""
    pose = lambda new, old: torch.where(c.active[:, None, None], new, old)
    eqs = system(c.inc, inputs, cam_l, cfg)
    no_residuals = eqs.num_valid == 0
    err_now = eqs.err
    bad = err_now > c.err_last
    lam_up = c.lam * cfg.lambda_up
    lam_down = torch.clamp(c.lam / cfg.lambda_down, min=cfg.lambda_min)
    lam_n = torch.where(bad, lam_up, lam_down)
    break_bad = bad & (lam_up > cfg.lambda_max)
    current_n = torch.where(bad[:, None, None], c.current, c.inc)
    break_good = (~bad) & (err_now / c.err_last > cfg.precision)
    act = ~(break_bad | break_good | no_residuals)

    JtWJ = eqs.JtWJ
    A = JtWJ + lam_n[:, None, None] * torch.diag_embed(torch.diagonal(JtWJ, dim1=-2, dim2=-1))
    A = A + 1e-12 * torch.eye(6, dtype=torch.float32, device=JtWJ.device)
    delta = solve_spd6(A, -eqs.JtWr)
    delta = torch.where(torch.all(torch.isfinite(delta), dim=-1, keepdim=True), delta,
                        torch.zeros_like(delta))
    inc_n = _compose(_exp(delta), current_n)
    if step_tol > 0:
        act = act & (torch.amax(torch.abs(delta), dim=-1) >= step_tol)

    # Every lane is active on the first iteration, and only then has taken none.
    accepted = c.active & ~bad
    return _Carry(inc=pose(inc_n, c.inc),
                  current=pose(current_n, c.current),
                  err_last=torch.where(accepted, err_now, c.err_last),
                  err_first=torch.where(c.iters == 0, err_now, c.err_first),
                  err_final=torch.where(accepted, err_now, c.err_final),
                  lam=torch.where(c.active, lam_n, c.lam),
                  failed=c.failed | (c.active & no_residuals),
                  iters=c.iters + c.active.to(torch.int32),
                  active=c.active & act)


class _LMGraph:
    """One LM iteration captured in a CUDA graph, with the static tensors it
    reads and writes: a copy of a level solve's inputs and the carry. Each
    replay advances the carry in place."""

    def __init__(self, system, inputs, cam_l: Pinhole, T_init: torch.Tensor,
                 cfg: TrackerConfig, step_tol: float):
        global GRAPH_CAPTURES
        self.inputs = tree_map(torch.empty_like, inputs)
        self.carry = tree_map(torch.empty_like, _lm_start(T_init, cfg))

        def advance():
            tree_map(torch.Tensor.copy_, self.carry,
                     _lm_step(system, self.inputs, cam_l, self.carry, cfg, step_tol))

        # The capture's warm-up runs on these inputs and advances the carry,
        # which every solve loads afresh (_lm_graph); its iterations are not
        # the loop's, so the weighted-pixel count is put back after it.
        self.load(inputs, T_init, cfg)
        self.device = T_init.device
        weighted = _weighted_acc(self.device)
        kept = weighted.clone()
        with torch.cuda.device(self.device):
            self.graph, _ = capture(advance)
        weighted.copy_(kept)
        GRAPH_CAPTURES += 1

    def load(self, inputs, T_init: torch.Tensor, cfg: TrackerConfig) -> None:
        tree_map(torch.Tensor.copy_, self.inputs, inputs)
        tree_map(torch.Tensor.copy_, self.carry, _lm_start(T_init, cfg))

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


# The captured iterations of each card, least recently used first, keyed by
# everything a replay depends on (_graph_key); at most GRAPH_CACHE_SIZE a
# card, so that a process that tracks many shapes holds a bounded number of
# graphs, and a mesh that steps its cards in turn keeps every card's.
_GRAPHS: "dict[torch.device, OrderedDict[tuple, _LMGraph]]" = {}
GRAPH_CACHE_SIZE = 16


def _graph_key(system, inputs, cam_l: Pinhole, T_init: torch.Tensor, cfg: TrackerConfig,
               step_tol: float) -> tuple:
    """The engine, the level's intrinsics, the configuration, step_tol, and
    the shape, dtype and device of every tensor the iteration reads."""
    sig = []
    tree_map(lambda t: sig.append((tuple(t.shape), t.dtype, t.device)), (inputs, T_init))
    return (system, cam_l, cfg, step_tol, tuple(sig))


def _graphed(T_init: torch.Tensor, cfg: TrackerConfig) -> bool:
    """Whether the iteration replays from a graph: on a card, except with the
    t-distribution, whose scale loop reads the host."""
    return T_init.is_cuda and cfg.robust != "tdist"


def _lm_graph(system, inputs, cam_l: Pinhole, T_init: torch.Tensor, cfg: TrackerConfig,
              step_tol: float) -> _LMGraph:
    """The cached graph of this solve's key, loaded with its inputs; on a
    miss captured, and the card's least recently used dropped past the
    cache's size."""
    key = _graph_key(system, inputs, cam_l, T_init, cfg, step_tol)
    cache = _GRAPHS.setdefault(T_init.device, OrderedDict())
    g = cache.get(key)
    if g is None:
        g = cache[key] = _LMGraph(system, inputs, cam_l, T_init, cfg, step_tol)
        while len(cache) > GRAPH_CACHE_SIZE:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    g.load(inputs, T_init, cfg)
    return g


def _lm_loop(system, inputs, cam_l: Pinhole, T_init: torch.Tensor, max_iters: int,
             cfg: TrackerConfig, step_tol: float | None = None):
    """Levenberg-Marquardt over `system(T, inputs, cam_l, cfg) ->
    (Point)NormalEqs` for a batch of poses T_init (B, 4, 4); returns (T,
    failed, LevelStats), each leading with B. One host read per iteration:
    ``active.any()``. On a card each iteration replays :func:`_lm_step` from
    a CUDA graph (:func:`_graphed`); elsewhere it is dispatched."""
    global LM_ITERS, GRAPH_ITERS
    if step_tol is None:
        step_tol = cfg.step_tol
    graphed = _graphed(T_init, cfg)
    if graphed:
        g = _lm_graph(system, inputs, cam_l, T_init, cfg, step_tol)
        carry, step = g.carry, g.replay
    else:
        carry = _lm_start(T_init, cfg)

        def step():
            nonlocal carry
            carry = _lm_step(system, inputs, cam_l, carry, cfg, step_tol)

    it = 0
    going = True
    while going and it < max_iters:
        step()
        it += 1
        LM_ITERS += 1
        GRAPH_ITERS += graphed
        with span("read.lm_active"):
            going = bool(carry.active.any())
    out = (carry.current, carry.failed, LevelStats(carry.iters, carry.err_first, carry.err_final))
    # A graph's carry is overwritten by its next solve: hand out copies.
    return tree_map(torch.clone, out) if graphed else out


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
