"""The odometry pipeline: init + per-frame step with the keyframe policy
(port of ``pipeline/odometry.py``; reference ``run_odometry_kitti_offline.cpp:
94-271``).

Pose is tracked frame-to-KEYFRAME and chained through the keyframe's
absolute pose; a frame becomes a keyframe when its weighted motion exceeds
the threshold (or relocalization asks for it) and its depth is healthy.

Batches: :func:`init_batch` and :func:`step_batch` advance a batch of B
sequences at once, the counterpart of the reference's ``jax.vmap(init)`` and
``jax.vmap(step)``: every tensor of the state leads with B, one step is one
stream of launches for the batch (one SSD kernel launch per batched depth
run, one host read per LM iteration), and each sequence's results are those
of stepping it alone, to the float32 rounding of the batched pose and
normal-equation products. :func:`init` and :func:`step` are the batch of
one, with the unbatched products (``utils/batch.py:one_lane_unbatched``).

Lazy depth (``depth_every_frame=False``): the reference's ``lax.cond`` on the
keyframe candidate flag, which ``vmap`` turns into a select that runs depth
for every sequence of the batch, becomes one host read of the candidate mask
per step: depth runs only on the candidate sequences, gathered as one
sub-batch, and its products are scattered back. A skipped sequence reports
zero-filled depth products of the same shapes and ``ok=True``. The results
are the select's; the work is less.

Two tracking engines, as in the reference: ``engine="points"`` tracks
against point lists extracted once per keyframe (``kf_track``), and
``engine="dense"`` against every pixel of the keyframe pyramids
(``kf_track=()``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig
from odometry_torch.depth.estimator import DepthResult, compute_depth
from odometry_torch.device import resolve_device
from odometry_torch.geometry import rotation_angles_xyz, se3_compose, se3_identity, se3_inverse
from odometry_torch.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_torch.tracking.tracker import (
    TrackResult,
    prepare_keyframe,
    solve_pose,
    solve_pose_points,
)
from odometry_torch.utils.batch import batch_of_one, lane, one_lane_unbatched, tree_map
from odometry_torch.utils.profiling import span

# Pose products; a batch of one takes the unbatched kernels, so one
# sequence's step rounds as the unbatched code does (utils/batch.py).
_compose = one_lane_unbatched(se3_compose)
_inverse = one_lane_unbatched(se3_inverse)

# Depth-frontend runs of the steps (inits not counted) and the sequences they
# ran on: one per batched run and its B, or one per lazy sub-batch and its
# size.
DEPTH_RUNS = 0
DEPTH_LANES = 0


@dataclasses.dataclass(frozen=True)
class OdometryState:
    """Everything carried frame to frame; fixed shapes, one device. A batch
    of sequences leads every tensor with B (``frame_id``, ``kf_count`` and
    ``lost_streak`` become (B,))."""

    kf_pyr: Tuple[torch.Tensor, ...]  # keyframe image pyramid (level 0 first)
    kf_dpyr: Tuple[torch.Tensor, ...]  # keyframe inverse-depth pyramid
    kf_track: tuple  # engine="points": per-level KeyframeLevel; else ()
    kf_valid: torch.Tensor  # (H, W) keyframe depth validity mask
    kf_pose: torch.Tensor  # (4, 4) keyframe absolute pose (cam-to-world)
    pose_init: torch.Tensor  # (4, 4) tracker warm start
    cur_pose: torch.Tensor  # (4, 4) current absolute pose
    prev_rel: torch.Tensor  # (4, 4) last frame-to-frame motion
    frame_id: torch.Tensor  # int32
    kf_count: torch.Tensor  # int32 number of keyframes so far
    healthy: torch.Tensor  # bool: last depth frame succeeded
    lost_streak: torch.Tensor  # int32 consecutive lost frames


class StepOutput(NamedTuple):
    """One frame's; a batch leads every field with B."""

    cur_pose: torch.Tensor  # (4, 4) absolute pose of this frame
    pose_to_kf: torch.Tensor  # (4, 4) tracker output (kf-cam -> cur-cam)
    promoted: torch.Tensor  # bool: this frame became the new keyframe
    motion: torch.Tensor  # weighted motion magnitude
    track_ok: torch.Tensor  # bool
    depth_ok: torch.Tensor  # bool
    num_valid_depth: torch.Tensor  # int32
    track_stats: tuple  # per-level LevelStats (coarsest first)
    lost: torch.Tensor  # bool: tracking-lost criterion fired this frame
    inv_depth: torch.Tensor  # (H, W) float32, zero-filled when depth was skipped
    valid: torch.Tensor  # (H, W) bool
    # (39,) float32 packed host summary, read once per frame: [0:16] cur_pose,
    # [16:32] new keyframe pose, [32] promoted, [33] lost, [34] depth_ok,
    # [35] track_ok, [36] motion, [37] num_valid_depth, [38] finest-level
    # final cost.
    summary: torch.Tensor


def _cam(cfg: PipelineConfig) -> Pinhole:
    c = cfg.camera
    return Pinhole.create(c.fx, c.fy, c.cx, c.cy)


def _keyframe_track(pyr, dpyr, cfg: PipelineConfig) -> tuple:
    """The point engine's per-level point lists (of each keyframe of a
    batch); () for the dense engine."""
    if cfg.tracker.engine == "points":
        return prepare_keyframe(pyr, dpyr, cfg.tracker)
    return ()


def init_batch(left_b, right_b, cfg: PipelineConfig, init_pose=None, *,
               device="cuda") -> tuple[OdometryState, torch.Tensor]:
    """Initialize a batch of B sequences from their first frames on `device`
    (the card unless the caller asks for the CPU; raises without one);
    returns (state, depth_ok (B,)).

    `left_b`/`right_b` are (B, H, W) images (numpy or tensors), moved to
    `device`; `init_pose` is one (4, 4) pose for every sequence or (B, 4, 4).
    One depth run (one SSD kernel launch) for the batch. The span
    ``pipeline.init_batch``.
    """
    with span("pipeline.init_batch"):
        dev = resolve_device(device)
        left = torch.as_tensor(left_b, dtype=torch.float32, device=dev)
        right = torch.as_tensor(right_b, dtype=torch.float32, device=dev)
        B = left.shape[0]
        n = cfg.tracker.num_levels
        dres = compute_depth(left, right, cfg.camera, cfg.depth)
        pyr = gaussian_image_pyramid(left, n, smooth=True)
        dpyr = depth_pyramid(dres.inv_depth, n, indexing=cfg.tracker.depth_decimation)
        i32 = dict(dtype=torch.int32, device=dev)
        pose0 = (se3_identity((B,), device=dev) if init_pose is None
                 else torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
                 .expand(B, 4, 4).clone())
        state = OdometryState(
            kf_pyr=pyr,
            kf_dpyr=dpyr,
            kf_track=_keyframe_track(pyr, dpyr, cfg),
            kf_valid=dres.valid,
            kf_pose=pose0,
            pose_init=se3_identity((B,), device=dev),
            cur_pose=pose0,
            prev_rel=se3_identity((B,), device=dev),
            frame_id=torch.zeros(B, **i32),
            kf_count=torch.ones(B, **i32),
            healthy=dres.ok,
            lost_streak=torch.zeros(B, **i32),
        )
        return state, dres.ok


def init(left, right, cfg: PipelineConfig, init_pose=None, *,
         device="cuda") -> tuple[OdometryState, torch.Tensor]:
    """Initialize from frame 0 on `device` (the card unless the caller asks
    for the CPU; raises without one); returns (state, depth_ok).

    `left`/`right` are (H, W) images (numpy or tensors), moved to `device`.
    The batch of one of :func:`init_batch`.
    """
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
    pose = None if init_pose is None else t(init_pose)
    return lane(init_batch(t(left), t(right), cfg, pose, device=dev), 0)


def _zero_depth(state: OdometryState, B: int, H: int, W: int):
    """The skip branch's products for B sequences: (DepthResult, depth
    pyramid, point lists) of zeros, ``ok`` True."""
    dev = state.cur_pose.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    dres = DepthResult(
        valid=torch.zeros((B, H, W), dtype=torch.bool, device=dev),
        disparity=torch.zeros((B, H, W), **f32),
        inv_depth=torch.zeros((B, H, W), **f32),
        ok=torch.ones(B, dtype=torch.bool, device=dev),
        num_valid=torch.zeros(B, **i32),
        iters=torch.zeros(B, **i32),
        cost=torch.zeros(B, **f32),
    )
    zeros = lambda tree: tree_map(torch.zeros_like, tree)
    return dres, zeros(state.kf_dpyr), zeros(state.kf_track)


def _depth_products(state: OdometryState, pyr_cur, left, right, candidate,
                    cfg: PipelineConfig):
    """(DepthResult, depth pyramid, point lists) of this frame for every
    sequence of the batch. Depth runs on every sequence with
    ``depth_every_frame``; else on the candidate sequences only, gathered as
    one sub-batch (the step's one read of the candidate mask, the span
    ``read.depth_candidates``), and the others get the skip branch's zeros.
    Counts each run in ``DEPTH_RUNS`` and its sequences in ``DEPTH_LANES``."""
    n = cfg.tracker.num_levels
    B, H, W = left.shape

    def run(idx):
        global DEPTH_RUNS, DEPTH_LANES
        DEPTH_RUNS += 1
        DEPTH_LANES += B if idx is None else idx.numel()
        take = (lambda t: t) if idx is None else (lambda t: t.index_select(0, idx))
        dres = compute_depth(take(left), take(right), cfg.camera, cfg.depth)
        dpyr = depth_pyramid(dres.inv_depth, n, indexing=cfg.tracker.depth_decimation)
        return dres, dpyr, _keyframe_track(tuple(map(take, pyr_cur)), dpyr, cfg)

    if cfg.depth_every_frame:
        return run(None)
    with span("read.depth_candidates"):
        cand = candidate.cpu()
        every, some = bool(cand.all()), bool(cand.any())
    if every:
        return run(None)
    zeros = _zero_depth(state, B, H, W)
    if not some:
        return zeros
    idx = torch.nonzero(cand).reshape(-1).to(left.device)
    return tree_map(lambda z, v: z.index_copy(0, idx, v), zeros, run(idx))


def step_batch(state: OdometryState, left: torch.Tensor, right: torch.Tensor,
               cfg: PipelineConfig) -> tuple[OdometryState, StepOutput]:
    """One full odometry frame of every sequence of a batch
    (``run_odometry_kitti_offline.cpp:198-271``): `left`/`right` are
    (B, H, W) on the state's device. Each sequence's results are those of
    :func:`step` on it alone, to float32 rounding (see the module
    docstring). The span ``pipeline.step_batch``."""
    with span("pipeline.step_batch"):
        return _step_batch(state, left, right, cfg)


def _step_batch(state: OdometryState, left: torch.Tensor, right: torch.Tensor,
                cfg: PipelineConfig) -> tuple[OdometryState, StepOutput]:
    """:func:`step_batch`'s body."""
    n = cfg.tracker.num_levels
    cam = _cam(cfg)
    dev = state.cur_pose.device
    B = left.shape[0]

    def each(mask, t):
        """`mask` (B,) broadcast over the trailing axes of `t`."""
        return mask.reshape((B,) + (1,) * (t.dim() - 1))

    pyr_cur = gaussian_image_pyramid(left, n, smooth=True)
    if cfg.tracker.engine == "points":
        track: TrackResult = solve_pose_points(state.kf_track, pyr_cur, cam, cfg.tracker,
                                               state.pose_init)
    else:
        track = solve_pose(state.kf_pyr, state.kf_dpyr, pyr_cur, cam, cfg.tracker,
                           state.pose_init)
    cur_pose = _compose(state.kf_pose, _inverse(track.T))

    # Keyframe criterion (:254-258): [|angX|, |angY|, |angZ|, |tx|, |ty|, |tz|] . w
    angles = torch.abs(rotation_angles_xyz(track.T[:, :3, :3]))
    trans = torch.abs(track.T[:, :3, 3])
    motion_vec = torch.cat([angles, trans], dim=-1)
    weights = torch.tensor(cfg.keyframe.weights, dtype=torch.float32, device=dev)
    motion_mag = one_lane_unbatched(lambda v: v @ weights)(motion_vec)
    candidate = motion_mag > cfg.keyframe.motion_threshold

    kcfg = cfg.keyframe
    lost = ~track.ok
    if kcfg.lost_cost_threshold > 0:
        lost = lost | (track.stats[-1].err_final > kcfg.lost_cost_threshold)
    if kcfg.lost_motion_threshold > 0:
        lost = lost | (motion_mag > kcfg.lost_motion_threshold)
    streak = torch.where(lost, state.lost_streak + 1, torch.zeros_like(state.lost_streak))
    if kcfg.relocalize:
        cur_pose = torch.where(each(lost, cur_pose), state.cur_pose, cur_pose)
        candidate = candidate | (lost & (streak >= kcfg.relocalize_patience))

    dres, dpyr_cur, track_cur = _depth_products(state, pyr_cur, left, right, candidate, cfg)
    promote = candidate & dres.ok

    def sel(new, old):
        return tree_map(lambda a, b: torch.where(each(promote, a), a, b), new, old)

    kf_pose_new = sel(cur_pose, state.kf_pose)
    rel = _compose(_inverse(state.cur_pose), cur_pose)
    prev_rel = torch.where(each(lost, rel), state.prev_rel, rel) if kcfg.relocalize else rel

    if cfg.tracker.warm_start == "constant_velocity":
        pose_init = _compose(_inverse(prev_rel), _compose(_inverse(cur_pose), kf_pose_new))
    else:
        pose_init = track.T
        if kcfg.reset_on_promote:
            pose_init = torch.where(each(promote, pose_init), se3_identity(device=dev),
                                    pose_init)
        if kcfg.relocalize:
            held_init = _compose(_inverse(cur_pose), kf_pose_new)
            pose_init = torch.where(each(lost, pose_init), held_init, pose_init)

    new_state = OdometryState(
        kf_pyr=sel(pyr_cur, state.kf_pyr),
        kf_dpyr=sel(dpyr_cur, state.kf_dpyr),
        kf_track=sel(track_cur, state.kf_track),
        kf_valid=sel(dres.valid, state.kf_valid),
        kf_pose=kf_pose_new,
        pose_init=pose_init,
        cur_pose=cur_pose,
        prev_rel=prev_rel,
        frame_id=state.frame_id + 1,
        kf_count=state.kf_count + promote.to(torch.int32),
        healthy=dres.ok,
        lost_streak=streak,
    )
    f32 = torch.float32
    summary = torch.cat([
        cur_pose.reshape(B, 16).to(f32),
        kf_pose_new.reshape(B, 16).to(f32),
        torch.stack([
            promote.to(f32),
            lost.to(f32),
            dres.ok.to(f32),
            track.ok.to(f32),
            motion_mag.to(f32),
            dres.num_valid.to(f32),
            track.stats[-1].err_final.to(f32),
        ], dim=-1),
    ], dim=-1)
    out = StepOutput(
        cur_pose=cur_pose,
        pose_to_kf=track.T,
        promoted=promote,
        motion=motion_mag,
        track_ok=track.ok,
        depth_ok=dres.ok,
        num_valid_depth=dres.num_valid,
        track_stats=track.stats,
        lost=lost,
        inv_depth=dres.inv_depth,
        valid=dres.valid,
        summary=summary,
    )
    return new_state, out


def step(state: OdometryState, left: torch.Tensor, right: torch.Tensor,
         cfg: PipelineConfig) -> tuple[OdometryState, StepOutput]:
    """One full odometry frame (``run_odometry_kitti_offline.cpp:198-271``).
    `left`/`right` are (H, W) on the state's device. The batch of one of
    :func:`step_batch`."""
    return lane(step_batch(batch_of_one(state), left[None], right[None], cfg), 0)
