"""The odometry pipeline: init + per-frame step with the keyframe policy
(port of ``pipeline/odometry.py``; reference ``run_odometry_kitti_offline.cpp:
94-271``).

Pose is tracked frame-to-KEYFRAME and chained through the keyframe's
absolute pose; a frame becomes a keyframe when its weighted motion exceeds
the threshold (or relocalization asks for it) and its depth is healthy.

Lazy depth (``depth_every_frame=False``): the reference's ``lax.cond`` on the
keyframe candidate flag becomes one host branch per frame. A skipped frame
reports zero-filled depth products of the same shapes and ``ok=True``.

Only the point engine is ported; the dense engine waits for
``kernels/photometric.py``.
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
from odometry_torch.tracking.tracker import TrackResult, prepare_keyframe, solve_pose_points


@dataclasses.dataclass(frozen=True)
class OdometryState:
    """Everything carried frame to frame; fixed shapes, one device."""

    kf_pyr: Tuple[torch.Tensor, ...]  # keyframe image pyramid (level 0 first)
    kf_dpyr: Tuple[torch.Tensor, ...]  # keyframe inverse-depth pyramid
    kf_track: tuple  # per-level KeyframeLevel
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


def _check_engine(cfg: PipelineConfig):
    if cfg.tracker.engine != "points":
        raise NotImplementedError(
            "only the point engine is ported; the dense engine needs "
            "kernels/photometric.py (ROADMAP A8)")


def init(left, right, cfg: PipelineConfig, init_pose=None, *,
         device) -> tuple[OdometryState, torch.Tensor]:
    """Initialize from frame 0 on `device`; returns (state, depth_ok).

    `left`/`right` are (H, W) images (numpy or tensors), moved to `device`.
    """
    _check_engine(cfg)
    dev = resolve_device(device)
    left = torch.as_tensor(left, dtype=torch.float32, device=dev)
    right = torch.as_tensor(right, dtype=torch.float32, device=dev)
    n = cfg.tracker.num_levels
    dres = compute_depth(left, right, cfg.camera, cfg.depth)
    pyr = gaussian_image_pyramid(left, n, smooth=True)
    dpyr = depth_pyramid(dres.inv_depth, n, indexing=cfg.tracker.depth_decimation)
    i32 = dict(dtype=torch.int32, device=dev)
    pose0 = (se3_identity(device=dev) if init_pose is None
             else torch.as_tensor(init_pose, dtype=torch.float32, device=dev))
    state = OdometryState(
        kf_pyr=pyr,
        kf_dpyr=dpyr,
        kf_track=prepare_keyframe(pyr, dpyr, cfg.tracker),
        kf_valid=dres.valid,
        kf_pose=pose0,
        pose_init=se3_identity(device=dev),
        cur_pose=pose0,
        prev_rel=se3_identity(device=dev),
        frame_id=torch.tensor(0, **i32),
        kf_count=torch.tensor(1, **i32),
        healthy=dres.ok,
        lost_streak=torch.tensor(0, **i32),
    )
    return state, dres.ok


def _map(fn, *trees):
    """Apply `fn` leafwise over matching tuples / NamedTuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    out = [_map(fn, *leaves) for leaves in zip(*trees)]
    return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)


def step(state: OdometryState, left: torch.Tensor, right: torch.Tensor,
         cfg: PipelineConfig) -> tuple[OdometryState, StepOutput]:
    """One full odometry frame (``run_odometry_kitti_offline.cpp:198-271``).
    `left`/`right` lie on the state's device."""
    _check_engine(cfg)
    n = cfg.tracker.num_levels
    cam = _cam(cfg)
    dev = state.cur_pose.device

    pyr_cur = gaussian_image_pyramid(left, n, smooth=True)
    track: TrackResult = solve_pose_points(state.kf_track, pyr_cur, cam, cfg.tracker,
                                           state.pose_init)
    cur_pose = se3_compose(state.kf_pose, se3_inverse(track.T))

    # Keyframe criterion (:254-258): [|angX|, |angY|, |angZ|, |tx|, |ty|, |tz|] . w
    angles = torch.abs(rotation_angles_xyz(track.T[:3, :3]))
    trans = torch.abs(track.T[:3, 3])
    motion_vec = torch.cat([angles, trans])
    weights = torch.tensor(cfg.keyframe.weights, dtype=torch.float32, device=dev)
    motion_mag = torch.dot(motion_vec, weights)
    candidate = motion_mag > cfg.keyframe.motion_threshold

    kcfg = cfg.keyframe
    lost = ~track.ok
    if kcfg.lost_cost_threshold > 0:
        lost = lost | (track.stats[-1].err_final > kcfg.lost_cost_threshold)
    if kcfg.lost_motion_threshold > 0:
        lost = lost | (motion_mag > kcfg.lost_motion_threshold)
    streak = torch.where(lost, state.lost_streak + 1, torch.zeros_like(state.lost_streak))
    if kcfg.relocalize:
        cur_pose = torch.where(lost, state.cur_pose, cur_pose)
        candidate = candidate | (lost & (streak >= kcfg.relocalize_patience))

    if cfg.depth_every_frame or bool(candidate):
        dres = compute_depth(left, right, cfg.camera, cfg.depth)
        dpyr_cur = depth_pyramid(dres.inv_depth, n, indexing=cfg.tracker.depth_decimation)
        track_cur = prepare_keyframe(pyr_cur, dpyr_cur, cfg.tracker)
    else:
        # Lazy frontend skipped depth: zero products, healthy by definition.
        zeros = torch.zeros_like
        H, W = left.shape
        dres = DepthResult(
            valid=zeros(state.kf_valid),
            disparity=torch.zeros((H, W), dtype=torch.float32, device=dev),
            inv_depth=torch.zeros((H, W), dtype=torch.float32, device=dev),
            ok=torch.tensor(True, device=dev),
            num_valid=torch.tensor(0, dtype=torch.int32, device=dev),
            iters=torch.tensor(0, dtype=torch.int32, device=dev),
            cost=torch.tensor(0.0, dtype=torch.float32, device=dev),
        )
        dpyr_cur = _map(zeros, state.kf_dpyr)
        track_cur = _map(zeros, state.kf_track)

    promote = candidate & dres.ok

    def sel(new, old):
        return _map(lambda a, b: torch.where(promote, a, b), new, old)

    kf_pose_new = sel(cur_pose, state.kf_pose)
    rel = se3_compose(se3_inverse(state.cur_pose), cur_pose)
    prev_rel = torch.where(lost, state.prev_rel, rel) if kcfg.relocalize else rel

    if cfg.tracker.warm_start == "constant_velocity":
        pose_init = se3_compose(se3_inverse(prev_rel),
                                se3_compose(se3_inverse(cur_pose), kf_pose_new))
    else:
        pose_init = track.T
        if kcfg.reset_on_promote:
            pose_init = torch.where(promote, se3_identity(device=dev), pose_init)
        if kcfg.relocalize:
            held_init = se3_compose(se3_inverse(cur_pose), kf_pose_new)
            pose_init = torch.where(lost, held_init, pose_init)

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
        cur_pose.reshape(-1).to(f32),
        kf_pose_new.reshape(-1).to(f32),
        torch.stack([
            promote.to(f32),
            lost.to(f32),
            dres.ok.to(f32),
            track.ok.to(f32),
            motion_mag.to(f32),
            dres.num_valid.to(f32),
            track.stats[-1].err_final.to(f32),
        ]),
    ])
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
