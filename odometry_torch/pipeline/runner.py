"""Host-side sequence runner (port of ``pipeline/runner.py``; reference
``run_odometry_kitti_offline.cpp:198-282``): feed frames, collect the
trajectory, stop on depth failure.

Frames arrive as numpy arrays or tensors and are moved to `device`
explicitly; each frame makes ONE host read, of the packed
``StepOutput.summary``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from odometry_torch.config import PipelineConfig
from odometry_torch.device import resolve_device
from odometry_torch.pipeline.odometry import StepOutput, init, step
from odometry_torch.utils.checkpoint import load_pytree, save_pytree
from odometry_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class RunResult:
    poses: np.ndarray  # (N, 4, 4) absolute predicted poses
    keyframe_ids: list  # frame indices promoted to keyframe (0 included)
    num_frames: int
    failed_at: Optional[int]  # frame index where depth failed, or None
    fps: float
    per_frame_ms: list
    lost_ids: list = dataclasses.field(default_factory=list)
    stage_report: dict = dataclasses.field(default_factory=dict)
    # (image, inverse_depth, valid) per keyframe when collect_vis was set.
    vis: list = dataclasses.field(default_factory=list)


def run_sequence(frames: Iterable, cfg: PipelineConfig, init_pose: np.ndarray | None = None,
                 stop_on_depth_failure: bool = True,
                 progress: Callable[[int, StepOutput], None] | None = None,
                 timer: StageTimer | None = None, checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 collect_vis: bool = False, debug_checks: bool = False, *,
                 device="cuda") -> RunResult:
    """Run odometry over an iterable of (left, right) float32 image pairs on
    `device` (the card unless the caller asks for the CPU; raises without
    one). The first pair initializes (pose `init_pose` or identity).

    * `timer`: a StageTimer accumulating io / init / step / sync spans (and
      resume / checkpoint); its report lands in RunResult.stage_report.
    * `checkpoint_path` + `checkpoint_every=N`: persist the odometry state and
      trajectory every N frames and at the end (utils.checkpoint, the
      reference's file layout); `resume=True` restarts from that file after
      init, skipping the frames already done.
    * `collect_vis`: keep (image, inverse_depth, valid) per promoted keyframe.
    * `debug_checks`: run the checked step (utils/debug.py): a NaN/Inf input
      or pose estimate raises DebugCheckError naming the frame instead of
      being absorbed. Slower (host reads per frame); for hunts.
    """
    dev = resolve_device(device)
    if timer is None:
        timer = StageTimer()
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    it: Iterator = iter(frames)
    with timer.stage("io"):
        left0, right0 = next(it)

    step_fn = lambda s, l, r: step(s, l, r, cfg)
    if debug_checks:
        from odometry_torch.utils.debug import checked_step

        step_fn = checked_step(cfg)
    with timer.stage("init"):
        state, ok0 = init(to_dev(left0), to_dev(right0), cfg, init_pose, device=dev)
    if not bool(ok0):
        raise RuntimeError("Init 0-th frame failed! (depth frontend)")

    poses = [state.cur_pose.cpu().numpy()]
    keyframe_ids = [0]
    lost_ids = []
    vis = []
    times = []
    failed_at = None
    done_frames = 0
    if collect_vis:
        vis.append((np.asarray(left0, np.float32), state.kf_dpyr[0].cpu().numpy(),
                    state.kf_valid.cpu().numpy()))

    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        with timer.stage("resume"):
            payload = load_pytree(checkpoint_path, _checkpoint_template(state))
            state = payload["state"]
            poses = list(payload["poses"])
            keyframe_ids = [int(v) for v in payload["keyframe_ids"]]
            lost_ids = [int(v) for v in payload["lost_ids"]]
            done_frames = int(payload["frame_id"])

    # With relocalization on, a depth failure is handled by the policy.
    stop_on_depth_failure = stop_on_depth_failure and not cfg.keyframe.relocalize
    t_start = time.perf_counter()
    frame_id = done_frames
    for frame_id, (left, right) in enumerate(it, start=1):
        if frame_id <= done_frames:
            continue  # completed before the resume point
        t0 = time.perf_counter()
        with timer.stage("io"):
            left_d, right_d = to_dev(left), to_dev(right)
        with timer.stage("step"):
            state, out = step_fn(state, left_d, right_d)
        with timer.stage("sync"):
            summ = out.summary.cpu().numpy()  # the frame's one host read
        times.append((time.perf_counter() - t0) * 1e3)
        poses.append(summ[:16].reshape(4, 4))
        if summ[32] > 0.5:  # promoted
            keyframe_ids.append(frame_id)
            if collect_vis:
                vis.append((np.asarray(left, np.float32), out.inv_depth.cpu().numpy(),
                            out.valid.cpu().numpy()))
        if summ[33] > 0.5:  # lost
            lost_ids.append(frame_id)
        if progress is not None:
            progress(frame_id, out)
        if checkpoint_path is not None and checkpoint_every > 0 and (
                frame_id % checkpoint_every == 0):
            with timer.stage("checkpoint"):
                save_pytree(checkpoint_path, _checkpoint_payload(
                    state, poses, keyframe_ids, lost_ids, frame_id))
        if not summ[34] > 0.5:  # depth_ok
            if failed_at is None:
                failed_at = frame_id
            if stop_on_depth_failure:
                break
    total = time.perf_counter() - t_start
    if checkpoint_path is not None and checkpoint_every > 0 and frame_id > done_frames:
        save_pytree(checkpoint_path,
                    _checkpoint_payload(state, poses, keyframe_ids, lost_ids, frame_id))
    n = len(poses)
    return RunResult(
        poses=np.stack(poses),
        keyframe_ids=keyframe_ids,
        num_frames=n,
        failed_at=failed_at,
        fps=(n - 1 - done_frames) / total if n - 1 > done_frames else 0.0,
        per_frame_ms=times,
        lost_ids=lost_ids,
        stage_report=timer.report(),
        vis=vis,
    )


def _checkpoint_payload(state, poses, keyframe_ids, lost_ids, frame_id):
    return {
        "state": state,
        "poses": np.stack(poses),
        "keyframe_ids": np.asarray(keyframe_ids, np.int64),
        "lost_ids": np.asarray(lost_ids, np.int64),
        "frame_id": np.asarray(frame_id, np.int64),
    }


class _AnyShape:
    """A template leaf without a shape: load_pytree takes the file's array."""


def _checkpoint_template(state):
    """Structure template for load_pytree: the state's tensors fix shapes,
    dtypes and the device; the variable-length fields come from the file."""
    return {"state": state, "poses": _AnyShape(), "keyframe_ids": _AnyShape(),
            "lost_ids": _AnyShape(), "frame_id": _AnyShape()}
