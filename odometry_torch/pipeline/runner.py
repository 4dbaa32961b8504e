"""Host-side sequence runner (port of ``pipeline/runner.py``; reference
``run_odometry_kitti_offline.cpp:198-282``): feed frames, collect the
trajectory, stop on depth failure.

Frames arrive as numpy arrays or tensors and are moved to `device`
explicitly; each frame makes ONE host read, of the packed
``StepOutput.summary``. Checkpoint/resume and the debug-checked step are not
ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from odometry_torch.config import PipelineConfig
from odometry_torch.device import resolve_device
from odometry_torch.pipeline.odometry import StepOutput, init, step
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
                 device) -> RunResult:
    """Run odometry over an iterable of (left, right) float32 image pairs on
    `device`. The first pair initializes (pose `init_pose` or identity)."""
    if checkpoint_path is not None or resume or debug_checks:
        raise NotImplementedError(
            "checkpoint/resume and debug_checks are not ported yet (ROADMAP A9)")
    dev = resolve_device(device)
    if timer is None:
        timer = StageTimer()
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    it: Iterator = iter(frames)
    with timer.stage("io"):
        left0, right0 = next(it)

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
    if collect_vis:
        vis.append((np.asarray(left0, np.float32), state.kf_dpyr[0].cpu().numpy(),
                    state.kf_valid.cpu().numpy()))

    # With relocalization on, a depth failure is handled by the policy.
    stop_on_depth_failure = stop_on_depth_failure and not cfg.keyframe.relocalize
    t_start = time.perf_counter()
    for frame_id, (left, right) in enumerate(it, start=1):
        t0 = time.perf_counter()
        with timer.stage("io"):
            left_d, right_d = to_dev(left), to_dev(right)
        with timer.stage("step"):
            state, out = step(state, left_d, right_d, cfg)
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
        if not summ[34] > 0.5:  # depth_ok
            if failed_at is None:
                failed_at = frame_id
            if stop_on_depth_failure:
                break
    total = time.perf_counter() - t_start
    n = len(poses)
    return RunResult(
        poses=np.stack(poses),
        keyframe_ids=keyframe_ids,
        num_frames=n,
        failed_at=failed_at,
        fps=(n - 1) / total if n > 1 else 0.0,
        per_frame_ms=times,
        lost_ids=lost_ids,
        stage_report=timer.report(),
        vis=vis,
    )
