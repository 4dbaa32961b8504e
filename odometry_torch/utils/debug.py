"""Debug / sanitizer mode (port of ``utils/debug.py``).

The reference wraps its jitted step in ``jax.experimental.checkify`` so a
NaN/Inf input or pose estimate raises a localized error instead of being
absorbed by the pipeline's isfinite guards. PyTorch has no checkify; here
the same checks are explicit, each a host read (as ``err.throw()`` is),
and the error names the frame index:

* the left and right inputs are finite (checked before the step runs);
* the pose estimate is finite (checked after).

Index checks: the port's gathers clamp their indices, as the reference's
do, so an out-of-bounds index cannot arise; none is checked here. The
reference's checkify float checks on every intermediate have no
counterpart either: the checks above are the reference's explicit ones.

Usage::

    step_fn = checked_step(cfg)
    state, out = step_fn(state, left, right)   # raises DebugCheckError

Every check blocks on the device, so the checked step is slower than the
production step; ``run_sequence(debug_checks=True)`` threads it through the
standard runner for whole-sequence hunts.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from odometry_torch.config import PipelineConfig
from odometry_torch.device import resolve_device


class DebugCheckError(RuntimeError):
    """A sanitizer check failed; the message names the check and the frame."""


def _check(ok: torch.Tensor, msg: str, frame: int) -> None:
    if not bool(ok):  # the host read
        raise DebugCheckError(f"{msg} (frame {frame})")


def _check_inputs(left, right, frame: int) -> None:
    _check(torch.isfinite(left).all(), "non-finite LEFT input frame", frame)
    _check(torch.isfinite(right).all(), "non-finite RIGHT input frame", frame)


@functools.cache
def checked_step(cfg: PipelineConfig):
    """``step`` with the input and pose checks: (state, left, right) ->
    (state, out), raising DebugCheckError at the failing frame."""
    from odometry_torch.pipeline.odometry import step

    def run(state, left, right):
        frame = int(state.frame_id) + 1
        _check_inputs(left, right, frame)
        new_state, out = step(state, left, right, cfg)
        _check(torch.isfinite(out.cur_pose).all(), "non-finite pose estimate", frame)
        return new_state, out

    return run


@functools.cache
def checked_init(cfg: PipelineConfig):
    """``init`` with the same checks on frame 0: (left, right, init_pose=None,
    *, device) -> (state, ok)."""
    from odometry_torch.pipeline.odometry import init

    def run(left, right, init_pose=None, *, device="cuda"):
        dev = resolve_device(device)
        left = torch.as_tensor(left, dtype=torch.float32, device=dev)
        right = torch.as_tensor(right, dtype=torch.float32, device=dev)
        _check_inputs(left, right, 0)
        state, ok = init(left, right, cfg, init_pose, device=dev)
        _check(torch.isfinite(state.cur_pose).all(), "non-finite pose estimate", 0)
        return state, ok

    return run


def debug_config(cfg: PipelineConfig) -> PipelineConfig:
    """A configuration variant suited to sanitizer hunts: identical math,
    but every frame pays the depth frontend (lazy-depth skips hide frontend
    NaNs on non-keyframes)."""
    return dataclasses.replace(cfg, depth_every_frame=True)
