"""``run_slam`` with BA and loop closure on the card (counterpart of
``tools/verify_loop_closure_tpu.py``).

An out-and-back KITTI-sized trajectory on fast_config with
``motion_threshold=0.4`` (a keyframe every ~3-4 frames, so the store holds
enough for a proposal), through ``make_driving_scene(3, side_x=20,
wall_z=26)``: 49 frames, 0.35 m steps, ending at the start. ``run_slam``
runs four times, odometry only (BA every 100 keyframes, no loop closure)
and with BA every 2 keyframes and loop closure, twice each: the first two
are warm-ups (the kernels' build and first launches), the last two are
reported. Prints the reference's JSON line (frames, kf, closures, ba_runs,
end_err_*, ate_*, fps_*), checks its four gates (no depth failure, at
least one closure, a SLAM endpoint error below 0.2 m and no larger than the
odometry's) and prints ``OK``.

Run on the card::

    python -m odometry_torch.tools.verify_loop_closure

on the CPU (tests): ``--device cpu --height 96 --width 320``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.data.synthetic import make_driving_scene, render_stereo
from odometry_torch.device import resolve_device
from odometry_torch.mapping.loop_closure import LoopClosureConfig
from odometry_torch.pipeline.slam import run_slam

N_HALF, STEP = 24, 0.35  # 49 frames, ~17 m travelled, ends at the start
LOOP_CLOSURE = LoopClosureConfig(radius=1.5, min_separation=3, min_inliers=200)


def loop_config(base: PipelineConfig | None = None) -> PipelineConfig:
    """`base` (fast_config) with ``motion_threshold=0.4``."""
    cfg = fast_config() if base is None else base
    return dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe,
                                                                 motion_threshold=0.4))


def loop_trajectory(n_half: int = N_HALF, step: float = STEP) -> list:
    """The out-and-back poses: z = step * k out and back, x = 0.1 sin(0.9 k)."""
    poses = []
    for k in range(2 * n_half + 1):
        z = step * (k if k <= n_half else 2 * n_half - k)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (0.1 * np.sin(0.9 * k), 0.0, z)
        poses.append(T)
    return poses


def loop_frames(cfg: PipelineConfig, poses, *, device="cuda") -> list:
    """The (left, right) frames along `poses`, rendered on `device`."""
    dev = resolve_device(device)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_driving_scene(3, side_x=20.0, wall_z=26.0, device=dev)
    frames = [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2] for T in poses]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return frames


def run_pair(frames, cfg: PipelineConfig, *, device="cuda", progress=None):
    """(odometry only, BA + loop closure) ``run_slam`` results."""
    kw = dict(map_capacity=32, window=4, progress=progress, device=device)
    return (run_slam(frames, cfg, ba_every=100, loop_closure=False, **kw),
            run_slam(frames, cfg, ba_every=2, loop_closure=True, lc_cfg=LOOP_CLOSURE, **kw))


def report(res_odo, res_map, poses) -> dict:
    """The reference tool's JSON line."""
    truth = np.stack(poses)
    end = lambda r: float(np.linalg.norm(r.poses[-1][:3, 3] - truth[-1][:3, 3]))
    ate = lambda r: float(np.mean(np.linalg.norm(r.poses[:, :3, 3] - truth[:, :3, 3], axis=1)))
    return dict(
        frames=res_map.num_frames, kf=len(res_map.keyframe_ids),
        closures=res_map.loop_closures, ba_runs=res_map.ba_runs,
        end_err_odom=round(end(res_odo), 4), end_err_slam=round(end(res_map), 4),
        ate_odom=round(ate(res_odo), 4), ate_slam=round(ate(res_map), 4),
        fps_odom=round(res_odo.fps, 1), fps_slam=round(res_map.fps, 1),
    )


def check(res_odo, res_map, poses) -> None:
    """The reference tool's four gates, on unrounded errors; raises."""
    truth = poses[-1][:3, 3]
    err_odo = float(np.linalg.norm(res_odo.poses[-1][:3, 3] - truth))
    err_map = float(np.linalg.norm(res_map.poses[-1][:3, 3] - truth))
    if res_map.failed_at is not None:
        raise RuntimeError(f"depth failed at frame {res_map.failed_at}")
    if res_map.loop_closures < 1:
        raise RuntimeError("no loop closure fired")
    if not err_map < 0.2:
        raise RuntimeError(f"SLAM endpoint error {err_map} is not below 0.2 m")
    if not err_map <= err_odo + 1e-6:
        raise RuntimeError(f"SLAM endpoint error {err_map} above odometry's {err_odo}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = loop_config(at_size(fast_config(), args.height, args.width))
    poses = loop_trajectory()
    frames = loop_frames(cfg, poses, device=args.device)
    run_pair(frames, cfg, device=args.device)  # warm-up
    res_odo, res_map = run_pair(frames, cfg, device=args.device)
    print(json.dumps(report(res_odo, res_map, poses)))
    check(res_odo, res_map, poses)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
