"""Full-pipeline frames/s of the port at KITTI size on one card
(counterpart of the repository's ``bench.py``, which stays the reference's).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with the
reference's metric name and its 33.3 frames/s baseline (the reference C++
tracks at ~30 ms/frame on one CPU core, BASELINE.md).

Workload (``bench.py:27-95``): ``fast_config()`` at 376x1241 on
``make_scene(3, depth=14.0)`` rendered with the texture phase rounded as
bench.py's TPU rounded it (``data/synthetic.py:tpu_phase_scene``; on float32
frames both packages miss the gate, ROADMAP C5), along
``drive_trajectory(49, step=0.35)`` for seeds 4, 5 and 11, frames rendered
on the run's device up front. Accuracy gate: the median mean translation
error over the three seeds < 0.15 (raises otherwise). Timed: ``init`` on
seed 4's frame 0, a warm-up of frames 1-3, then frames 1..48 twice through
``pipeline.odometry.step`` with one synchronisation at the end (the
reference times its cached jitted step the same way; nothing is compiled
here).

Run on the card::

    python -m odometry_torch.tools.bench

on the CPU (tests): ``--device cpu --height 96 --width 320 --frames 6``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.data.synthetic import (
    drive_trajectory,
    make_scene,
    render_stereo,
    tpu_phase_scene,
)
from odometry_torch.device import resolve_device
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.pipeline.runner import run_sequence

METRIC = "full_pipeline_frames_per_second_kitti_size_1chip"
SEEDS = (4, 5, 11)
TIMED_SEED = 4
NUM_FRAMES = 49
STEP = 0.35
GATE = 0.15
BASELINE_FPS = 1000.0 / 30.0  # reference tracking-only latency, README.md:80


def depth_runs(summaries) -> int:
    """Steps that ran depth among packed ``StepOutput.summary`` rows: those
    with survivors or a failed depth (init not counted)."""
    if len(summaries) == 0:
        return 0
    s = torch.stack(list(summaries)).cpu().numpy()
    return int(((s[:, 37] > 0) | (s[:, 34] < 0.5)).sum())


def render_frames(cfg: PipelineConfig, seed: int, num_frames: int = NUM_FRAMES, *,
                  device="cuda"):
    """Ground-truth poses and the (left, right) frames of one seed of the
    workload, rendered on `device`."""
    dev = resolve_device(device)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = tpu_phase_scene(make_scene(3, depth=14.0, device=dev))
    poses = drive_trajectory(num_frames, step=STEP, seed=seed)
    frames = [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2] for T in poses]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return poses, frames


def accuracy(cfg: PipelineConfig, runs, *, device="cuda") -> list[dict]:
    """``run_sequence`` on each (seed, poses, frames) of `runs`: one record
    per seed with its RunResult, mte and depth runs (init included). Raises
    when a depth run failed, as bench.py does."""
    records = []
    for seed, poses, frames in runs:
        summaries = []
        res = run_sequence(frames, cfg, device=device,
                           progress=lambda i, out: summaries.append(out.summary))
        if res.failed_at is not None:
            raise RuntimeError(f"depth frontend failed during bench (seed {seed}, frame "
                               f"{res.failed_at})")
        records.append(dict(seed=seed, result=res, depth_runs=1 + depth_runs(summaries),
                            mte=float(mean_translation_error(poses[: res.num_frames],
                                                             res.poses))))
    return records


def check_gate(mtes) -> float:
    """The median of `mtes`; raises unless it is below GATE."""
    med = float(np.median(mtes))
    if not med < GATE:
        raise RuntimeError(f"bench accuracy regression: median mte={med} ({list(mtes)})")
    return med


def timed_fps(cfg: PipelineConfig, frames, *, device="cuda"):
    """bench.py's timed loop: init on frame 0, frames 1-3 as a warm-up, then
    frames 1.. twice with one synchronisation at the end. Returns (frames/s,
    steps timed)."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    state, _ = init(*frames[0], cfg, device=dev)
    for left, right in frames[1:4]:
        state, _ = step(state, left, right, cfg)
    sync()
    n = 0
    t0 = time.perf_counter()
    for _ in range(2):
        for left, right in frames[1:]:
            state, _ = step(state, left, right, cfg)
            n += 1
    sync()
    return n / (time.perf_counter() - t0), n


def result_line(fps: float) -> dict:
    """bench.py's JSON line."""
    return {"metric": METRIC, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3)}


def bench(cfg: PipelineConfig | None = None, *, num_frames: int = NUM_FRAMES,
          device="cuda") -> tuple[dict, list[dict]]:
    """The whole of bench.py: returns (its JSON line, the per-seed records)."""
    cfg = fast_config() if cfg is None else cfg
    runs = [(seed, *render_frames(cfg, seed, num_frames, device=device)) for seed in SEEDS]
    records = accuracy(cfg, runs, device=device)
    check_gate([r["mte"] for r in records])
    frames = next(frames for seed, _, frames in runs if seed == TIMED_SEED)
    fps, _ = timed_fps(cfg, frames, device=device)
    return result_line(fps), records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    args = ap.parse_args(argv)
    cfg = at_size(fast_config(), args.height, args.width)
    line, _ = bench(cfg, num_frames=args.frames, device=args.device)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
