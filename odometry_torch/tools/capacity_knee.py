"""Accuracy against capacity through the port: mte and frames/s over
fast_config's ``point_capacity`` and ``max_residuals`` (counterpart of
``tools/capacity_knee.py``).

The reference tool measured the knee on bench.py's workload (plane scene 3,
trajectory seed 4, 49 frames, KITTI size) on a TPU v5e and set fast_config's
caps there. This one measures it on the same frames, rendered as
``odometry_torch/tools/bench.py`` renders them, on the card. The presets stay
the reference's: the knee is reported, never written into ``fast_config()``.

Run on the card::

    python -m odometry_torch.tools.capacity_knee

on the CPU (tests): ``--device cpu --height 96 --width 320 --frames 6``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools import bench

CAPS = (2048, 4096, 8192, 16384)
MAX_RESIDUALS = (8192, 16384, 32768)


def measure(cfg: PipelineConfig, frames, poses, *, device="cuda"):
    """(mte, frames/s, RunResult) of `cfg` on `frames`: the mte of one
    ``run_sequence`` (inf, and 0 frames/s, when a depth run failed), then
    bench.py's timed loop."""
    res = run_sequence(frames, cfg, device=device)
    if res.failed_at is not None:
        return float("inf"), 0.0, res
    mte = float(mean_translation_error(poses[: res.num_frames], res.poses))
    fps, _ = bench.timed_fps(cfg, frames, device=device)
    return mte, fps, res


def with_point_capacity(base: PipelineConfig, cap: int) -> PipelineConfig:
    return dataclasses.replace(base, tracker=dataclasses.replace(base.tracker,
                                                                 point_capacity=cap))


def with_max_residuals(base: PipelineConfig, mr: int) -> PipelineConfig:
    return dataclasses.replace(base, depth=dataclasses.replace(base.depth, max_residuals=mr))


def knee(base: PipelineConfig, frames, poses, *, caps=CAPS, max_residuals=MAX_RESIDUALS,
         device="cuda", log=print) -> list[dict]:
    """Both sweeps, printed as the reference prints them; one record per row
    (sweep, value, mte, fps, keyframes, lost)."""
    rows = []

    def row(sweep, value, cfg, label):
        mte, fps, res = measure(cfg, frames, poses, device=device)
        rows.append(dict(sweep=sweep, value=value, mte=mte, fps=fps,
                         keyframes=len(res.keyframe_ids), lost=len(res.lost_ids)))
        log(f"  {label} {value:6d}: mte {mte:7.4f} fps {fps:7.1f} "
            f"kf {len(res.keyframe_ids)} lost {len(res.lost_ids)}")

    log("point_capacity sweep (max_residuals=16384):")
    for cap in caps:
        row("point_capacity", cap, with_point_capacity(base, cap), "cap")
    log("max_residuals sweep (point_capacity=8192):")
    for mr in max_residuals:
        row("max_residuals", mr, with_max_residuals(base, mr), "mr")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--frames", type=int, default=bench.NUM_FRAMES)
    args = ap.parse_args(argv)
    base = at_size(fast_config(), args.height, args.width)
    poses, frames = bench.render_frames(base, bench.TIMED_SEED, args.frames, device=args.device)
    knee(base, frames, poses, device=args.device, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
