"""Depth-frontend accuracy against the exact ground truth on sweep scenes,
through the port (counterpart of ``tools/diag_depth.py``).

For each seed: render frame 0 of the sweep trajectory, run
``compute_depth``, and compare the refined inverse depth with the render's
z on valid pixels (0.1 m < z < 100 m). Reports the disparity-error
quantiles and the signed bias, the quantity that displaces the photometric
minimum when it is not zero.

Run on the card::

    python -m odometry_torch.tools.diag_depth [plane|driving|textured] [fast|accurate] [seeds...]

on the CPU (tests): add ``--device cpu --height 96 --width 320``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from odometry_torch.config import PipelineConfig, at_size
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.tools.accuracy_sweep import CONFIGS, FAMILIES, SEEDS
from odometry_torch.tools.diag_divergence import render_family


def depth_frame(cfg: PipelineConfig, scene: str, seed: int, *, device="cuda"):
    """(left, right, z) of frame 0 of the sweep trajectory, on `device`
    (trajectories share their first poses, so frame 0 of one frame is the
    reference tool's frame 0 of two)."""
    return render_family(scene, seed, cfg, 1, device=device)[1][0]


def disparity_errors(res, z, cfg: PipelineConfig):
    """(mask of the compared pixels, ground-truth disparity there, estimated
    minus ground-truth disparity there) of a DepthResult against the
    render's z, in pixels."""
    fxb = cfg.camera.fx * cfg.camera.baseline
    zgt = z.cpu().numpy()
    m = res.valid.cpu().numpy() & (zgt > 0.1) & (zgt < 100.0)
    d_gt = fxb / zgt[m]
    return m, d_gt, res.inv_depth.cpu().numpy()[m] * fxb - d_gt


def depth_stats(cfg: PipelineConfig, scene: str, seed: int, *, device="cuda") -> dict:
    """n (compared pixels), survivors (``num_valid``), the median
    ground-truth disparity, |error| p50/p90/p99, the signed bias and the
    fraction above 1 px, of frame 0's depth."""
    left, right, z = depth_frame(cfg, scene, seed, device=device)
    res = compute_depth(left, right, cfg.camera, cfg.depth)
    m, d_gt, derr = disparity_errors(res, z, cfg)
    q = np.percentile(np.abs(derr), [50, 90, 99])
    return dict(n=int(m.sum()), survivors=int(res.num_valid), disp_gt_med=float(np.median(d_gt)),
                p50=float(q[0]), p90=float(q[1]), p99=float(q[2]), bias=float(np.mean(derr)),
                frac1=float((np.abs(derr) > 1).mean()))


def format_stats(cfg_name: str, scene: str, seed: int, s: dict) -> str:
    """The reference tool's line."""
    return (f"{cfg_name}/{scene} seed {seed:3d}: n {s['n']:6d} "
            f"disp_gt med {s['disp_gt_med']:5.2f}px  |err| p50 {s['p50']:6.3f} "
            f"p90 {s['p90']:6.3f} p99 {s['p99']:6.3f}px  bias {s['bias']:+7.4f}px "
            f"frac>1px {s['frac1']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="plane", choices=FAMILIES)
    ap.add_argument("config", nargs="?", default="fast", choices=list(CONFIGS))
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = at_size(CONFIGS[args.config](), args.height, args.width)
    for seed in args.seeds or SEEDS:
        s = depth_stats(cfg, args.scene, seed, device=args.device)
        print(format_stats(args.config, args.scene, seed, s), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
