"""The depth frontend's outlier filters (unmatched lanes, refinement drift,
ratio test, block consistency) through the port: the fraction of compared
pixels off by more than 1 px against the survivors, per variant, scene and
seed (counterpart of ``tools/diag_depth_filters.py``).

Frame 0 of each sweep scene (plane and driving, seeds 3, 4, 5, 11, 23) is
rendered once on the run's device and its depth computed per variant of
fast_config's depth configuration.

Run on the card::

    python -m odometry_torch.tools.diag_depth_filters

on the CPU (tests): add ``--device cpu --height 96 --width 320``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.tools.accuracy_sweep import SEEDS
from odometry_torch.tools.diag_depth import depth_frame, disparity_errors

SCENES = ("plane", "driving")
VARIANTS = [
    ("base", dict()),
    ("nounm", dict(refine_unmatched=False)),
    ("shift1.5", dict(refine_max_shift=1.5)),
    ("nounm+s1.5", dict(refine_unmatched=False, refine_max_shift=1.5)),
    ("num+s+r.8", dict(refine_unmatched=False, refine_max_shift=1.5, ratio_test=0.8)),
    ("num+s+blk4", dict(refine_unmatched=False, refine_max_shift=1.5,
                        block_consistency_tol=4.0)),
    ("all", dict(refine_unmatched=False, refine_max_shift=1.5, ratio_test=0.8,
                 block_consistency_tol=4.0)),
]


def filters(base: PipelineConfig, variants=VARIANTS, scenes=SCENES, seeds=SEEDS, *,
            device="cuda") -> list[dict]:
    """One row per (variant, scene): frac1 (per seed; 1.0 where no pixel is
    compared), n (compared pixels per seed), bias (per seed; 0.0 where none)
    and survivors (``num_valid`` per seed)."""
    data = {(s, seed): depth_frame(base, s, seed, device=device)
            for s in scenes for seed in seeds}
    rows = []
    for vname, kw in variants:
        cfg = dataclasses.replace(base, depth=dataclasses.replace(base.depth, **kw))
        for scene in scenes:
            row = dict(variant=vname, scene=scene, frac1=[], n=[], bias=[], survivors=[])
            for seed in seeds:
                left, right, z = data[(scene, seed)]
                res = compute_depth(left, right, cfg.camera, cfg.depth)
                m, _, derr = disparity_errors(res, z, cfg)
                row["frac1"].append(float((np.abs(derr) > 1).mean()) if m.sum() else 1.0)
                row["n"].append(int(m.sum()))
                row["bias"].append(float(np.mean(derr)) if m.sum() else 0.0)
                row["survivors"].append(int(res.num_valid))
            rows.append(row)
    return rows


def format_row(row: dict) -> str:
    """The reference tool's line."""
    return (f"{row['variant']:10s} {row['scene']:8s}: frac>1px "
            + " ".join(f"{f:.3f}" for f in row["frac1"])
            + f"  n {min(row['n'])}-{max(row['n'])}  bias med {np.median(row['bias']):+.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    base = at_size(fast_config(), args.height, args.width)
    for row in filters(base, device=args.device):
        print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
