"""Which fast_config knob costs the multi-seed robustness? A one-knob bisect
through the port on the sweep's failing cases, plane seed 11 and driving
seed 4, 49 frames each (counterpart of ``tools/bisect_fast_robustness.py``,
which runs at import; here the work is in functions).

Run on the card::

    python -m odometry_torch.tools.bisect_fast_robustness

on the CPU (tests): add ``--device cpu --height 96 --width 320 --frames 6``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools.accuracy_sweep import NUM_FRAMES
from odometry_torch.tools.diag_divergence import render_family

CASES = [("plane11", "plane", 11), ("drive4", "driving", 4)]
VARIANTS = [
    ("fast(asis)", lambda c: c),
    ("tracker-bilinear", lambda c: dataclasses.replace(
        c, tracker=dataclasses.replace(c.tracker, interp="bilinear"))),
    ("no-step-tol", lambda c: dataclasses.replace(
        c, tracker=dataclasses.replace(c.tracker, step_tol=0.0))),
    ("caps-8k-16k", lambda c: dataclasses.replace(
        c, tracker=dataclasses.replace(c.tracker, point_capacity=8192),
        depth=dataclasses.replace(c.depth, max_residuals=16384))),
    ("depth-bilinear", lambda c: dataclasses.replace(
        c, depth=dataclasses.replace(c.depth, interp="bilinear"))),
    ("eager-depth", lambda c: dataclasses.replace(c, depth_every_frame=True)),
]


def bisect(base: PipelineConfig, variants=VARIANTS, cases=CASES,
           num_frames: int = NUM_FRAMES, *, device="cuda", log=print) -> list[dict]:
    """One row per (variant, case): mte, keyframes, lost and the RunResult,
    or the error of a failed init (``error``); each case's frames rendered
    once. Logs the reference tool's line for each."""
    frames = {}
    for cname, scene, seed in cases:
        poses, rendered = render_family(scene, seed, base, num_frames, device=device)
        frames[cname] = (poses, [f[:2] for f in rendered])
    rows = []
    for vname, mod in variants:
        cfg = mod(base)
        for cname, _, _ in cases:
            poses, fr = frames[cname]
            try:
                res = run_sequence(fr, cfg, device=device)
            except RuntimeError as e:  # the init frame's depth failed
                rows.append(dict(variant=vname, case=cname, error=str(e)))
                log(f"{vname:18s} {cname:8s}: {e}")
                continue
            mte = float(mean_translation_error(poses[: res.num_frames], res.poses))
            rows.append(dict(variant=vname, case=cname, error=None, mte=mte, result=res,
                             keyframes=len(res.keyframe_ids), lost=len(res.lost_ids)))
            log(f"{vname:18s} {cname:8s}: mte {mte:7.4f} kf {len(res.keyframe_ids)} "
                f"lost {len(res.lost_ids)}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    args = ap.parse_args(argv)
    base = at_size(fast_config(), args.height, args.width)
    bisect(base, num_frames=args.frames, device=args.device,
           log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
