"""Decompose the depth frontend's error through the port: the search
winner against the refined value, and where the bad pixels lie
(counterpart of ``tools/diag_depth_decomp.py``).

On frame 0 of a sweep scene, fast_config's ``compute_depth`` against the
render's z: |error| quantiles of the integer search disparity and of the
refined one, how many pixels refinement spoiled, the bad fraction (> 1 px)
by row and column band, and the quantiles of the bad errors.

Run on the card::

    python -m odometry_torch.tools.diag_depth_decomp [plane|driving] [seed]

on the CPU (tests): add ``--device cpu --height 96 --width 320``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.tools.diag_depth import depth_frame, disparity_errors

BANDS = (("rows", 0, 8), ("cols", 1, 10))


def decompose(cfg: PipelineConfig, scene: str = "plane", seed: int = 5, *,
              device="cuda") -> dict:
    """search and refined: |error| p50/p90/p95/p99, frac>1 and frac>5; the
    fractions search-good & refine-bad, search-bad and both-bad; the bad
    fraction per row and column band; the 5/25/50/75/95 quantiles of the
    bad refined errors (empty when none)."""
    left, right, z = depth_frame(cfg, scene, seed, device=device)
    res = compute_depth(left, right, cfg.camera, cfg.depth)
    m, d_gt, e_refined = disparity_errors(res, z, cfg)
    e_search = res.disparity.cpu().numpy()[m] - d_gt
    out = {}
    for name, e in (("search", e_search), ("refined", e_refined)):
        q = np.percentile(np.abs(e), [50, 90, 95, 99])
        out[name] = dict(p50=float(q[0]), p90=float(q[1]), p95=float(q[2]), p99=float(q[3]),
                         frac1=float((np.abs(e) > 1).mean()),
                         frac5=float((np.abs(e) > 5).mean()))
    sg = np.abs(e_search) <= 1
    rb = np.abs(e_refined) > 1
    out.update(search_good_refine_bad=float((sg & rb).mean()), search_bad=float((~sg).mean()),
               both_bad=float(((~sg) & rb).mean()))
    ys, xs = np.nonzero(m)
    for name, axis, nb in BANDS:
        edges = np.linspace(0, m.shape[axis], nb + 1).astype(int)
        pos = ys if axis == 0 else xs
        fr = []
        for i in range(nb):
            sel = (pos >= edges[i]) & (pos < edges[i + 1])
            fr.append(float(rb[sel].mean()) if sel.sum() else 0.0)
        out[f"bad_by_{name}"] = fr
    bad = e_refined[rb]
    out["bad_quantiles"] = ([float(v) for v in np.percentile(bad, [5, 25, 50, 75, 95])]
                            if bad.size else [])
    return out


def format_decomposition(d: dict) -> list[str]:
    """The reference tool's lines."""
    lines = []
    for name in ("search", "refined"):
        s = d[name]
        lines.append(f"{name:8s}: p50 {s['p50']:7.3f} p90 {s['p90']:7.3f} p95 {s['p95']:7.3f} "
                     f"p99 {s['p99']:8.3f}  frac>1 {s['frac1']:.3f} frac>5 {s['frac5']:.3f}")
    lines.append(f"search-good&refine-bad: {d['search_good_refine_bad']:.3f}  "
                 f"search-bad: {d['search_bad']:.3f}  both-bad {d['both_bad']:.3f}")
    for name, _, _ in BANDS:
        lines.append(f"bad-frac by {name}: " + " ".join(f"{f:.2f}" for f in d[f"bad_by_{name}"]))
    if d["bad_quantiles"]:
        lines.append("bad err quantiles: " + " ".join(f"{v:+.1f}" for v in d["bad_quantiles"]))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="plane", choices=("plane", "driving"))
    ap.add_argument("seed", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = at_size(fast_config(), args.height, args.width)
    print("\n".join(format_decomposition(decompose(cfg, args.scene, args.seed,
                                                   device=args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
