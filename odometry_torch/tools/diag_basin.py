"""Single-frame basin experiment on a sweep cell through the port
(counterpart of ``tools/diag_basin.py``).

Renders frames 0 and 1 of the sweep trajectory (0.25 m steps) of a scene
seed, builds the keyframe from frame 0 with ``init``, and solves frame 1's
pose with ``solve_pose_points`` on ``init``'s ``kf_track`` from (a) the
identity and (b) the ground-truth relative pose, for the reference's seven
tracker variants. Prints per level (coarsest first) err_first -> err_final
and the LM iterations, and the final translation error: a basin failure
shows as (a) off and (b) on, an iteration budget as both off.

Run on the card::

    python -m odometry_torch.tools.diag_basin [seed] [plane|driving]

on the CPU (tests): add ``--device cpu --height 96 --width 320``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, at_size, fast_config
from odometry_torch.device import resolve_device
from odometry_torch.image.pyramid import gaussian_image_pyramid
from odometry_torch.pipeline.odometry import init
from odometry_torch.tools.diag_divergence import render_family
from odometry_torch.tracking.tracker import solve_pose_points

VARIANTS = [
    ("fast-asis", lambda t: t),
    ("bilinear", lambda t: dataclasses.replace(t, interp="bilinear")),
    ("cap16k", lambda t: dataclasses.replace(t, point_capacity=16384)),
    ("prec.995", lambda t: dataclasses.replace(t, precision=0.995)),
    ("iters20", lambda t: dataclasses.replace(t, max_iterations=(20, 30, 30, 30))),
    ("bilin+cap16k", lambda t: dataclasses.replace(t, interp="bilinear",
                                                   point_capacity=16384)),
    ("cap16k+prec+it", lambda t: dataclasses.replace(
        t, point_capacity=16384, precision=0.995, max_iterations=(20, 30, 30, 30))),
]


def basin(base: PipelineConfig, seed: int, scene: str = "plane", variants=VARIANTS, *,
          device="cuda") -> list[dict]:
    """One row per (variant, start): variant, init ("identity" or "gt"),
    terr (translation error of the solved relative pose) and levels, a list
    of (err_first, err_final, iters) coarsest first."""
    dev = resolve_device(device)
    # Frames 0 and 1 (the reference renders them from a 3-frame trajectory;
    # trajectories share their first poses).
    poses, rendered = render_family(scene, seed, base, 2, device=dev)
    (l0, r0, _), (l1, _, _) = rendered[0], rendered[1]
    # Ground-truth relative pose: kf-cam -> cur-cam = inv(P1) @ P0.
    T_gt = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    c = base.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    rows = []
    for vname, mod in variants:
        tcfg = mod(base.tracker)
        cfg = dataclasses.replace(base, tracker=tcfg)
        state, _ = init(l0, r0, cfg, device=dev)
        pyr1 = gaussian_image_pyramid(l1, tcfg.num_levels, smooth=True)
        for init_name, T0 in (("identity", np.eye(4, dtype=np.float32)), ("gt", T_gt)):
            res = solve_pose_points(state.kf_track, pyr1, cam, tcfg,
                                    torch.as_tensor(T0, device=dev))
            T = res.T.cpu().numpy()
            rows.append(dict(
                variant=vname, init=init_name,
                terr=float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])),
                levels=[(float(s.err_first), float(s.err_final), int(s.iters))
                        for s in res.stats]))
    return rows


def format_row(row: dict) -> str:
    """The reference tool's line."""
    n = len(row["levels"])
    per_level = "  ".join(f"L{n - 1 - i}:{e0:7.1f}->{e1:7.1f}/{it:2d}"
                          for i, (e0, e1, it) in enumerate(row["levels"]))
    return f"{row['variant']:16s} {row['init']:8s} terr {row['terr']:7.4f}  {per_level}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=11)
    ap.add_argument("scene", nargs="?", default="plane", choices=("plane", "driving"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    base = at_size(fast_config(), args.height, args.width)
    for row in basin(base, args.seed, args.scene, device=args.device):
        print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
