"""Per-frame divergence diagnostic of an accuracy-sweep cell through the
port (counterpart of ``tools/diag_divergence.py``).

For each (preset, scene family, seed) it prints one line per frame: the
translation error against the exact ground truth, the weighted motion, the
promotion and lost flags (K, L), the finest level's first and final cost
and LM iterations, and the depth survivors, read from ``run_sequence``'s
``progress``; then the run's mte, keyframes and lost frames. So the frame
where a run leaves the rails, and what the failure detector saw there, is
visible (ROADMAP C12's plane seed 4 on the card).

The scene families and the 0.25 m steps are ``tools/accuracy_sweep.py``'s
(``odometry_torch/tools/accuracy_sweep.py:family``), rendered on the run's
device in float32 without the textured family's nuisance, as the reference
tool renders them.

Run on the card::

    python -m odometry_torch.tools.diag_divergence [fast|accurate] [plane|driving|textured] [seeds...]

on the CPU (tests): add ``--device cpu --height 96 --width 320 --frames 6``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, at_size
from odometry_torch.data.synthetic import drive_trajectory, render_stereo
from odometry_torch.device import resolve_device
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools.accuracy_sweep import CONFIGS, FAMILIES, NUM_FRAMES, SEEDS, family


def render_family(name: str, seed: int, cfg: PipelineConfig, num_frames: int, *,
                  device="cuda"):
    """Ground-truth poses and (left, right, z) of each frame of scene family
    `name` (accuracy_sweep's scene and step, no nuisance), rendered on
    `device`."""
    dev = resolve_device(device)
    scene, step, _ = family(name, seed, dev)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    poses = drive_trajectory(num_frames, step=step, seed=seed)
    return poses, [render_stereo(scene, cam, c.baseline, T, c.height, c.width) for T in poses]


def divergence(cfg: PipelineConfig, scene: str, seed: int, num_frames: int = NUM_FRAMES, *,
               device="cuda") -> dict:
    """One run's per-frame rows (frame, err, motion, promoted, lost,
    err_first, err_final, iters, nvd, depth_ok) and its mte, keyframes, lost
    frames and depth runs (init included)."""
    poses, rendered = render_family(scene, seed, cfg, num_frames, device=device)
    rows = []

    def progress(i, out):
        stats = out.track_stats[-1]
        P = out.cur_pose.cpu().numpy()
        rows.append(dict(frame=i, err=float(np.linalg.norm(P[:3, 3] - poses[i][:3, 3])),
                         motion=float(out.motion), promoted=bool(out.promoted),
                         lost=bool(out.lost), err_final=float(stats.err_final),
                         err_first=float(stats.err_first), iters=int(stats.iters),
                         nvd=int(out.num_valid_depth), depth_ok=bool(out.depth_ok)))

    res = run_sequence([f[:2] for f in rendered], cfg, progress=progress, device=device)
    return dict(rows=rows, keyframes=len(res.keyframe_ids), lost=len(res.lost_ids),
                mte=float(mean_translation_error(poses[: res.num_frames], res.poses)),
                depth_runs=1 + sum(r["nvd"] > 0 or not r["depth_ok"] for r in rows))


def format_run(cfg_name: str, scene: str, seed: int, run: dict) -> list[str]:
    """The reference tool's lines for one run."""
    lines = [f"=== {cfg_name}/{scene} seed {seed} ==="]
    for r in run["rows"]:
        flags = ("K" if r["promoted"] else " ") + ("L" if r["lost"] else " ")
        lines.append(f"  f{r['frame']:02d} {flags} err {r['err']:7.3f}  motion "
                     f"{r['motion']:6.3f}  err0 {r['err_first']:8.1f}->{r['err_final']:8.1f} "
                     f"it {r['iters']:2d}  nvd {r['nvd']:6d}")
    lines.append(f"  => mte {run['mte']:.4f} kf {run['keyframes']} lost {run['lost']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="fast", choices=list(CONFIGS))
    ap.add_argument("scene", nargs="?", default="plane", choices=FAMILIES)
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    args = ap.parse_args(argv)
    cfg = at_size(CONFIGS[args.config](), args.height, args.width)
    for seed in args.seeds or SEEDS:
        run = divergence(cfg, args.scene, seed, args.frames, device=args.device)
        print("\n".join(format_run(args.config, args.scene, seed, run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
