"""Multi-seed, multi-scene accuracy sweep of the presets through the port
(counterpart of ``tools/accuracy_sweep.py``).

bench.py's gate (mte < 0.15 on one plane trajectory) is one trajectory
wide; this sweep runs fast_config and accurate_config over SEEDS trajectory
seeds x three scene families at 376x1241, 49 frames each, as the
reference's does: the plane of bench.py, the driving corridor of the parity
tests, and a natural ridged texture with the photometric nuisance model
(exposure drift, inter-eye gain, vignette, sensor noise) applied to each
frame and eye. Frames are rendered on the run's device. An init failure or
a depth failure counts as an mte of inf. It reports the median, min, max
and green count of each (preset, family) and exits non-zero when a median
is outside its margin.

Each run's record holds the mte, keyframes, lost frames, depth runs,
seconds, and the launches of the band kernel B1 and the full-search kernel
B2 (0 on the CPU, where the plain versions run).

The table goes to ``--out`` (default ``build/odometry_torch/accuracy.md``);
the repository's ``ACCURACY.md`` is the reference's TPU table and is never
written. Run on the card::

    python -m odometry_torch.tools.accuracy_sweep

or a cut of it, e.g. ``--configs fast --families plane --seeds 3 --frames
13``; on the CPU add ``--device cpu`` (and ``--height``/``--width`` for a
reduced camera, through ``config.at_size``).
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time
from pathlib import Path

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, accurate_config, at_size, fast_config
from odometry_torch.data.synthetic import (
    PhotometricNuisance,
    apply_nuisance,
    drive_trajectory,
    make_driving_scene,
    make_natural_scene,
    make_scene,
    render_stereo,
)
from odometry_torch.device import card_line, resolve_device
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.kernels import disparity_band, disparity_full
from odometry_torch.pipeline.runner import run_sequence

SEEDS = [3, 4, 5, 11, 23]
GATE = 0.15
MARGIN = 0.30  # require median <= GATE * (1 - MARGIN)
# The textured family stresses the algorithm class's known limitation (a raw
# photometric residual with no illumination model, on multi-octave texture
# with sensor nuisances), so its margin is the gate itself.
FAMILY_MARGIN = {"plane": MARGIN, "driving": MARGIN, "textured": 0.0}
CONFIGS = {"fast": fast_config, "accurate": accurate_config}
FAMILIES = ("plane", "driving", "textured")
NUM_FRAMES = 49
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "odometry_torch" / "accuracy.md"


def family(name: str, seed: int, device):
    """(scene, trajectory step, nuisance or None) of scene family `name`
    (tools/accuracy_sweep.py:75-81). The steps keep the camera inside each
    scene's textured envelope."""
    if name == "plane":
        return make_scene(seed, depth=14.0, device=device), 0.25, None
    if name == "driving":
        return make_driving_scene(seed, side_x=20.0, wall_z=26.0, device=device), 0.25, None
    if name == "textured":
        return (make_natural_scene(seed, depth=14.0, device=device), 0.25,
                PhotometricNuisance(seed=seed))
    raise ValueError(f"unknown scene family {name!r}; one of {FAMILIES}")


def render_frames(family_name: str, seed: int, cfg: PipelineConfig, num_frames: int, device):
    """Ground-truth poses and the (left, right) frames of one run, rendered
    on `device`; the textured family's nuisance is applied on the host."""
    scene, step, nuisance = family(family_name, seed, device)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    poses = drive_trajectory(num_frames, step=step, seed=seed)
    frames = []
    for fi, T in enumerate(poses):
        left, right, _ = render_stereo(scene, cam, c.baseline, T, c.height, c.width)
        if nuisance is not None:
            left = apply_nuisance(left.cpu().numpy(), fi, nuisance, eye=0)
            right = apply_nuisance(right.cpu().numpy(), fi, nuisance, eye=1)
        frames.append((left, right))
    return poses, frames


def run_one(cfg: PipelineConfig, poses, frames, device) -> dict:
    """One run through ``run_sequence``: its mte (inf on an init or depth
    failure), poses, keyframes, lost frames, depth runs, seconds and B1/B2
    launches."""
    summaries = []
    b1, b2 = disparity_band.LAUNCHES, disparity_full.LAUNCHES
    t0 = time.perf_counter()
    try:
        res = run_sequence(frames, cfg, device=device,
                           progress=lambda i, out: summaries.append(out.summary))
    except RuntimeError as e:  # the init frame's depth failed
        return dict(mte=float("inf"), error=str(e), poses=None, frames=0, failed_at=0,
                    keyframes=0, lost=0, depth_runs=1, seconds=time.perf_counter() - t0,
                    b1=disparity_band.LAUNCHES - b1, b2=disparity_full.LAUNCHES - b2)
    seconds = time.perf_counter() - t0
    s = torch.stack(summaries).cpu().numpy() if summaries else np.zeros((0, 39), np.float32)
    failed = res.failed_at is not None
    return dict(
        mte=float("inf") if failed else float(mean_translation_error(
            poses[: res.num_frames], res.poses)),
        error=None, poses=res.poses, frames=res.num_frames, failed_at=res.failed_at,
        keyframes=len(res.keyframe_ids), lost=len(res.lost_ids),
        # The init frame, and each frame that ran depth (survivors, or a
        # failed depth).
        depth_runs=1 + int(((s[:, 37] > 0) | (s[:, 34] < 0.5)).sum()),
        seconds=seconds, b1=disparity_band.LAUNCHES - b1, b2=disparity_full.LAUNCHES - b2)


def sweep(configs=tuple(CONFIGS), families=FAMILIES, seeds=SEEDS, frames: int = NUM_FRAMES,
          *, device="cuda", height: int | None = None, width: int | None = None,
          log=print) -> list[dict]:
    """Run every (preset, family, seed) on `device` (the card unless the
    caller asks for the CPU); returns one record per run (``run_one``'s keys
    plus config, scene and seed), in the order presets, families, seeds.
    Each family's frames are rendered once per seed and camera."""
    dev = resolve_device(device)
    cfgs = {name: at_size(CONFIGS[name](), height, width) for name in configs}
    records = []
    for fam in families:
        for seed in seeds:
            rendered = {}
            for name, cfg in cfgs.items():
                if cfg.camera not in rendered:
                    rendered[cfg.camera] = render_frames(fam, seed, cfg, frames, dev)
                poses, frs = rendered[cfg.camera]
                rec = dict(config=name, scene=fam, seed=seed, **run_one(cfg, poses, frs, dev))
                records.append(rec)
                if log is not None:
                    log(format_run(rec))
    order = {(c, f, s): i for i, (c, f, s) in enumerate(
        (c, f, s) for c in configs for f in families for s in seeds)}
    return sorted(records, key=lambda r: order[(r["config"], r["scene"], r["seed"])])


def format_run(r: dict) -> str:
    head = f"{r['config']:9s} {r['scene']:8s} seed {r['seed']:3d}: "
    if r["error"] is not None:
        return head + r["error"]
    return (head + f"mte {r['mte']:8.4f} kf {r['keyframes']:2d} lost {r['lost']} "
            f"depth runs {r['depth_runs']} B1 {r['b1']} B2 {r['b2']} failed_at "
            f"{r['failed_at']} ({r['seconds']:.1f}s)")


def summarize(records: list[dict]) -> list[dict]:
    """One row per (preset, family), in the records' order: median, min and
    max mte, runs under the gate (n_green), runs (n) and whether the median
    meets the family's margin (ok)."""
    groups: dict = {}
    for r in records:
        groups.setdefault((r["config"], r["scene"]), []).append(r["mte"])
    rows = []
    for (config, scene), mtes in groups.items():
        m = np.asarray(mtes, np.float64)
        median = float(np.median(m))
        rows.append(dict(config=config, scene=scene, median=median, min=float(m.min()),
                         max=float(m.max()), n_green=int((m < GATE).sum()), n=len(m),
                         ok=median <= GATE * (1 - FAMILY_MARGIN[scene])))
    return rows


def format_report(rows: list[dict], records: list[dict], measured_on: str, seeds,
                  frames: int, size: tuple) -> str:
    lines = [
        "# Accuracy sweep through odometry_torch",
        "",
        f"{len(seeds)} trajectory seeds x {len({r['scene'] for r in rows})} scene families x "
        f"{len({r['config'] for r in rows})} presets at {size[0]}x{size[1]}, {frames} frames each "
        "(`python -m odometry_torch.tools.accuracy_sweep`).",
        f"Gate: mte < {GATE} (bench.py); margin: median <= {GATE * (1 - MARGIN):.3f} for the "
        f"clean families, median <= {GATE:.2f} for `textured`.",
        "",
        "| config | scene | median mte | min | max | green |",
        "|---|---|---|---|---|---|",
    ]
    lines += [f"| {r['config']} | {r['scene']} | {r['median']:.4f} | {r['min']:.4f} "
              f"| {r['max']:.4f} | {r['n_green']}/{r['n']} |" for r in rows]
    lines += ["", "| config | scene | seed | mte | keyframes | lost | depth runs | B1 | B2 "
              "| seconds |", "|---|---|---|---|---|---|---|---|---|---|"]
    lines += [f"| {r['config']} | {r['scene']} | {r['seed']} | {r['mte']:.6f} | "
              f"{r['keyframes']} | {r['lost']} | {r['depth_runs']} | {r['b1']} | {r['b2']} | "
              f"{r['seconds']:.3f} |" for r in records]
    lines += ["", f"Measured on: {measured_on}, {datetime.date.today().isoformat()}. "
              f"Seeds: {list(seeds)}.", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", choices=list(CONFIGS), default=list(CONFIGS))
    ap.add_argument("--families", nargs="+", choices=list(FAMILIES), default=list(FAMILIES))
    ap.add_argument("--seeds", nargs="+", type=int, default=SEEDS)
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where the table is written (never ACCURACY.md, the reference's)")
    args = ap.parse_args(argv)
    if Path(args.out).name == "ACCURACY.md":
        ap.error("--out: ACCURACY.md is the reference's table; write the port's elsewhere")
    dev = resolve_device(args.device)
    measured_on = (f"{torch.cuda.get_device_name(dev)} ({card_line(dev.index or 0)})"
                   if dev.type == "cuda" else "cpu (host)")
    records = sweep(args.configs, args.families, args.seeds, args.frames, device=dev,
                    height=args.height, width=args.width)
    rows = summarize(records)
    cfg = at_size(CONFIGS[args.configs[0]](), args.height, args.width)
    out = format_report(rows, records, measured_on, args.seeds, args.frames,
                        (cfg.camera.height, cfg.camera.width))
    print(out)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(out)
    if not all(r["ok"] for r in rows):
        print("FAIL: a preset median is outside the margin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
