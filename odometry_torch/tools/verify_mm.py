"""End-to-end check of the "mm" sampler's fast path through the port
(counterpart of ``tools/verify_mm.py``).

The reference's checks and gates, on the port's public API:

1. ``fast_config()`` (mm sampling, blocked extraction, lazy depth) over 25
   frames of ``make_scene(3, depth=14.0)`` along ``drive_trajectory(25,
   step=0.35, seed=9)`` at 376x1241: no depth failure, mean translation
   error (mte) < 0.10, at least 2 keyframes (the depth frontend ran on a
   promotion);
2. ``kitti_config()`` (floor sampling, full search) on the first 10 frames:
   mte < 0.15;
3. the mm sampler at float32 against ``sample_bilinear`` at 64x200, points
   outside the image included: largest difference < 1e-3;
4. ``pyr_down`` against the separable-conv golden (blur, then even rows and
   columns) at 376x1241: largest difference < 1e-2; also the banded-matmul
   ``pyr_down`` the reference runs on a TPU
   (``microbench.pyr_down_mm``), against the same golden and gate.

Each check raises when its gate fails; the tool prints ``VERIFY OK`` when
all pass. The reference ran these checks on frames its TPU rendered; the
frames here are rendered on the run's device with the texture phase rounded
as that TPU rounded it (``data/synthetic.py:tpu_phase_scene``, as
``tools/bench.py`` renders its own). On float32 frames both packages miss
the fast_config gate, and the reference the kitti_config one too (ROADMAP
C15, the mechanism of C5).

Run on the card::

    python -m odometry_torch.tools.verify_mm

``--device cpu`` (with ``--height``/``--width`` for a reduced camera) runs it
on the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig, at_size, fast_config, kitti_config
from odometry_torch.data.synthetic import (
    drive_trajectory,
    make_scene,
    render_stereo,
    tpu_phase_scene,
)
from odometry_torch.device import resolve_device
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.image.pyramid import GAUSS5, _sep_conv, pyr_down
from odometry_torch.image.sampling import sample_bilinear, sample_channels_mm
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools.microbench import pyr_down_mm, pyrdown_matrices

NUM_FRAMES = 25
KITTI_FRAMES = 10
FAST_GATE = 0.10
KITTI_GATE = 0.15
SAMPLER_GATE = 1e-3
PYRAMID_GATE = 1e-2
# The sampler's probes (tools/verify_mm.py:57-58): corners, points past the
# far edges and before the near ones, one interior point.
PROBE_U = (0.0, 199.0, 250.0, -3.0, 57.3)
PROBE_V = (0.0, 63.0, 70.0, -1.0, 31.9)


def render_frames(cfg: PipelineConfig, *, device="cuda"):
    """Ground truth and (left, right) frames of the check's trajectory, the
    texture phase rounded as the reference's TPU rounded it."""
    dev = resolve_device(device)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = tpu_phase_scene(make_scene(3, depth=14.0, device=dev))
    poses = drive_trajectory(NUM_FRAMES, step=0.35, seed=9)
    frames = [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2] for T in poses]
    return poses, frames


def track(cfg: PipelineConfig, poses, frames, *, device="cuda") -> dict:
    """``run_sequence`` of `cfg` over `frames`: frames, keyframes, failed_at,
    mte and fps."""
    res = run_sequence(frames, cfg, device=device)
    return dict(frames=res.num_frames, keyframes=len(res.keyframe_ids),
                failed_at=res.failed_at, fps=res.fps,
                mte=mean_translation_error(poses[: res.num_frames], res.poses))


def check_fast(run: dict) -> None:
    if run["failed_at"] is not None:
        raise RuntimeError(f"verify_mm fast: depth failed at frame {run['failed_at']}")
    if not run["mte"] < FAST_GATE:
        raise RuntimeError(f"verify_mm fast: mte {run['mte']} not below {FAST_GATE}")
    if run["keyframes"] < 2:
        raise RuntimeError(f"verify_mm fast: {run['keyframes']} keyframes, the depth frontend "
                           f"never ran on a promotion")


def check_kitti(run: dict) -> None:
    if not run["mte"] < KITTI_GATE:
        raise RuntimeError(f"verify_mm parity: mte {run['mte']} not below {KITTI_GATE}")


def sampler_error(*, device="cuda") -> float:
    """Largest |sample_bilinear - sample_channels_mm at float32| on the
    probes, over a 64x200 image of uniform [0, 255) values (numpy seed 0)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 255.0, (64, 200)),
                          dtype=torch.float32, device=dev)
    u = torch.tensor(PROBE_U, dtype=torch.float32, device=dev)
    v = torch.tensor(PROBE_V, dtype=torch.float32, device=dev)
    a = sample_bilinear(img, u, v)
    b = sample_channels_mm(img[None], u, v, dtype=torch.float32)[0]
    return float(torch.max(torch.abs(a - b)))


def pyramid_errors(height: int, width: int, *, device="cuda") -> dict:
    """Largest difference of the port's ``pyr_down`` and of the banded-matmul
    ``pyr_down_mm`` from the golden, over a `height` x `width` image of
    uniform [0, 255) values (numpy seed 1)."""
    dev = resolve_device(device)
    big = torch.as_tensor(np.random.default_rng(1).uniform(0.0, 255.0, (height, width)),
                          dtype=torch.float32, device=dev)
    golden = _sep_conv(big, GAUSS5)[0 : 2 * (height // 2) : 2, 0 : 2 * (width // 2) : 2]
    return {"conv": float(torch.max(torch.abs(pyr_down(big) - golden))),
            "matmul": float(torch.max(torch.abs(
                pyr_down_mm(big, *pyrdown_matrices(height, width, dev)) - golden)))}


def check_invariants(sampler: float, pyramid: dict) -> None:
    if not sampler < SAMPLER_GATE:
        raise RuntimeError(f"verify_mm: mm sampler differs from bilinear by {sampler}")
    for name, err in pyramid.items():
        if not err < PYRAMID_GATE:
            raise RuntimeError(f"verify_mm: pyr_down ({name}) differs from the golden by {err}")


def verify(fast: PipelineConfig | None = None, kitti: PipelineConfig | None = None, *,
           device="cuda", log=print) -> dict:
    """Every check of the module, in the reference's order; raises at the
    first gate that fails, else returns the numbers."""
    fast = fast_config() if fast is None else fast
    kitti = kitti_config() if kitti is None else kitti
    poses, frames = render_frames(fast, device=device)
    out = {"fast": track(fast, poses, frames, device=device)}
    r = out["fast"]
    log(f"[fast/mm] frames={r['frames']} keyframes={r['keyframes']} failed_at={r['failed_at']} "
        f"mte={r['mte']:.4f} fps={r['fps']:.1f}")
    check_fast(r)
    out["kitti"] = track(kitti, poses[:KITTI_FRAMES], frames[:KITTI_FRAMES], device=device)
    log(f"[parity]  frames={out['kitti']['frames']} mte={out['kitti']['mte']:.4f}")
    check_kitti(out["kitti"])
    c = fast.camera
    out["sampler"] = sampler_error(device=device)
    out["pyramid"] = pyramid_errors(c.height, c.width, device=device)
    log(f"mm vs gather (incl. OOB clips): {out['sampler']}")
    log(f"pyr_down conv vs golden: {out['pyramid']['conv']}; matmul vs golden: "
        f"{out['pyramid']['matmul']}")
    check_invariants(out["sampler"], out["pyramid"])
    log("VERIFY OK")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu (host)'}",
          flush=True)
    verify(at_size(fast_config(), args.height, args.width),
           at_size(kitti_config(), args.height, args.width), device=dev,
           log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
