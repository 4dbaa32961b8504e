"""Measured time against the speed-of-light bound for the port's hot
functions (counterpart of ``tools/roofline.py``).

Each row times one function on the card (:func:`utils.profiling.graph_ms`,
chained calls replayed from one CUDA graph: back-to-back calls of a function
of tens of launches are paced by the host once they overflow the CUDA launch
queue), counts the least work the function itself needs from
its shapes (and, where the work depends on the data, from this run's
inputs), whatever implements it, and reports the bound: the larger of the
operations over the card's float32 peak and the bytes (each input read once,
each output written once) over its memory rate. The reference counted its
TPU formulation's work (72 exact-split MXU cross terms per SSD, the
sampler's one-hot matmul); those counts are not reused.

The H100's published peaks (NVIDIA data sheet, SXM, at 700 W): 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s HBM3, 50 MB of L2. A row whose
bytes fit in the L2 can beat the HBM bound when its calls run back to back
(its inputs stay in the L2): it is marked L2-resident.

Rows, on frame 1 of ``make_scene(3, depth=14.0)`` along
``drive_trajectory(3, step=0.35, seed=4)`` at fast_config's 376x1241:

1. the band search (B1) on fast_config's band [12, 192] with the left-right
   check, on the blurred pair, as the depth frontend calls it
   (:func:`search_work`);
2. ``sample_channels_mm`` of [image, gx, gy] at N = ``point_capacity``
   points spread over level 0 (:func:`sample_work`);
3. ``gaussian_image_pyramid`` over 4 levels (:func:`pyramid_work`);
4. ``pattern_stack`` and its norms (:func:`pattern_work`).

Run on the card::

    python -m odometry_torch.tools.roofline
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from odometry_torch.config import fast_config
from odometry_torch.depth.estimator import search_band
from odometry_torch.device import card_line, resolve_device
from odometry_torch.image.pyramid import central_gradients, gaussian_blur3, gaussian_image_pyramid
from odometry_torch.image.sampling import sample_channels_mm
from odometry_torch.kernels.disparity import disparity_winner_maps, pattern_stack
from odometry_torch.tools.profile_step import frames_for
from odometry_torch.utils.profiling import graph_ms

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# NVLink between two H100s of one host, each way (900 GB/s both ways).
NVLINK_BYTES_PER_S = 450e9
L2_BYTES = 50e6
# One (x, xr) pair's SSD over the 8-point pattern: 8 subtractions, 1
# multiply and 7 fused multiply-adds counted as two operations each.
FLOPS_PER_PAIR = 24
LEVELS = 4


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of `flops` over the float32 peak and
    `nbytes` over the memory rate, and which of the two it is."""
    flop_s = flops / PEAK_F32_FLOPS
    byte_s = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(flop_s, byte_s), ("operations" if flop_s >= byte_s else "bytes")


def search_pairs(H, W, boundary, min_d, max_d) -> int:
    """(x, xr) pairs of one winner-map call: boundary <= xr, min_d <= x - xr
    <= max_d (None = the full search), for every row."""
    x = np.arange(W)
    lo = np.maximum(boundary, x - (W if max_d is None else max_d))
    hi = x - max(1, min_d or 1)
    return H * int(np.maximum(hi - lo + 1, 0).sum())


def search_work(H, W, boundary, min_d, max_d, lr) -> tuple[int, int]:
    """(operations, bytes) of one SSD search: FLOPS_PER_PAIR per (x, xr)
    pair scored once (the forward and the reverse winner read the same
    score); two float32 images read once, each output map written once
    (best, match and, with `lr`, rmatch; 4 bytes each)."""
    flops = FLOPS_PER_PAIR * search_pairs(H, W, boundary, min_d, max_d)
    return flops, 4 * H * W * (2 + 2 + int(lr))


def search_bound(H, W, boundary, min_d, max_d, lr) -> tuple[float, str]:
    """(bound_ms, bound_by) of one SSD search (B1 or B2)."""
    return bound(*search_work(H, W, boundary, min_d, max_d, lr))


def sample_work(C: int, H: int, W: int, u: torch.Tensor, v: torch.Tensor) -> tuple[int, int]:
    """(operations, bytes) of bilinear sampling of C channels at the points
    (u, v), edges clamped.

    Operations per point: the two fractions and their complements (4), then
    per channel two x-blends of 3 (2 multiplies, 1 add) and one y-blend of 3:
    N * (4 + 9 C); floors, clamps and index arithmetic are not counted.
    Bytes: the distinct pixels the four taps of all points touch (this run's
    u, v), each read once per channel, 4 bytes each; u and v read; the (C, N)
    float32 output written.
    """
    N = u.numel()
    u = torch.clamp(u.double().cpu(), 0.0, W - 1.0)
    v = torch.clamp(v.double().cpu(), 0.0, H - 1.0)
    x0, y0 = torch.floor(u).long(), torch.floor(v).long()
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    taps = torch.cat([y * W + x for y in (y0, y1) for x in (x0, x1)])
    touched = int(torch.unique(taps).numel())
    return N * (4 + 9 * C), 4 * (C * touched + 2 * N + C * N)


def _pyr_down_work(h: int, w: int) -> tuple[int, int]:
    """(operations, output pixels) of one pyr_down of an (h, w) image, made
    only at the kept samples: the horizontal 5-tap pass (5 multiplies, 4
    adds) on the h rows at the w // 2 kept columns, then the vertical one at
    the (h // 2, w // 2) outputs."""
    oh, ow = h // 2, w // 2
    return 9 * h * ow + 9 * oh * ow, oh * ow


def pyramid_work(H: int, W: int, levels: int = LEVELS) -> tuple[int, int]:
    """(operations, bytes) of ``gaussian_image_pyramid(img, levels, True)``:
    level 0 the 3x3 blur (two 3-tap passes of 5 operations per pixel),
    level 1 ``pyr_down`` of the input, level l >= 2 ``pyr_down`` of level
    l - 1 (:func:`_pyr_down_work`). Bytes: the input read once and every
    level written once, float32; a level read back for the next one is not
    counted again."""
    flops, pixels = 10 * H * W, H * W
    h, w = H, W
    for _ in range(1, levels):
        f, p = _pyr_down_work(h, w)
        flops, pixels = flops + f, pixels + p
        h, w = h // 2, w // 2
    return flops, 4 * (H * W + pixels)


def pattern_work(H: int, W: int) -> tuple[int, int]:
    """(operations, bytes) of ``pattern_stack(img)`` and its squared norms:
    8 squares and 7 adds per pixel; the image read once, the (8, H, W) stack
    and the (H, W) norms written once, float32."""
    return 15 * H * W, 4 * H * W * (1 + 8 + 1)


def report(name: str, ms: float, flops: float, nbytes: float, log=print) -> dict:
    """The row as the reference prints it, and its numbers."""
    bound_ms, bound_by = bound(flops, nbytes)
    l2 = bound_by == "bytes" and nbytes <= L2_BYTES
    eff = 100.0 * bound_ms / ms
    log(f"{name:34s} {ms * 1e3:9.1f} us | SoL {bound_ms * 1e3:8.1f} us ({bound_by}-bound: "
        f"{flops / 1e9:7.3f} GFLOP, {nbytes / 1e6:7.2f} MB) | eff {eff:5.1f}%"
        f"{' L2-resident' if l2 else ''}")
    return dict(name=name, measured_ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                gflop=flops / 1e9, mb=nbytes / 1e6, efficiency_pct=eff, l2_resident=l2)


def rows(cfg=None, *, device="cuda", reps: int = 20, log=print) -> list[dict]:
    """Time and bound the four rows on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("roofline: device times need a CUDA card")
    cfg = fast_config() if cfg is None else cfg
    c, d = cfg.camera, cfg.depth
    H, W = c.height, c.width
    # Frame 1 of drive_trajectory(3, ...): a trajectory's first poses do not
    # depend on its length.
    left, right = frames_for(cfg, 2, dev)[1]
    out = []

    ls, rs = gaussian_blur3(left), gaussian_blur3(right)
    min_d, max_d = search_band(c, d)
    kw = dict(boundary=d.boundary, max_disparity=max_d, min_disparity=min_d,
              lr_check=d.lr_check)
    t = graph_ms(lambda: disparity_winner_maps(ls, rs, **kw), reps)
    out.append(report(f"disparity band [{min_d}, {max_d}] lr", t,
                      *search_work(H, W, d.boundary, min_d, max_d, d.lr_check), log=log))

    N = cfg.tracker.point_capacity
    gx, gy = central_gradients(left)
    chan = torch.stack([left, gx, gy])
    u = torch.linspace(4.0, W - 5.0, N, device=dev)
    v = torch.linspace(4.0, H - 5.0, N, device=dev)
    t = graph_ms(lambda: sample_channels_mm(chan, u, v), reps)
    out.append(report(f"mm-sample 3ch N={N} L0", t, *sample_work(3, H, W, u, v), log=log))

    t = graph_ms(lambda: gaussian_image_pyramid(left, LEVELS, smooth=True), reps)
    out.append(report(f"gaussian pyramid x{LEVELS}", t, *pyramid_work(H, W), log=log))

    def patterns():
        P = pattern_stack(left)
        return P, torch.sum(P * P, dim=0)

    t = graph_ms(patterns, reps)
    out.append(report("pattern stack + norms", t, *pattern_work(H, W), log=log))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = fast_config()
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)} [{card_line(dev.index or 0)}]; "
              f"frame {cfg.camera.height}x{cfg.camera.width}\n", flush=True)
    out = rows(cfg, device=dev, log=lambda s: print(s, flush=True))
    print("\nJSON:", [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
                      for r in out], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
