"""Device-time microbenchmarks of the hot operations (counterpart of
``tools/microbench.py``).

Usage: ``python -m odometry_torch.tools.microbench [suite ...]`` (default:
all), ``--device`` the card (default ``cuda``; there is no host mode).

Suites (the reference's names, sizes and operations, through the port's
modules):

* ``gather``: index gathers at odometry point counts;
* ``sample``: ``sample_bilinear`` against the mm sampler, 1 and 3 channels;
* ``lm``: one tracker LM iteration body against the point count and the
  sampler, then its small-operation tail (the 6x6 solve; ``se3_exp`` with
  ``se3_compose``);
* ``pyramid``: ``pyr_down`` as banded matmuls, as the port's convolution and
  slice, the bare strided slice, the 4-level pyramid;
* ``depth``: the depth frontend's stages on fast_config at 376x1241;
* ``step``: chained fast_config steps against one synchronised step.

Each row prints its operators per call and, in ms per call:

* ``device``: :func:`utils.profiling.device_ms`, back-to-back calls behind a
  sleep kernel, as many as keep about OPS_IN_FLIGHT operators queued (at
  least one call): past the CUDA launch queue the host paces the calls,
  and a body of ~500 operators read its wall time;
* ``graph``: :func:`utils.profiling.graph_ms`, chained calls captured in one
  CUDA graph and replayed: device time with no host dispatch, the
  counterpart of the reference's in-dispatch ``fori_loop`` (``dev_time``);
* ``busy``: :func:`utils.profiling.busy_ms`, the card's kernel time under the
  profiler, in place of the two above for a row that reads the host;
* ``wall``: :func:`utils.profiling.wall_ms`, each call dispatched and
  synchronised.

Each suite declares which of its rows a graph captures; capture is never
found out by trying, and a row declared to capture that reads the host makes
the capture raise. A row that reads the host names the line that blocks the
graph.

The reference's bodies add ``i % 2`` to an index and multiply a sum by 0 so
that XLA cannot hoist a loop-invariant body out of its ``fori_loop``. Eager
calls and graph replays run every call, so the port's bodies are the
operations alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
from typing import Callable

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import fast_config
from odometry_torch.depth.estimator import compute_depth, refine_depth_points, search_band
from odometry_torch.device import card_line, resolve_device
from odometry_torch.geometry.se3 import se3_compose, se3_exp
from odometry_torch.image.pyramid import (
    GAUSS5,
    central_gradients,
    gaussian_blur3,
    gaussian_image_pyramid,
    pyr_down,
)
from odometry_torch.image.sampling import sample_bilinear, sample_channels_mm
from odometry_torch.kernels.disparity import disparity_search
from odometry_torch.kernels.points import (
    PointSet,
    extract_points,
    normal_equations_points,
    residual_jacobian_points,
)
from odometry_torch.kernels.select import select_points
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.solvers.linear6 import solve_spd6
from odometry_torch.solvers.robust import robust_weights
from odometry_torch.tools.profile_step import frames_for
from odometry_torch.utils.profiling import busy_ms, count_ops, device_ms, graph_ms, wall_ms

H, W = 376, 1241
# The lm suite's camera (tools/microbench.py:110).
LM_CAM = (718.0, 718.0, 620.0, 188.0)
LM_SIZES = (8192, 16384, 40960)
INTERPS = ("bilinear", "mm")
GATHER_SIZES = (8192, 40960)
STEPS = 16
# Operators device_ms keeps queued behind its sleep kernel: under the
# CUDA launch queue, which holds about a thousand launches.
OPS_IN_FLIGHT = 512


@functools.lru_cache(maxsize=None)
def _pyrdown_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) banded matrix: the 5-tap Gaussian blur (REFLECT_101
    borders) fused with even-index 2x decimation, one row per output sample
    (a copy of the reference's ``image/pyramid.py:_pyrdown_matrix``)."""
    A = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        c = 2 * o
        for j, t in enumerate(GAUSS5):
            idx = c + j - 2
            if idx < 0:
                idx = -idx  # BORDER_REFLECT_101
            elif idx >= n_in:
                idx = 2 * (n_in - 1) - idx
            A[o, idx] += t
    return A


def pyrdown_matrices(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Av, Ah) of :func:`pyr_down_mm` for an (h, w) image, on `device`."""
    return (torch.as_tensor(_pyrdown_matrix(h, h // 2), device=device),
            torch.as_tensor(_pyrdown_matrix(w, w // 2), device=device))


def pyr_down_mm(img: torch.Tensor, Av: torch.Tensor, Ah: torch.Tensor) -> torch.Tensor:
    """``pyr_down`` of an (H, W) image as the reference computes it on a TPU:
    Av @ img @ Ah^T with the banded blur-and-decimate matrices of
    :func:`pyrdown_matrices`, in float32 (TF32 is off unless the caller
    turned it on)."""
    return (Av @ img) @ Ah.T


@dataclasses.dataclass(frozen=True)
class Row:
    """One measured body `fn`. `blocks` names the line where it reads the
    host; None declares that a CUDA graph captures it. `per_call`: the
    steps one call of `fn` runs (the chained steps' row: STEPS), by which
    its figures are divided."""

    name: str
    fn: Callable
    blocks: str | None = None
    reps: int = 20
    per_call: int = 1

    @property
    def captures(self) -> bool:
        return self.blocks is None


def _uniform(rng, shape, dev, scale=1.0) -> torch.Tensor:
    return torch.as_tensor(rng.uniform(0.0, 1.0, shape) * scale, dtype=torch.float32,
                           device=dev)


def suite_gather(dev, sizes=GATHER_SIZES) -> list[Row]:
    rng = np.random.default_rng(0)
    flat = _uniform(rng, (H * W,), dev, 255.0)
    rows = []
    for N in sizes:
        idx = torch.as_tensor(rng.integers(0, H * W, N), device=dev)
        srt = torch.sort(idx).values
        blk = idx.reshape(-1, 128)
        rows += [Row(f"N={N:6d} flat 1D idx", lambda idx=idx: flat[idx]),
                 Row(f"N={N:6d} sorted idx", lambda srt=srt: flat[srt]),
                 Row(f"N={N:6d} (N/128,128) idx", lambda blk=blk: flat[blk])]
    small = _uniform(rng, (64 * 128,), dev)
    sidx = torch.as_tensor(rng.integers(0, 64 * 128, 40960), device=dev)
    tidx = torch.as_tensor(rng.integers(0, H * W, 128), device=dev)
    return rows + [Row("8K-elem operand, N=40960", lambda: small[sidx]),
                   Row("N=128 (fixed-cost floor)", lambda: flat[tidx])]


def suite_sample(dev, sizes=GATHER_SIZES) -> list[Row]:
    rng = np.random.default_rng(0)
    img = _uniform(rng, (H, W), dev, 255.0)
    imgs3 = torch.stack([img, img, img])
    rows = []
    for N in sizes:
        u = _uniform(rng, (N,), dev, W - 2)
        v = _uniform(rng, (N,), dev, H - 2)
        rows += [Row(f"N={N:6d} gather", lambda u=u, v=v: sample_bilinear(img, u, v)),
                 Row(f"N={N:6d} mm C=1", lambda u=u, v=v: sample_channels_mm(img[None], u, v)),
                 Row(f"N={N:6d} mm C=3", lambda u=u, v=v: sample_channels_mm(imgs3, u, v))]
    return rows


def lm_inputs(N: int, height: int = H, width: int = W, seed: int = 0) -> dict:
    """The lm suite's inputs as numpy (tools/microbench.py:108-127, drawn
    with numpy): a uniform [0, 255) image, N points at random pixels with
    inverse depth 0.1, uniform keyframe intensities, the suite's camera."""
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0.0, 1.0, (height, width)) * 255.0).astype(np.float32)
    idx = rng.integers(0, height * width, N)
    return dict(img=img, xs=(idx % width).astype(np.float32),
                ys=(idx // width).astype(np.float32),
                kf=rng.uniform(0.0, 1.0, N).astype(np.float32), cam=LM_CAM)


def lm_body(inputs: dict, interp: str, device) -> Callable[[], torch.Tensor]:
    """The tracker's LM iteration body on `inputs` (tools/microbench.py:120-
    132): the pose from the twist (zero), residuals and Jacobians at the
    points, Huber weights, the 6x6 normal equations with the LM damping, the
    Cholesky solve. Returns a function of no arguments that computes the
    step `delta` (6,)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, device=dev)
    img = t(inputs["img"])
    grads = central_gradients(img)
    N = len(inputs["xs"])
    pts = PointSet(xs=t(inputs["xs"]), ys=t(inputs["ys"]),
                   inv_depth=torch.full((N,), 0.1, device=dev),
                   valid=torch.ones((N,), dtype=torch.bool, device=dev),
                   num=torch.tensor(N, dtype=torch.int32, device=dev))
    kf = t(inputs["kf"])
    cam = Pinhole.create(*inputs["cam"])
    xi = torch.zeros(6, device=dev)

    def body():
        T = se3_exp(xi)
        sys_ = residual_jacobian_points(pts, img, cam, T, kf_intensity=kf, interp=interp,
                                        grads=grads)
        w = robust_weights("huber", sys_.r, sys_.valid, huber_delta=28.0, tdist_dof=200.0,
                           tdist_sigma_init=5.0)
        eqs = normal_equations_points(sys_, w)
        A = (eqs.JtWJ + 0.01 * torch.diag(torch.diag(eqs.JtWJ))
             + 1e-12 * torch.eye(6, device=dev))
        return solve_spd6(A, -eqs.JtWr)

    return body


def suite_lm(dev, sizes=LM_SIZES, interps=INTERPS) -> list[Row]:
    rows = []
    for N in sizes:
        inputs = lm_inputs(N)
        for interp in interps:
            rows.append(Row(f"N={N:6d} interp={interp:8s}", lm_body(inputs, interp, dev)))
    A6 = torch.eye(6, device=dev) * 3.0
    b6 = torch.ones(6, device=dev)
    acc = torch.zeros((), device=dev)
    eye4 = torch.eye(4, device=dev)
    return rows + [
        Row("solve_spd6 alone", lambda: solve_spd6(A6 + acc, b6)),
        Row("se3_exp+compose alone", lambda: se3_compose(se3_exp(b6 * 1e-6 * acc), eye4)),
    ]


def suite_pyramid(dev) -> list[Row]:
    img = _uniform(np.random.default_rng(0), (H, W), dev, 255.0)
    Av, Ah = pyrdown_matrices(H, W, dev)
    return [
        Row("pyrdown as banded matmuls", lambda: pyr_down_mm(img, Av, Ah)),
        Row("pyrdown as conv + [::2]", lambda: pyr_down(img)),
        # A slice is a view: materialising it is the device's work.
        Row("bare strided slice [1::2]", lambda: img[1::2, 1::2].contiguous()),
        Row("4-level image pyramid", lambda: gaussian_image_pyramid(img, 4, smooth=True)),
    ]


# Where the depth rows read the host: the refinement loop's test of its
# active lanes, once per iteration.
REFINE_BLOCKS = "odometry_torch/depth/estimator.py:122 (_refine_loop: bool(active.any()))"


def suite_depth(dev, cfg=None) -> list[Row]:
    cfg = fast_config() if cfg is None else cfg
    c, d = cfg.camera, cfg.depth
    # make_scene(3, depth=14.0) from the identity pose (tools/microbench.py:200-201).
    left, right = frames_for(cfg, 1, dev)[0]
    ls, rs = gaussian_blur3(left), gaussian_blur3(right)
    select = lambda: select_points(ls, boundary=d.boundary, block_rows=d.block_rows,
                                   block_cols=d.block_cols, grad_th=d.grad_th,
                                   max_points_per_block=d.max_points_per_block)
    min_d, max_d = search_band(c, d)
    sel = select()
    search = lambda: disparity_search(ls, rs, sel, fx=c.fx, baseline=c.baseline,
                                      boundary=d.boundary, ssd_th=d.ssd_th,
                                      max_disparity=max_d, min_disparity=min_d,
                                      lr_check=d.lr_check, lr_tol=d.lr_tol)
    inv = search().inv_depth
    cap = min(d.max_residuals, d.block_rows * d.block_cols * d.max_points_per_block)
    extract = lambda: extract_points(inv, sel, cap)
    pts = extract_points(inv[None], sel[None], cap)
    return [
        Row("select_points", select),
        Row("disparity_search", search),
        Row(f"extract_points (cap={cap:5d})", extract),
        Row("refine_depth_points", lambda: refine_depth_points(left[None], right[None], pts, c, d),
            REFINE_BLOCKS, reps=5),
        Row("compute_depth (full)", lambda: compute_depth(left, right, c, d), REFINE_BLOCKS,
            reps=5),
    ]


# Where a step reads the host: the tracker's test of its active LM lanes,
# once per iteration, and the depth refinement's on a keyframe candidate.
STEP_BLOCKS = ("odometry_torch/tracking/tracker.py:202 (bool(active.any())) and "
               + REFINE_BLOCKS)


def suite_step(dev, cfg=None) -> list[Row]:
    """STEPS chained steps of fast_config after ``init`` (one synchronisation
    at the end, figures per step) against one synchronised step
    (tools/microbench.py:246-277), on make_scene(3, depth=14.0) along
    drive_trajectory(STEPS + 1, step=0.35, seed=4)."""
    cfg = fast_config() if cfg is None else cfg
    frames = frames_for(cfg, STEPS + 1, dev)
    state, _ = init(*frames[0], cfg, device=dev)

    def chained():
        s = state
        for left, right in frames[1:]:
            s, out = step(s, left, right, cfg)
        return out.cur_pose

    left, right = frames[1]
    return [Row(f"{STEPS} chained steps, per step", chained, STEP_BLOCKS, reps=1,
                per_call=STEPS),
            Row("single dispatched step", lambda: step(state, left, right, cfg), STEP_BLOCKS,
                reps=5)]


SUITES = {"gather": suite_gather, "sample": suite_sample, "lm": suite_lm,
          "pyramid": suite_pyramid, "depth": suite_depth, "step": suite_step}


def measure(row: Row) -> dict:
    """The row's operators per call and its times (ms per call of the body;
    per step for the chained steps)."""
    k = row.per_call
    ops = count_ops(row.fn)
    out = {"name": row.name, "captures": row.captures, "blocks": row.blocks, "ops": ops / k}
    if row.captures:
        out["device_ms"] = device_ms(row.fn, max(1, min(row.reps, OPS_IN_FLIGHT // ops)))
        out["graph_ms"] = graph_ms(row.fn, row.reps)
    else:
        out["busy_ms"] = busy_ms(row.fn, row.reps) / k
    out["wall_ms"] = wall_ms(row.fn, row.reps) / k
    return out


def format_row(r: dict) -> str:
    if r["captures"]:
        times = f"device {r['device_ms']:8.4f}  graph {r['graph_ms']:8.4f}"
    else:
        times = f"busy   {r['busy_ms']:8.4f}  graph      n/a"
    line = f"  {r['name']:30s} {times}  wall {r['wall_ms']:9.4f}  ops {r['ops']:8.1f}"
    return line if r["captures"] else f"{line}  (no graph: reads the host at {r['blocks']})"


def run(names=tuple(SUITES), *, device="cuda", log=print, **sizes) -> dict:
    """Measure each suite of `names` on the card: {suite: [row dicts]}.
    `sizes` passes a suite's keyword (``lm_sizes=``, ``lm_interps=``,
    ``gather_sizes=``, ``sample_sizes=``) through."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("microbench: device times need a CUDA card")
    out = {}
    for name in names:
        kw = {k[len(name) + 1:]: v for k, v in sizes.items() if k.startswith(f"{name}_")}
        log(f"== {name} (ms per call; ops = operators per call) ==")
        out[name] = []
        for row in SUITES[name](dev, **kw):
            out[name].append(measure(row))
            log(format_row(out[name][-1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suites", nargs="*", metavar="suite", help=f"any of {', '.join(SUITES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [s for s in args.suites if s not in SUITES]
    if unknown:
        ap.error(f"unknown suites {unknown}; choose from {list(SUITES)}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(dev.index or 0), flush=True)
    run(args.suites or list(SUITES), device=dev, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
