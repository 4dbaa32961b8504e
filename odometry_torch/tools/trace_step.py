"""A device trace of chained odometry steps and its table of kernels by self
time (counterpart of ``tools/trace_step.py`` and ``tools/parse_trace.py``).

:func:`trace` records 21 chained fast_config steps (``make_scene(3,
depth=14.0)`` along ``drive_trajectory(8, step=0.35, seed=4)``, ``init`` on
frame 0, then frames 1-7 three times) under ``utils.profiling.device_trace``,
or with ``depth=True`` 10 ``compute_depth`` calls on frame 1, and reads the
Chrome trace it wrote with :func:`parse`: the total device self time, the
totals by category, and the top kernels by self time with their counts.

:func:`parse` reads any saved Chrome trace of ``torch.profiler``: its device
events are the kernels (``cat`` "kernel") and the copies and fills
(``gpu_memcpy``, ``gpu_memset``). Each name falls into the first category of
``CATEGORIES`` with a listed part of it (case-insensitive), else "other".

Run on the card::

    python -m odometry_torch.tools.trace_step [--depth] [--out DIR]

(``--out`` defaults to ``build/odometry_torch/traces`` in the checkout); a
trace saved before::

    python -m odometry_torch.tools.trace_step --parse TRACE.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

import torch

from odometry_torch.config import PipelineConfig, fast_config
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.device import card_line, resolve_device
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.tools.profile_step import frames_for
from odometry_torch.utils.profiling import device_trace

FRAMES = 8
PASSES = 3  # frames 1.. this many times: 21 steps
DEPTH_CALLS = 10
TOP = 35
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# (category, parts of a kernel's name), first match wins. The SSD kernels
# are the port's own (csrc/disparity_band.cu, disparity_full.cu, their tiled
# route); B3's all-gather and torch's copy kernels are copies; index, gather,
# scatter and sort kernels before the elementwise ones, whose names some of
# them carry (index_elementwise_kernel).
CATEGORIES = (
    ("ssd", ("band_kernel", "band_tile_kernel", "full_kernel", "full_tile_kernel",
             "fill_keys", "finish_keys")),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "dot_kernel")),
    ("copy", ("memcpy", "memset", "copy_kernel", "catarray", "all_gather_kernel")),
    ("index/scatter", ("index", "scatter", "gather", "sort", "radix", "put_")),
    ("reduction", ("reduce", "scan", "cumsum", "cumulative")),
    ("elementwise", ("elementwise",)),
)
OUT = str(Path(__file__).resolve().parents[2] / "build" / "odometry_torch" / "traces")


def category(name: str) -> str:
    low = name.lower()
    for cat, parts in CATEGORIES:
        if any(p in low for p in parts):
            return cat
    return "other"


def parse(path: str, top: int = TOP, log=print) -> dict:
    """The device events of the Chrome trace at `path`: {"total_ms",
    "by_category" [(category, ms)], "rows" [{"name", "count", "self_ms",
    "category"}] by self time}, the first `top` rows printed."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += float(e.get("dur", 0.0))
    rows = sorted(({"name": n, "count": c, "self_ms": us / 1e3, "category": category(n)}
                   for n, (c, us) in by_name.items()), key=lambda r: -r["self_ms"])
    total = sum(r["self_ms"] for r in rows)
    cats = defaultdict(float)
    for r in rows:
        cats[r["category"]] += r["self_ms"]
    by_cat = sorted(cats.items(), key=lambda kv: -kv[1])
    log(f"total device self time: {total:.3f} ms")
    for cat, ms in by_cat:
        log(f"  BY-CAT {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  {cat}")
    log(f"{'self_ms':>9} {'pct':>6} {'#':>6}  [category] kernel")
    for r in rows[:top]:
        log(f"{r['self_ms']:9.3f} {100 * r['self_ms'] / max(total, 1e-9):6.1f} {r['count']:>6}  "
            f"[{r['category']}] {r['name'][:120]}")
    return {"total_ms": total, "by_category": by_cat, "rows": rows}


def _newest_trace(out_dir: str) -> str:
    return max(glob.glob(os.path.join(out_dir, "trace-*.json")), key=os.path.getmtime)


def trace(cfg: PipelineConfig | None = None, *, depth: bool = False, out_dir: str = OUT,
          device="cuda", log=print) -> dict:
    """Trace the chained steps (or with `depth` the compute_depth calls) into
    `out_dir` and :func:`parse` the trace; the result also holds its
    "path" and "what" was traced."""
    dev = resolve_device(device)
    cfg = fast_config() if cfg is None else cfg
    c = cfg.camera
    frames = frames_for(cfg, FRAMES, dev)
    state, _ = init(*frames[0], cfg, device=dev)
    left, right = frames[1]
    if depth:
        what = f"depth x{DEPTH_CALLS}"

        def run():
            for _ in range(DEPTH_CALLS):
                out = compute_depth(left, right, c, cfg.depth)
            return out
    else:
        what = f"step x{(FRAMES - 1) * PASSES}"

        def run():
            s = state
            for fl, fr in frames[1:] * PASSES:
                s, out = step(s, fl, fr, cfg)
            return out

    run()  # warm
    with device_trace(out_dir, device=dev):
        run()
    path = _newest_trace(out_dir)
    log(f"trace of {what}: {path}")
    return {"path": path, "what": what, **parse(path, log=log)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", action="store_true", help="trace compute_depth calls")
    ap.add_argument("--out", default=OUT, help="directory for the Chrome trace")
    ap.add_argument("--parse", default=None, metavar="TRACE", help="only read a saved trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)
    if args.parse:
        parse(args.parse, log=log)
        return 0
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)} [{card_line(dev.index or 0)}]")
    trace(depth=args.depth, out_dir=args.out, device=dev, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
