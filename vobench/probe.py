"""The batched step at several lane counts: peak memory (frames included),
step rate, the step's tail, and from a short trace the device's idle share,
launches and host reads per step.

    python3 vobench/probe.py --workload <cell> --lanes 22 44 66 --seconds 20

Each count renders its own frames (lanes s = 0..n-1 of the cell's traffic)
and runs a window of `--seconds` untraced, then `trace_steps` traced steps.
One JSON line per count. Used to choose the cells' lane counts (PERF.md).
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def probe(cell, seconds: float, device: str = "cuda") -> dict:
    import torch

    from odometry_torch.distributed import sweep as sweep_mod

    from vobench import harness
    from vobench.stats import percentile

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    left, right = harness.render_frames(cell, cell.lanes, device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    cfg, mesh = harness.setup_program(cell, device)
    harness.warm_up(left, right, cfg, mesh, int(cell.traffic.get("warmup_steps", 2)), sweep_mod)
    win = harness.run_window(left, right, cfg, mesh, seconds)
    steps = [s for s in win.steps if s["kind"] == "step"]
    row = {"workload": cell.name, "lanes": len(cell.lanes), "render_s": render_s,
           "window_s": win.window_s, "steps": len(win.steps),
           "seq_frames_per_s": win.frames_done / win.window_s,
           "step_median_ms": 1e3 * percentile([s["t1"] - s["t0"] for s in steps], 50),
           "step_p90_ms": 1e3 * percentile([s["t1"] - s["t0"] for s in steps], 90),
           "lm_iters_per_step": sum(win.lm_iters) / max(len(win.lm_iters), 1),
           "depth_runs_per_step": sum(win.launches.values()) / len(win.steps),
           "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    del win
    tw = harness.run_window(left, right, cfg, mesh, 0.0,
                            trace_steps=int(cell.traffic.get("trace_steps", 8)))
    t = tw.trace
    row.update(traced_steps=t.steps, idle_pct=100.0 * (1.0 - t.busy_s / t.window_s),
               launches_per_step=t.kernels / t.steps, dtoh_per_step=t.dtoh_copies / t.steps,
               busy_ms_per_step=1e3 * t.busy_s / t.steps,
               traced_ms_per_step=1e3 * t.window_s / t.steps, breakdown=t.breakdown())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lanes", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from vobench import harness

    base = harness.load_cell(args.workload)
    for n in args.lanes:
        cell = dataclasses.replace(base, traffic=dict(base.traffic, lane_seeds=[0, n]))
        try:
            row = probe(cell, args.seconds)
        except torch.cuda.OutOfMemoryError as e:
            row = {"workload": cell.name, "lanes": n, "error": str(e)[:300]}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
