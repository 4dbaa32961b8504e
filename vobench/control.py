"""The readings that the check's limits are set from, for one cell.

    python3 vobench/control.py --workload <cell> --seconds <s> --seeds <n> ... \
        [--control <k>] [--out <file>]

In one process (the frames rendered and the program set up once): for each
seed a window of the cell's own load, then the check's readings of the
program (the lower readings), and for the first `k` seeds (default 3) those
of the control: the plain reference computed in bfloat16 in the program's
place, on the same steps and states (the upper readings). One JSON line per
seed, on standard output and appended to `--out`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, seconds: float, controls: int, device: str, out=None,
             step_fn=None) -> list:
    import torch

    from odometry_torch.distributed import sweep as sweep_mod

    from vobench import check, harness

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    left, right = harness.render_frames(cell, harness.lane_order(cell, seeds[0]), device)
    cfg, mesh = harness.setup_program(cell, device)
    harness.warm_up(left, right, cfg, mesh, int(cell.traffic.get("warmup_steps", 2)), sweep_mod)
    rows = []
    for n, seed in enumerate(seeds):
        win = harness.run_window(left, right, cfg, mesh, seconds, step_fn=step_fn)
        t0 = time.perf_counter()
        detail = {}
        row = {"workload": cell.name, "seed": seed, "steps": len(win.steps),
               "program": check.check(cell, win, left, right, seed, device=device,
                                      detail=detail)}
        row["check_s"] = time.perf_counter() - t0
        row["program_steps"] = detail
        if n < controls:
            detail = {}
            row["control"] = check.check(cell, win, left, right, seed, device=device,
                                         mode="control", detail=detail)
            row["control_steps"] = detail
        del win
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(line + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from vobench import harness

    if not torch.cuda.is_available():
        print("vobench: control: no CUDA card", file=sys.stderr)
        return 2
    readings(harness.load_cell(args.workload), args.seeds, args.seconds, args.control, "cuda",
             args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
