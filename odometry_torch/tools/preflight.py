"""One command that says GREEN before a snapshot of the port: the bench
line, the card's tests and the kernel parity harness (counterpart of
``tools/preflight.py``).

Each step runs as its own process from the checkout's root and prints one
line, ``[preflight] <step>: GREEN|RED (<s>s) <last line of its output>``;
the command exits non-zero on any RED.

* ``bench``: ``python -m odometry_torch.tools.bench`` (its accuracy gate
  and JSON line);
* ``pytest-<file>``: each of ``CARD_TESTS`` in its own pytest process with
  ``-m cuda`` (the card's machine has no JAX, hence ``--noconftest``; the
  port's other test files hold it against the reference on the CPU);
* ``kernel-parity``: ``python -m odometry_torch.tools.kernel_parity``.

Run on the card::

    python -m odometry_torch.tools.preflight            # all three
    python -m odometry_torch.tools.preflight --quick    # bench only
    python -m odometry_torch.tools.preflight --sweep    # and the accuracy sweep
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

from odometry_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
CARD_TESTS = ("tests/test_torch_cuda.py",)


def run(name: str, cmd, timeout: float, ok_codes=(0,), log=print) -> bool:
    """Run `cmd` from the checkout's root; GREEN when it exits with one of
    `ok_codes` within `timeout` seconds. Prints the step's line."""
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        ok = p.returncode in ok_codes
        tail = (p.stdout + p.stderr).strip().splitlines()[-1:] or [""]
        msg = tail[0][:140]
    except subprocess.TimeoutExpired:
        ok, msg = False, f"timeout after {timeout}s"
    log(f"[preflight] {name}: {'GREEN' if ok else 'RED'} ({time.time() - t0:.0f}s) {msg}")
    return ok


def steps(quick: bool = False, sweep: bool = False) -> list[tuple]:
    """(name, command, timeout s, ok exit codes) of each step."""
    py = sys.executable
    out = [("bench", [py, "-m", "odometry_torch.tools.bench"], 1200, (0,))]
    if not quick:
        # Exit 5: no test selected in the file, not a failure.
        out += [(f"pytest-{Path(f).stem.replace('test_', '')}",
                 [py, "-m", "pytest", "--noconftest", "-m", "cuda", f, "-q", "-x",
                  "-p", "no:cacheprovider"], 2400, (0, 5)) for f in CARD_TESTS]
        out.append(("kernel-parity", [py, "-m", "odometry_torch.tools.kernel_parity"], 1200,
                    (0,)))
    if sweep:
        out.append(("accuracy-sweep", [py, "-m", "odometry_torch.tools.accuracy_sweep"], 3600,
                    (0,)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="bench only")
    ap.add_argument("--sweep", action="store_true", help="also the accuracy sweep")
    args = ap.parse_args(argv)
    resolve_device("cuda")  # every step runs on the card
    log = lambda s: print(s, flush=True)
    results = [run(*s, log=log) for s in steps(args.quick, args.sweep)]
    log("[preflight] ALL GREEN" if all(results) else "[preflight] RED")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
