"""Hold one of the port's SSD kernels against another build of its source.

Run from the repository root on a machine with a CUDA card, with the other
source unpacked into a gitignored directory, e.g. an earlier commit's kernel
sources:

    mkdir -p build/parent
    git archive <commit> odometry_torch/csrc | tar -x -C build/parent
    # the full-search kernel B2 (the default)
    PYTHONPATH=. python3 tools/torch_b2_against_parent.py \\
        build/parent/odometry_torch/csrc/disparity_full.cu
    # the band kernel B1
    PYTHONPATH=. python3 tools/torch_b2_against_parent.py --kernel band \\
        build/parent/odometry_torch/csrc/disparity_band.cu

The other source is built with the port's nvcc flags. A quoted include is
looked up in the source's own directory first (so an earlier commit's headers
unpacked beside it are the ones it builds with), then in ``odometry_torch/csrc``. It is launched through the same C signature. At
376x1241, on ``chip_smoke.py``'s stereo pairs (seeds 0, 2, 5, 7), B2 on the
full search and the band [12, 1241], B1 on fast_config's band [12, 192], each
with lr and ``second_best``, the script prints how many entries of best,
match, rmatch and second differ, and both builds' device times (back-to-back
calls, lr on, no second), taken in turns (other, this, this, other); with
``--kernel band`` also B2's on the same band in the same turns. It exits
non-zero if any entry differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from odometry_torch.kernels import _build, disparity_band, disparity_full

KERNELS = {
    "full": ("disparity_full", disparity_full.disparity_full,
             {"full search": (None, None),
              f"band [12, {chip_smoke.W_KITTI}]": (chip_smoke.MIN_D, chip_smoke.W_KITTI)}),
    "band": ("disparity_band", disparity_band.disparity_band,
             {"band [12, 192]": (chip_smoke.MIN_D, 192)}),
}


def _load_other(src: Path) -> ctypes.CDLL:
    tag = hashlib.sha256(str(src.resolve()).encode()).hexdigest()[:8]
    out = _build.BUILD_DIR / f"lib{src.stem}-other-{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(out), str(src)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    return ctypes.CDLL(str(out))


def _other(lib, name, ls, rs, *, boundary, min_disparity, max_disparity, lr, second_best=False,
           second_excl=2):
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    H, W = ls.shape
    best = torch.empty((H, W), dtype=torch.float32, device=ls.device)
    match = torch.empty((H, W), dtype=torch.int32, device=ls.device)
    rmatch = torch.zeros((H, W), dtype=torch.int32, device=ls.device)
    second = torch.full((H, W), 1e10, dtype=torch.float32, device=ls.device)
    rc = fn(ls.data_ptr(), rs.data_ptr(), best.data_ptr(), match.data_ptr(),
            rmatch.data_ptr() if lr else None, second.data_ptr() if second_best else None, H, W,
            boundary, max(1, min_disparity or 1), W if max_disparity is None else max_disparity,
            second_excl, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"other build's launch failed: cudaError {rc}")
    return best, match, rmatch, second


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", type=Path, help="the other build's .cu source")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="full")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke._card_line()
    name, this_fn, bands = KERNELS[args.kernel]
    lib = _load_other(args.source)
    _build.load(name)
    differ = 0
    for seed in (0, 2, 5, 7):
        ls, rs = chip_smoke._stereo(*chip_smoke.KITTI, seed)
        for label, (min_d, max_d) in bands.items():
            kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=True,
                      second_best=True)
            a = this_fn(ls, rs, **kw)
            b = _other(lib, name, ls, rs, **kw)
            torch.cuda.synchronize()
            diffs = [int((x != y).sum()) for x, y in zip(a, b)]
            differ += sum(diffs)
            print(f"seed {seed} {args.kernel} {label} lr second_best: differing "
                  f"best/match/rmatch/second {diffs}", flush=True)
    ls, rs = chip_smoke._stereo(*chip_smoke.KITTI, 0)
    for label, (min_d, max_d) in bands.items():
        kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=True)
        runs = {"other": lambda: _other(lib, name, ls, rs, **kw),
                "this": lambda: this_fn(ls, rs, **kw)}
        if args.kernel == "band":
            runs["B2"] = lambda: disparity_full.disparity_full(ls, rs, **kw)
        order = list(runs) + list(runs)[::-1]
        times = {k: [] for k in runs}
        for k in order:
            times[k].append(chip_smoke._device_ms(runs[k], 50))
        shown = ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in times.items())
        print(f"timing 376x1241 {args.kernel} {label} lr: {shown} ms (device time of "
              f"back-to-back calls, in turns {'-'.join(order)}) [{card}]", flush=True)
    print(f"{'PASS' if differ == 0 else 'FAIL'}: {differ} entries differ", flush=True)
    return 0 if differ == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
