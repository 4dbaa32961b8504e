"""Hold the port's full-search kernel B2 against another build of its source.

Run from the repository root on a machine with a CUDA card, with the other
source unpacked into a gitignored directory, e.g. an earlier commit's:

    mkdir -p build/b2_parent
    git show <commit>:odometry_torch/csrc/disparity_full.cu > build/b2_parent/disparity_full.cu
    PYTHONPATH=. python3 tools/torch_b2_against_parent.py build/b2_parent/disparity_full.cu

The other source is built with the port's nvcc flags (it includes
``csrc/ssd8.cuh``) and launched through the same C signature. At 376x1241, on
``chip_smoke.py``'s stereo pairs (seeds 0, 2, 5, 7), the full search and the
band [12, 1241], each with lr and ``second_best``, the script prints how many
entries of best, match, rmatch and second differ, and both kernels' device
times (back-to-back calls, lr on, no second), taken in turns (other, this,
this, other). It exits non-zero if any entry differs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from odometry_torch.kernels import _build, disparity_full


def _load_other(src: Path) -> ctypes.CDLL:
    out = _build.BUILD_DIR / f"lib{src.stem}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(out), str(src)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    return ctypes.CDLL(str(out))


def _other(lib, ls, rs, *, boundary, min_disparity, max_disparity, lr, second_best=False,
           second_excl=2):
    fn = lib.disparity_full_launch
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
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke._card_line()
    lib = _load_other(Path(sys.argv[1]))
    _build.load("disparity_full")
    bands = {"full search": (None, None), f"band [12, {chip_smoke.W_KITTI}]":
             (chip_smoke.MIN_D, chip_smoke.W_KITTI)}
    differ = 0
    for seed in (0, 2, 5, 7):
        ls, rs = chip_smoke._stereo(*chip_smoke.KITTI, seed)
        for name, (min_d, max_d) in bands.items():
            kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=True,
                      second_best=True)
            a = disparity_full.disparity_full(ls, rs, **kw)
            b = _other(lib, ls, rs, **kw)
            torch.cuda.synchronize()
            diffs = [int((x != y).sum()) for x, y in zip(a, b)]
            differ += sum(diffs)
            print(f"seed {seed} {name} lr second_best: differing best/match/rmatch/second "
                  f"{diffs}", flush=True)
    ls, rs = chip_smoke._stereo(*chip_smoke.KITTI, 0)
    for name, (min_d, max_d) in bands.items():
        kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=True)
        this = lambda: disparity_full.disparity_full(ls, rs, **kw)
        other = lambda: _other(lib, ls, rs, **kw)
        t = [chip_smoke._device_ms(f, 50) for f in (other, this, this, other)]
        print(f"timing 376x1241 {name} lr: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / "
              f"{t[2]:.4f} ms (device time of back-to-back calls, in turns) [{card}]",
              flush=True)
    print(f"{'PASS' if differ == 0 else 'FAIL'}: {differ} entries differ", flush=True)
    return 0 if differ == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
