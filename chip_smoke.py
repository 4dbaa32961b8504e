"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero and
prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the band SSD kernel from ``odometry_torch/csrc`` with nvcc;
3. the kernel against its plain PyTorch version on the card: banded cases on
   selected pixels, dense every-pixel winner maps at KITTI size, and one
   ``second_best`` case, under the parity budgets below;
4. kernel and plain-version times at the KITTI shape, with CUDA events;
5. the fast_config odometry path end to end at 376x1241 (the workload of
   ``bench.py``): 3 trajectory seeds x 49 frames rendered on the card with
   the texture phase rounded as bench.py's TPU rounded it (``tpu_phase_scene``),
   the median mean-translation-error gate of ``bench.py`` (< 0.15), and the
   kernel's launch count against the number of depth runs.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import fast_config
from odometry_torch.data.synthetic import PlaneScene, drive_trajectory, make_scene, render_stereo
from odometry_torch.image.pyramid import gaussian_blur3
from odometry_torch.kernels import _build, disparity_band
from odometry_torch.kernels.disparity import _finalize, pattern_stack
from odometry_torch.kernels.select import select_points
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.pipeline.runner import run_sequence

KITTI = (376, 1241)
# fast_config's band at KITTI size: min_d = int(fx * baseline / max_depth) = 12
# (depth/estimator.py), max_d = 192.
MIN_D = 12
# (H, W, min_disparity, max_disparity, seed); None is the band [1, max_d].
BAND_CASES = ((48, 256, None, 64, 0), (64, 384, None, 192, 0), (376, 1241, MIN_D, 192, 0),
              (376, 1241, MIN_D, 192, 2), (376, 1241, MIN_D, 192, 5))
DENSE_CASES = ((376, 1241, MIN_D, 192, 7), (376, 1241, MIN_D, 192, 0))
# Parity budgets (after tools/tpu_parity.py:66-91,127-159). The kernel sums
# squared differences directly; the plain version expands
# ||L||^2 + ||R||^2 - 2 L.R, whose float32 rounding grows with the norms.
# A winner may differ only at a near-tie, where the plain version's SSDs of
# the two winners differ by less than TIE_ABS + TIE_REL * (ln + rn).
TIE_ABS = 0.5
TIE_REL = 8 * 2.0**-24
MAX_FLIP_FRACTION_SELECTED = 0.005
MAX_FLIP_FRACTION_DENSE = 0.01
SSD_TH = 900.0


class _TpuPhaseScene(PlaneScene):
    """The scene as bench.py's TPU rendered it, as far as that is known:
    ``jnp.einsum`` at the TPU's default precision rounds its operands to
    bf16, and in the texture phase ``freqs . p`` that moves a point 14 m
    away by up to 3 cm. The amplitude sums stay float32. On float32 frames
    at 376x1241 the reference itself misses bench.py's gate; on these it
    meets it, run on the CPU (PERF.md, ROADMAP C5)."""

    def texture(self, p: torch.Tensor) -> torch.Tensor:
        bf16 = lambda a: a.to(torch.bfloat16).float()
        s = torch.sin(bf16(p) @ bf16(self.freqs).T + self.phases)
        diff = p[:, None, :] - self.blob_centers
        r2 = torch.sum(diff * diff, dim=-1)
        return 127.5 + (s @ self.amps + torch.exp(-r2 * self.blob_inv2s2) @ self.blob_amps)


def tpu_phase_scene(scene: PlaneScene) -> PlaneScene:
    """`scene` rendering with the TPU's bf16 texture phase."""
    return _TpuPhaseScene(**{f.name: getattr(scene, f.name)
                             for f in dataclasses.fields(scene)})


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _stereo(H, W, seed):
    """Blurred synthetic stereo pair on the card (tools/tpu_parity.py:_stereo)."""
    cam = Pinhole.create(0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    scene = make_scene(seed + 3, depth=14.0, device="cuda")
    left, right, _ = render_stereo(scene, cam, 0.537, torch.eye(4), H, W)
    return gaussian_blur3(left).contiguous(), gaussian_blur3(right).contiguous()


class _Pairs:
    """Plain-version (norm-expansion) SSDs of chosen (row, x, xr) pairs."""

    def __init__(self, ls, rs):
        self.PL, self.PR = pattern_stack(ls), pattern_stack(rs)
        self.ln = torch.sum(self.PL * self.PL, dim=0)
        self.rn = torch.sum(self.PR * self.PR, dim=0)

    def ssd(self, y, x, xr):
        cross = torch.sum(self.PL[:, y, x] * self.PR[:, y, xr], dim=0)
        return self.ln[y, x] + self.rn[y, xr] - 2.0 * cross

    def band(self, y, x, xr):
        return TIE_ABS + TIE_REL * (self.ln[y, x] + self.rn[y, xr])


def _flips_are_ties(pairs, y, a, b) -> bool:
    """Winner flips at rows `y` are ties: pairs a = (x, xr) and b = (x, xr)
    score within the band of each other."""
    if y.numel() == 0:
        return True
    gap = (pairs.ssd(y, *a) - pairs.ssd(y, *b)).abs()
    tol = torch.maximum(pairs.band(y, *a), pairs.band(y, *b))
    return bool((gap < tol).all())


def _best_within_band(pairs, best_k, best_p, match_p, region):
    """|best_kernel - best_plain| within the band where x has candidates."""
    has = region & (best_p < 1e9)
    y, x = torch.nonzero(has, as_tuple=True)
    m = match_p[y, x].long()
    err = (best_k[y, x] - best_p[y, x]).abs()
    ok = bool((err <= pairs.band(y, x, m)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def _band_case(H, W, min_d, D, seed, lr, failures, errs):
    ls, rs = _stereo(H, W, seed)
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=D, lr=lr)
    bk, mk, rk, _ = disparity_band.disparity_band(ls, rs, **kw)
    torch.cuda.synchronize()
    bp, mp, rp, _ = disparity_band.disparity_band_plain(ls, rs, **kw)
    torch.cuda.synchronize()
    sel = select_points(ls, boundary=4, block_rows=8, block_cols=16, grad_th=8.0,
                        max_points_per_block=80)
    fin = dict(fx=0.58 * W, baseline=0.537, boundary=4, ssd_th=SSD_TH, lr_check=lr, lr_tol=1)
    rk_ = _finalize(ls, bk, mk, rk, sel, **fin)
    rp_ = _finalize(ls, bp, mp, rp, sel, **fin)
    pairs = _Pairs(ls, rs)
    both = rk_.matched & rp_.matched
    n = int(both.sum())
    flip = both & (mk != mp)
    y, x = torch.nonzero(flip, as_tuple=True)
    tie_ok = _flips_are_ties(pairs, y, (x, mk[y, x].long()), (x, mp[y, x].long()))
    match_diff = int((rk_.matched != rp_.matched).sum())
    val_ok, err = _best_within_band(pairs, bk, bp, mp, sel)
    budget = max(2, int(MAX_FLIP_FRACTION_SELECTED * n))
    ok = tie_ok and val_ok and int(flip.sum()) + match_diff <= budget
    errs.append(err)
    label = f"band H{H} W{W} d[{min_d or 1},{D}] s{seed} lr={lr}"
    print(f"{'PASS' if ok else 'FAIL'}  {label}: matched={n} flips={int(flip.sum())} "
          f"matched_diff={match_diff} budget={budget} ties_ok={tie_ok} "
          f"max|dbest|={err:.4f}", flush=True)
    if not ok:
        failures.append(label)


def _dense_case(H, W, min_d, D, seed, failures, errs, second_best=False):
    ls, rs = _stereo(H, W, seed)
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=D, lr=True,
              second_best=second_best)
    bk, mk, rk, sk = disparity_band.disparity_band(ls, rs, **kw)
    torch.cuda.synchronize()
    bp, mp, rp, sp = disparity_band.disparity_band_plain(ls, rs, **kw)
    torch.cuda.synchronize()
    pairs = _Pairs(ls, rs)
    interior = torch.zeros((H, W), dtype=torch.bool, device=ls.device)
    interior[4 : H - 4, D + 8 : W - 4] = True
    n = int(interior.sum())
    mflip = interior & (mk != mp)
    rflip = interior & (rk != rp)
    y, x = torch.nonzero(mflip, as_tuple=True)
    tie_f = _flips_are_ties(pairs, y, (x, mk[y, x].long()), (x, mp[y, x].long()))
    y, xr = torch.nonzero(rflip, as_tuple=True)
    tie_r = _flips_are_ties(pairs, y, (rk[y, xr].long(), xr), (rp[y, xr].long(), xr))
    val_ok, err = _best_within_band(pairs, bk, bp, mp, interior)
    ok = (tie_f and tie_r and val_ok and int(mflip.sum()) <= MAX_FLIP_FRACTION_DENSE * n
          and int(rflip.sum()) <= MAX_FLIP_FRACTION_DENSE * n)
    detail = (f"match_diff={int(mflip.sum())} rmatch_diff={int(rflip.sum())} n={n} "
              f"ties_ok={tie_f and tie_r} max|dbest|={err:.4f}")
    if second_best:
        # `second` is held to the plain version's semantics (the reference's
        # XLA path), where both versions picked the same winner.
        same = interior & (mk == mp) & (sp < 1e9)
        ys, xs = torch.nonzero(same, as_tuple=True)
        serr = (sk[ys, xs] - sp[ys, xs]).abs()
        rn_row = pairs.rn.amax(dim=1)
        tol = TIE_ABS + TIE_REL * (pairs.ln[ys, xs] + rn_row[ys])
        s_ok = bool((serr <= tol).all()) and bool(((sk >= 1e9) == (sp >= 1e9))[same].all())
        ok = ok and s_ok
        detail += f" second_ok={s_ok} max|dsecond|={float(serr.max()):.4f}"
    errs.append(err)
    label = f"dense H{H} W{W} d[{min_d or 1},{D}] s{seed}" + (
        " second_best" if second_best else "")
    print(f"{'PASS' if ok else 'FAIL'}  {label}: {detail}", flush=True)
    if not ok:
        failures.append(label)


def _time_ms(fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _e2e(card):
    """fast_config at KITTI size through the port's run_sequence, on the card."""
    cfg = fast_config()
    H, W = cfg.camera.height, cfg.camera.width
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = tpu_phase_scene(make_scene(3, depth=14.0, device="cuda"))
    runs = []
    for seed in (4, 5, 11):
        poses = drive_trajectory(49, step=0.35, seed=seed)
        frames = [render_stereo(scene, cam, c.baseline, T, H, W)[:2] for T in poses]
        torch.cuda.synchronize()
        runs.append((seed, poses, frames))

    disparity_band.LAUNCHES = 0  # count the main path's launches only
    results = []
    for seed, poses, frames in runs:
        summaries = []
        res = run_sequence(frames, cfg, device="cuda",
                           progress=lambda i, out: summaries.append(out.summary))
        results.append((seed, poses, res, summaries))
    launches = disparity_band.LAUNCHES

    depth_runs = 0
    mtes = []
    for seed, poses, res, summaries in results:
        s = torch.stack(summaries).cpu().numpy()
        # A frame ran depth iff it reports survivors or a failed depth.
        depth_runs += 1 + int(((s[:, 37] > 0) | (s[:, 34] < 0.5)).sum())
        # The reference's eval_pose metric (run_odometry_kitti_offline.cpp:
        # 361-372): mean unaligned translation error.
        gt = poses[: res.num_frames]
        mte = float(np.linalg.norm(res.poses[:, :3, 3] - gt[:, :3, 3], axis=1).mean())
        mtes.append(mte)
        ms = float(np.median(res.per_frame_ms))
        print(f"e2e seed={seed}: frames={res.num_frames} mte={mte:.6f} "
              f"keyframes={len(res.keyframe_ids)} lost={len(res.lost_ids)} "
              f"fps={res.fps:.3f} median_ms_per_frame={ms:.3f} [{card}]", flush=True)
        if res.failed_at is not None:
            raise RuntimeError(f"seed {seed}: depth failed at frame {res.failed_at}")
    med = float(np.median(mtes))
    print(f"e2e median mte={med:.6f} (gate < 0.15); band-kernel launches={launches}, "
          f"depth runs={depth_runs}", flush=True)
    if not med < 0.15:
        raise RuntimeError(f"median mte {med} fails the gate 0.15 ({mtes})")
    if launches == 0 or launches != depth_runs:
        raise RuntimeError(f"band kernel launches {launches} != depth runs {depth_runs}")

    # Every state tensor lives on the card after init and a step.
    frames = runs[0][2]
    state, ok = init(*frames[0], cfg, device="cuda")
    state, _ = step(state, *frames[1], cfg)
    leaves = []

    def collect(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
        elif isinstance(v, tuple):
            for u in v:
                collect(u)

    for f in type(state).__dataclass_fields__:
        collect(getattr(state, f))
    if not leaves or not all(t.is_cuda for t in leaves):
        raise RuntimeError("a state tensor is not on the card")
    print(f"state: {len(leaves)} tensors, all on {leaves[0].device}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build("disparity_band")
    _build.load("disparity_band")
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.3f} s", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)

    failures, errs = [], []
    for case in BAND_CASES:
        for lr in (False, True):
            _band_case(*case, lr, failures, errs)
    for case in DENSE_CASES:
        _dense_case(*case, failures, errs)
    _dense_case(*KITTI, MIN_D, 192, 0, failures, errs, second_best=True)
    if failures:
        raise RuntimeError(f"kernel parity failed: {failures}")

    ls, rs = _stereo(*KITTI, 0)
    kw = dict(boundary=4, min_disparity=MIN_D, max_disparity=192, lr=True)
    for _ in range(3):
        disparity_band.disparity_band(ls, rs, **kw)
        disparity_band.disparity_band_plain(ls, rs, **kw)
    ms = _time_ms(lambda: disparity_band.disparity_band(ls, rs, **kw), 21)
    plain_ms = _time_ms(lambda: disparity_band.disparity_band_plain(ls, rs, **kw), 7)
    print(f"timing {KITTI[0]}x{KITTI[1]} band [12, 192] lr: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (median, CUDA events) [{card}]", flush=True)

    launches = _e2e(card)

    print(json.dumps({"kernels": [{
        "name": "disparity_band",
        "route": "cuda",
        "source": "odometry_torch/csrc/disparity_band.cu",
        "replaces": "odometry_tpu/kernels/disparity_pallas.py:124",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
