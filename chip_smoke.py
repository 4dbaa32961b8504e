"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero and
prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the three kernels from ``odometry_torch/csrc`` with nvcc, one
   process each, started together (the band kernel B1, the full-search
   kernel B2 and the all-gather B3), and print what ``-Xptxas -v`` says;
3. each SSD kernel against its plain PyTorch version on the card: cases on
   selected pixels, dense every-pixel winner maps at KITTI size, and one
   ``second_best`` case each, under the parity budgets below; B1 and B2
   against their plain version bit for bit on ``tie_stereo_pair`` images
   (exact SSDs, exact ties; B1 also on a band narrower than its blocking's
   spread and at widths that are not a multiple of 128), and B2 with
   ``max_disparity=192`` against B1 bit for bit at KITTI size (both score
   pairs with ``ssd8.cuh``);
4. kernel and plain-version times at the KITTI shape: B1 on fast_config's
   band (and B2 on the same band beside it), B2 on the full search and on
   accurate_config's band [12, 1241], each as the device time of
   back-to-back calls and as CUDA events around one call (which also hold
   the host's enqueue);
5. the fast_config odometry path end to end at 376x1241 (the workload of
   ``bench.py``): 3 trajectory seeds x 49 frames rendered on the card with
   the texture phase rounded as bench.py's TPU rounded it (``tpu_phase_scene``),
   the median mean-translation-error gate of ``bench.py`` (< 0.15), B1's
   launch count against the number of depth runs, and no launch of B2;
6. accurate_config end to end at 376x1241 on the driving family of
   ``tools/accuracy_sweep.py`` (3 seeds x 49 frames): the same gate, B2's
   launches against the depth runs (every frame), no launch of B1;
7. kitti_config end to end at 376x1241 on seed 4 of that family (49 frames):
   every state tensor on the card, B2's launches against the depth runs;
8. the dense tracking engine: kitti_config with ``engine="dense"``, seed 4,
   10 frames, B2's launches against the depth runs;
9. the all-gather kernel B3 against its plain version (the ring's schedule)
   and ``torch.cat``, bit for bit, on meshes of 1 to 8 virtual ranks of the
   card, shards of float32, float16 and int8 and at a 4-byte storage offset,
   the full width (8 ranks of 7 x 16384 float32) 200 times back to back,
   and the kernel, plain-version and ``torch.cat`` times beside the bound at
   full width and above the L2 (8 ranks of 7 x 131072 float32);
10. the sweep: ``run_sweep`` of fast_config on ``sequence_mesh(3)`` (three
    virtual ranks of the card) over phase 5's frames, gated as phase 5, with
    ``global_ok`` on every frame; one keyframe store per sequence filled as
    ``run_slam`` fills it (frame 0 and every promotion);
11. the stores' BA windows: the ring on their window poses and point blocks
    (bit for bit against the plain version), ``ba_solve`` motion-only (as
    ``run_slam`` runs it) and with free depths, and ``ba_solve_sharded`` on
    ``grid_mesh(1, 8)``: motion-only held to ``ba_solve`` within 2e-4 (poses)
    and 1e-4 (inverse depths), free depths on cost and finiteness (ROADMAP
    C9).

Each path's launch counts are set to 0 just before it runs and read just
after. The second-to-last line is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
from odometry_torch.config import accurate_config, fast_config, kitti_config
from odometry_torch.data.synthetic import (
    PlaneScene,
    drive_trajectory,
    make_driving_scene,
    make_scene,
    render_stereo,
    tie_stereo_pair,
)
from odometry_torch.distributed import ring_exchange
from odometry_torch.distributed.ba_dist import ba_solve_sharded
from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh
from odometry_torch.distributed.sweep import run_sweep
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.image.pyramid import gaussian_blur3
from odometry_torch.kernels import _build, disparity_band, disparity_full
from odometry_torch.kernels.disparity import _finalize, pattern_stack
from odometry_torch.kernels.select import select_points
from odometry_torch.mapping.ba import BAConfig, BAProblem, ba_solve
from odometry_torch.mapping.keyframe import create_store, insert_keyframe, window_slots
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.pipeline.runner import run_sequence

KITTI = (376, 1241)
# fast_config's and accurate_config's bands at KITTI size start at min_d =
# int(fx * baseline / max_depth) = 12 (depth/estimator.py:search_band);
# fast_config's ends at 192, accurate_config's at the image width.
MIN_D = 12
W_KITTI = KITTI[1]
# The two kernels: (wrapper, plain version).
KERNELS = {
    "band": (disparity_band.disparity_band, disparity_band.disparity_band_plain),
    "full": (disparity_full.disparity_full, disparity_full.disparity_full_plain),
}
# (kernel, H, W, min_disparity, max_disparity, seed); None is the band
# [1, max_d], or the full search for max_d.
SELECTED_CASES = (
    ("band", 48, 256, None, 64, 0), ("band", 64, 384, None, 192, 0),
    ("band", 376, 1241, MIN_D, 192, 0), ("band", 376, 1241, MIN_D, 192, 2),
    ("band", 376, 1241, MIN_D, 192, 5),
    ("full", 48, 96, None, None, 0), ("full", 64, 384, None, None, 0),
    ("full", 376, 1241, None, None, 0), ("full", 376, 1241, None, None, 2),
    ("full", 376, 1241, None, None, 5),
)
# accurate_config's band, lr on only (as accurate_config runs it).
SELECTED_LR_CASES = (("full", 376, 1241, MIN_D, W_KITTI, 0),)
DENSE_CASES = (("band", 376, 1241, MIN_D, 192, 7), ("band", 376, 1241, MIN_D, 192, 0),
               ("full", 376, 1241, None, None, 7), ("full", 376, 1241, None, None, 0))
SECOND_CASES = (("band", 376, 1241, MIN_D, 192, 0), ("full", 376, 1241, None, None, 0))
# B1 and B2 against their plain version bit for bit on tie_stereo_pair images
# (exact SSDs, exact ties a period apart): (kernel, H, W, min_disparity,
# max_disparity), None the full search and "W" the image width. B1's [12, 28]
# is narrower than its blocking's spread (24 offsets), [12, 40] just wider.
TIE_CASES = (("full", 48, 96, None, None), ("full", 64, 384, None, None),
             ("full", 48, 96, MIN_D, "W"), ("full", 64, 384, MIN_D, "W"),
             ("full", 376, 1241, None, None), ("full", 376, 1241, MIN_D, "W"),
             ("band", 48, 256, None, 64), ("band", 64, 384, MIN_D, 192),
             ("band", 376, 1241, MIN_D, 192), ("band", 48, 200, MIN_D, 40),
             ("band", 48, 200, MIN_D, 28))
# B2 against B1 bit for bit on fast_config's band at KITTI size: both score
# pairs with ssd8() (a guard on both kernels and on ssd8.cuh): seeds.
BAND_EQUAL_SEEDS = (0, 7)
# The H100's published peaks (NVIDIA data sheet, SXM): float32 outside the
# tensor cores, and HBM3. One (x, xr) pair's SSD is about 24 float32
# operations: 8 subtractions, 1 multiply, 7 fused multiply-adds counted as two.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_PAIR = 24
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


def _selected_case(kernel, H, W, min_d, D, seed, lr, failures, errs):
    ls, rs = _stereo(H, W, seed)
    fn, plain = KERNELS[kernel]
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=D, lr=lr)
    bk, mk, rk, _ = fn(ls, rs, **kw)
    torch.cuda.synchronize()
    bp, mp, rp, _ = plain(ls, rs, **kw)
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
    errs[kernel].append(err)
    label = f"{kernel} H{H} W{W} d[{min_d or 1},{D or 'W'}] s{seed} lr={lr}"
    print(f"{'PASS' if ok else 'FAIL'}  {label}: matched={n} flips={int(flip.sum())} "
          f"matched_diff={match_diff} budget={budget} ties_ok={tie_ok} "
          f"max|dbest|={err:.4f}", flush=True)
    if not ok:
        failures.append(label)


def _dense_case(kernel, H, W, min_d, D, seed, failures, errs, second_best=False):
    ls, rs = _stereo(H, W, seed)
    fn, plain = KERNELS[kernel]
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=D, lr=True,
              second_best=second_best)
    bk, mk, rk, sk = fn(ls, rs, **kw)
    torch.cuda.synchronize()
    bp, mp, rp, sp = plain(ls, rs, **kw)
    torch.cuda.synchronize()
    pairs = _Pairs(ls, rs)
    interior = torch.zeros((H, W), dtype=torch.bool, device=ls.device)
    # Columns whose candidate set is the kernel's full band (the band
    # kernel's) or that have candidates at all (the full search's).
    interior[4 : H - 4, (D if kernel == "band" else 0) + 8 : W - 4] = True
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
    errs[kernel].append(err)
    label = f"{kernel} dense H{H} W{W} d[{min_d or 1},{D or 'W'}] s{seed}" + (
        " second_best" if second_best else "")
    print(f"{'PASS' if ok else 'FAIL'}  {label}: {detail}", flush=True)
    if not ok:
        failures.append(label)


def _tie_case(kernel, H, W, min_d, max_d, failures):
    """A kernel against its plain version on tie_stereo_pair images, bit for bit."""
    ls, rs = (torch.from_numpy(a).cuda() for a in tie_stereo_pair(H, W, seed=H + W))
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=W if max_d == "W" else max_d,
              lr=True)
    fn, plain = KERNELS[kernel]
    got = fn(ls, rs, **kw)
    want = plain(ls, rs, **kw)
    torch.cuda.synchronize()
    diffs = [int((a != b).sum()) for a, b in zip(got[:3], want[:3])]
    ok = sum(diffs) == 0
    label = f"{kernel} tie H{H} W{W} d[{min_d or 1},{max_d or 'W'}]"
    print(f"{'PASS' if ok else 'FAIL'}  {label}: bitwise vs plain, differing best/match/rmatch "
          f"{diffs}", flush=True)
    if not ok:
        failures.append(label)


def _band_equal_case(seed, failures):
    """B2 with max_disparity=192 against B1 on the band [12, 192] at KITTI
    size, bit for bit on all four maps."""
    ls, rs = _stereo(*KITTI, seed)
    kw = dict(boundary=4, min_disparity=MIN_D, max_disparity=192, lr=True, second_best=True)
    full = disparity_full.disparity_full(ls, rs, **kw)
    band = disparity_band.disparity_band(ls, rs, **kw)
    torch.cuda.synchronize()
    diffs = [int((a != b).sum()) for a, b in zip(full, band)]
    ok = sum(diffs) == 0
    label = f"full vs band H{KITTI[0]} W{KITTI[1]} d[{MIN_D},192] s{seed}"
    print(f"{'PASS' if ok else 'FAIL'}  {label}: bitwise, differing best/match/rmatch/second "
          f"{diffs}", flush=True)
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


def _pairs(H, W, boundary, min_d, max_d):
    """(x, xr) pairs of one winner-map call: boundary <= xr, min_d <= x - xr
    <= max_d (None = the full search), for every row."""
    x = np.arange(W)
    lo = np.maximum(boundary, x - (W if max_d is None else max_d))
    hi = x - max(1, min_d or 1)
    return H * int(np.maximum(hi - lo + 1, 0).sum())


def _bound(H, W, boundary, min_d, max_d, lr):
    """(bound_ms, bound_by): the least time the card could take for one call,
    the larger of its operations over the float32 peak and its bytes (two
    images read once, each output map written once: best, match and, with
    `lr`, rmatch) over the HBM rate."""
    flop_s = FLOPS_PER_PAIR * _pairs(H, W, boundary, min_d, max_d) / PEAK_F32_FLOPS
    n_out = 2 + int(lr)
    byte_s = 4 * H * W * (2 + n_out) / PEAK_BYTES_PER_S
    return 1e3 * max(flop_s, byte_s), ("operations" if flop_s >= byte_s else "bytes")


def _timing(kernel, label, kw, card):
    """Kernel and plain-version times at the KITTI shape: device time per call
    of back-to-back calls (`_device_ms`, the kernels line's numbers), and the
    median of CUDA events around single calls, which also holds the host's
    enqueue (ctypes, the output allocations). For B1 also B2's device time on
    the same band, the port's other kernel for it (not a library call)."""
    fn, plain = KERNELS[kernel]
    ls, rs = _stereo(*KITTI, 0)
    for _ in range(3):
        fn(ls, rs, **kw)
        plain(ls, rs, **kw)
    ms = _device_ms(lambda: fn(ls, rs, **kw), 50)
    plain_ms = _device_ms(lambda: plain(ls, rs, **kw), 5)
    ev_ms = _time_ms(lambda: fn(ls, rs, **kw), 21)
    ev_plain_ms = _time_ms(lambda: plain(ls, rs, **kw), 7)
    bound_ms, bound_by = _bound(*KITTI, kw["boundary"], kw["min_disparity"],
                                kw["max_disparity"], kw["lr"])
    beside = ""
    if kernel == "band":
        full_ms = _device_ms(lambda: disparity_full.disparity_full(ls, rs, **kw), 50)
        beside = f"; B2 on the same band {full_ms:.4f} ms (device time)"
    print(f"timing {KITTI[0]}x{KITTI[1]} {kernel} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (device time of back-to-back calls); kernel {ev_ms:.4f} ms, plain "
          f"{ev_plain_ms:.4f} ms (median of CUDA events around one call, host enqueue "
          f"included); bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it"
          f"{beside} [{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _reset_counts():
    disparity_band.LAUNCHES = 0
    disparity_full.LAUNCHES = 0
    ring_exchange.LAUNCHES = 0


def _counts():
    """(B1, B2, B3) launches since the last reset."""
    return disparity_band.LAUNCHES, disparity_full.LAUNCHES, ring_exchange.LAUNCHES


def _state_leaves(state) -> list:
    """Every tensor of an OdometryState, nested tuples included."""
    leaves = []

    def collect(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
        elif isinstance(v, tuple):
            for u in v:
                collect(u)

    for f in dataclasses.fields(state):
        collect(getattr(state, f.name))
    return leaves


def _check_state_on_card(frames, cfg):
    """Every state tensor lives on the card after init and a step."""
    state, ok = init(*frames[0], cfg, device="cuda")
    state, _ = step(state, *frames[1], cfg)
    leaves = _state_leaves(state)
    if not leaves or not all(t.is_cuda for t in leaves):
        raise RuntimeError("a state tensor is not on the card")
    print(f"state: {len(leaves)} tensors, all on {leaves[0].device}", flush=True)


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

    _reset_counts()  # count this path's launches only
    results = []
    for seed, poses, frames in runs:
        summaries = []
        res = run_sequence(frames, cfg, device="cuda",
                           progress=lambda i, out: summaries.append(out.summary))
        results.append((seed, poses, res, summaries))
    launches, full_launches, _ = _counts()

    depth_runs = 0
    mtes = []
    for seed, poses, res, summaries in results:
        s = torch.stack(summaries).cpu().numpy()
        # A frame ran depth iff it reports survivors or a failed depth.
        depth_runs += 1 + int(((s[:, 37] > 0) | (s[:, 34] < 0.5)).sum())
        # The reference's eval_pose metric (run_odometry_kitti_offline.cpp:
        # 361-372): mean unaligned translation error.
        mte = mean_translation_error(poses[: res.num_frames], res.poses)
        mtes.append(mte)
        ms = float(np.median(res.per_frame_ms))
        print(f"e2e seed={seed}: frames={res.num_frames} mte={mte:.6f} "
              f"keyframes={len(res.keyframe_ids)} lost={len(res.lost_ids)} "
              f"fps={res.fps:.3f} median_ms_per_frame={ms:.3f} [{card}]", flush=True)
        if res.failed_at is not None:
            raise RuntimeError(f"seed {seed}: depth failed at frame {res.failed_at}")
    med = float(np.median(mtes))
    print(f"e2e median mte={med:.6f} (gate < 0.15); band-kernel launches={launches}, "
          f"full-search launches={full_launches}, depth runs={depth_runs}", flush=True)
    if not med < 0.15:
        raise RuntimeError(f"median mte {med} fails the gate 0.15 ({mtes})")
    if launches == 0 or launches != depth_runs:
        raise RuntimeError(f"band kernel launches {launches} != depth runs {depth_runs}")
    if full_launches != 0:
        raise RuntimeError(f"fast_config launched the full-search kernel {full_launches} times")
    _check_state_on_card(runs[0][2], cfg)
    return launches, runs, [res for _, _, res, _ in results]


def _driving_frames(seeds, num_frames, cfg):
    """The driving family of tools/accuracy_sweep.py:75-78, rendered on the
    card: make_driving_scene(s, side_x=20, wall_z=26), drive_trajectory(
    num_frames, step=0.25, seed=s)."""
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    out = {}
    for seed in seeds:
        scene = make_driving_scene(seed, side_x=20.0, wall_z=26.0, device="cuda")
        poses = drive_trajectory(num_frames, step=0.25, seed=seed)
        out[seed] = (poses, [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2]
                             for T in poses])
    torch.cuda.synchronize()
    return out


def _run_full_search_path(name, cfg, runs, card, **run_kw):
    """Drive one every-frame-depth path through run_sequence on the card with
    the launch counts set to 0 just before; return (mtes, results, B1
    launches, B2 launches). B2 must launch once per frame, counting init, and
    B1 never."""
    _reset_counts()
    results = [(seed, poses, run_sequence(frames, cfg, device="cuda", **run_kw))
               for seed, (poses, frames) in runs.items()]
    band_launches, full_launches, _ = _counts()
    depth_runs = sum(res.num_frames for _, _, res in results)
    mtes = []
    for seed, poses, res in results:
        mte = mean_translation_error(poses[: res.num_frames], res.poses)
        mtes.append(mte)
        ms = float(np.median(res.per_frame_ms))
        print(f"{name} seed={seed}: frames={res.num_frames} mte={mte:.6f} "
              f"failed_at={res.failed_at} keyframes={len(res.keyframe_ids)} "
              f"lost={len(res.lost_ids)} fps={res.fps:.3f} median_ms_per_frame={ms:.3f} "
              f"[{card}]", flush=True)
    print(f"{name}: full-search launches={full_launches}, band launches={band_launches}, "
          f"depth runs={depth_runs}", flush=True)
    if full_launches == 0 or full_launches != depth_runs:
        raise RuntimeError(f"{name}: full-search launches {full_launches} != depth runs "
                           f"{depth_runs}")
    if band_launches != 0:
        raise RuntimeError(f"{name}: launched the band kernel {band_launches} times")
    return mtes, results, full_launches


def _e2e_full_search(card):
    """accurate_config (3 seeds, gated), kitti_config and the dense engine
    (seed 4) at 376x1241 on the driving family, all through B2."""
    acc = accurate_config()
    runs = _driving_frames((4, 5, 11), 49, acc)
    mtes, results, launches_acc = _run_full_search_path("accurate_config", acc, runs, card)
    med = float(np.median(mtes))
    print(f"accurate_config median mte={med:.6f} (gate < 0.15; the reference's "
          f"accurate/driving median over 5 seeds on TPU-rendered frames was 0.0431, "
          f"ACCURACY.md, an accuracy figure only)", flush=True)
    for seed, _, res in results:
        if res.failed_at is not None:
            raise RuntimeError(f"accurate_config seed {seed}: depth failed at frame "
                               f"{res.failed_at}")
    if not med < 0.15:
        raise RuntimeError(f"accurate_config median mte {med} fails the gate 0.15 ({mtes})")

    kitti = kitti_config()
    seed4 = {4: runs[4]}
    _, _, launches_kitti = _run_full_search_path("kitti_config", kitti, seed4, card,
                                                 stop_on_depth_failure=False)
    _check_state_on_card(runs[4][1], kitti)

    dense = dataclasses.replace(kitti, tracker=dataclasses.replace(kitti.tracker,
                                                                   engine="dense"))
    seed4_10 = {4: (runs[4][0][:10], runs[4][1][:10])}
    _, _, launches_dense = _run_full_search_path("kitti_config dense engine", dense, seed4_10,
                                                 card, stop_on_depth_failure=False)
    _check_state_on_card(runs[4][1], dense)
    return launches_acc + launches_kitti + launches_dense

# Phase 9: (ranks, shard shape, dtype, storage offset in elements) of the
# ring cases. The float32 ones copy in 16-byte vectors, the last of them the
# full width, a 7-keyframe BA window of fast_config point blocks per rank (xs,
# ys, inv_depth and intensity x 4096 lanes); a 30-byte float16 shard, a
# 35-byte int8 shard and a float32 shard 4 bytes into its storage take the
# kernel's byte and 4-byte paths.
RING_CASES = ((1, (4, 128), torch.float32, 0), (2, (3, 4, 4), torch.float32, 0),
              (3, (5, 4, 4), torch.float32, 0), (8, (4, 128), torch.float32, 0),
              (8, (3, 4, 4), torch.float32, 0), (3, (3, 5), torch.float16, 0),
              (8, (5, 7), torch.int8, 0), (4, (6, 33), torch.float32, 1),
              (8, (7, 16384), torch.float32, 0))
RING_REPEATS = 200
# A timing case above the 50 MB L2: 8 ranks of 7 x 131072 float32, 264 MB.
RING_ABOVE_L2 = (8, (7, 131072))


def _ring_shards(num, shape, dtype, offset, g):
    n = int(np.prod(shape))
    if dtype.is_floating_point:
        base = [torch.randn(n + offset, generator=g, device="cuda").to(dtype)
                for _ in range(num)]
    else:
        base = [torch.randint(-128, 128, (n + offset,), generator=g, device="cuda").to(dtype)
                for _ in range(num)]
    return [b[offset:].view(shape) for b in base]


def _device_ms(fn, reps):
    """Device time of one call of `fn` when `reps` calls run back to back:
    a sleep kernel keeps the card busy while the host enqueues the calls,
    so the host's launch overhead does not show (CUDA events around the
    calls, after the sleep)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # Cycles at up to 2 GHz: at a lower clock the sleep only lasts longer.
    torch.cuda._sleep(int(2e6 * (2.0 * reps * host_ms + 5.0)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _ring_timing(shards, card, reps):
    """Kernel, plain-version and torch.cat x num device times of one all-gather
    of `shards`, beside the bound."""
    num = len(shards)
    nbytes = shards[0].numel() * shards[0].element_size()
    ms = _device_ms(lambda: ring_exchange.ring_gather(shards), reps)
    plain_ms = _device_ms(lambda: ring_exchange.ring_gather_plain(shards), 5)
    library_ms = _device_ms(lambda: [torch.cat(shards) for _ in range(num)], reps)
    # Least bytes an all-gather on one card moves: every shard read once,
    # every rank's output written once.
    moved = num * nbytes + num * num * nbytes
    bound_ms = 1e3 * moved / PEAK_BYTES_PER_S
    print(f"timing ring ranks={num} shard={tuple(shards[0].shape)} {shards[0].dtype}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.cat x{num} {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes: {moved} B), {100 * bound_ms / ms:.1f}% of it (device time "
          f"of back-to-back calls, CUDA events) [{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms)


def _ring_phase(card):
    """Phase 9: B3 against its plain version and torch.cat, bit for bit;
    RING_REPEATS back-to-back launches at full width; times at full width and
    above the L2. Returns (full-width timing entry, [max |kernel - plain| per
    case])."""
    g = torch.Generator(device="cuda").manual_seed(9)
    errs = []
    for num, shape, dtype, offset in RING_CASES:
        shards = _ring_shards(num, shape, dtype, offset, g)
        outs = ring_exchange.ring_all_gather(shards, sequence_mesh(num), axis="seq")
        torch.cuda.synchronize()
        plain = ring_exchange.ring_gather_plain(shards)
        full = torch.cat(shards)
        ok = all(torch.equal(o, p) and torch.equal(o, full) for o, p in zip(outs, plain))
        errs.append(max(float((o.double() - p.double()).abs().max()) for o, p in zip(outs, plain)))
        label = f"ring ranks={num} shard={shape} {dtype} offset={offset}"
        print(f"{'PASS' if ok else 'FAIL'}  {label}: bitwise vs plain and torch.cat, "
              f"max|diff|={errs[-1]}", flush=True)
        if not ok:
            raise RuntimeError(f"ring_gather differs from its plain version at {label}")

    # The full-width case (the last, whose shards these are) RING_REPEATS
    # times back to back, no host read between launches; every output is
    # compared on the card.
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(RING_REPEATS):
        outs = ring_exchange.ring_gather(shards)
        bad = bad + torch.stack([(o != full).any() for o in outs]).sum()
    print(f"ring: {RING_REPEATS} back-to-back launches at ranks={num} shard={shape}: "
          f"{int(bad)} outputs differ", flush=True)
    if int(bad) != 0:
        raise RuntimeError(f"ring_gather: {int(bad)} outputs of {RING_REPEATS} repeats differ")

    timing = _ring_timing(shards, card, 100)
    num, shape = RING_ABOVE_L2
    _ring_timing([torch.randn(shape, generator=g, device="cuda") for _ in range(num)], card, 20)
    return timing, errs


def _state_devices_ok(states, mesh) -> bool:
    """Every tensor of each rank's state on that rank's device of the card."""
    return all(leaves and all(t.is_cuda and t.device == dev for t in leaves)
               for leaves, dev in zip(map(_state_leaves, states), mesh.axis_devices("seq")))


def _sweep_phase(card, runs, single_results):
    """Phase 10: run_sweep of fast_config on sequence_mesh(3) over phase 5's
    frames, gated as phase 5, global_ok on every frame; fills one keyframe
    store per sequence as run_slam does (pipeline/slam.py:124-128,200-205)
    and returns the stores."""
    cfg = fast_config()
    c = cfg.camera
    frames_per_seq = [frames for _, _, frames in runs]
    mesh = sequence_mesh(len(runs))
    summaries = [[] for _ in runs]
    health = []
    stores = []
    paths = [[0.0, None] for _ in runs]  # trajectory length, last position
    final = []

    def on_frame(i, states, outs, global_ok):
        health.append(bool(global_ok))
        final[:] = [states]
        for s, state in enumerate(states):
            kf = state.kf_track[0]
            if outs is None:
                stores.append(insert_keyframe(
                    create_store(32, cfg.tracker.point_capacity, c.height, c.width,
                                 device=state.kf_pose.device),
                    kf.pts, kf.intensity, state.kf_pose, 0, image=state.kf_pyr[0]))
                paths[s][1] = np.zeros(3, np.float32)
                continue
            summ = outs[s].summary.cpu().numpy()
            summaries[s].append(summ)
            pos = summ[:16].reshape(4, 4)[:3, 3]
            paths[s][0] += float(np.linalg.norm(pos - paths[s][1]))
            paths[s][1] = pos
            if summ[32] > 0.5:  # promoted
                stores[s] = insert_keyframe(stores[s], kf.pts, kf.intensity, state.kf_pose, i,
                                            image=state.kf_pyr[0], path=paths[s][0])

    _reset_counts()  # count this path's launches only
    t0 = time.perf_counter()
    poses = run_sweep(frames_per_seq, cfg, mesh, progress=on_frame)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    band, full, ring = _counts()

    num_frames = len(frames_per_seq[0])
    depth_runs, mtes = 0, []
    for s, (seed, truth, _) in enumerate(runs):
        summ = np.stack(summaries[s])
        depth_runs += 1 + int(((summ[:, 37] > 0) | (summ[:, 34] < 0.5)).sum())
        kf_ids = [0] + [i + 1 for i in np.nonzero(summ[:, 32] > 0.5)[0].tolist()]
        mte = mean_translation_error(truth, poses[s])
        mtes.append(mte)
        gap = float(np.abs(poses[s][:, :3, 3] - single_results[s].poses[:, :3, 3]).max())
        print(f"sweep seed={seed}: mte={mte:.6f} keyframes={kf_ids} (run_sequence: "
              f"{single_results[s].keyframe_ids}) max per-frame translation gap to "
              f"run_sequence={gap:.6e} m [{card}]", flush=True)
    med = float(np.median(mtes))
    rate = len(runs) * (num_frames - 1) / seconds
    print(f"sweep: {len(runs)} sequences x {num_frames} frames on {mesh.size} virtual ranks of "
          f"{mesh.devices[0]}: median mte={med:.6f} (gate < 0.15), global_ok on "
          f"{sum(health)}/{len(health)} frames, {rate:.3f} sequence-frames/s "
          f"({seconds:.3f} s, store inserts included); band-kernel launches={band}, "
          f"full-search launches={full}, ring launches={ring}, depth runs={depth_runs} "
          f"[{card}]", flush=True)
    if not med < 0.15:
        raise RuntimeError(f"sweep median mte {med} fails the gate 0.15 ({mtes})")
    if not all(health):
        raise RuntimeError(f"sweep: global_ok False on {health.count(False)} frames")
    if band == 0 or band != depth_runs or full != 0:
        raise RuntimeError(f"sweep: band launches {band} (depth runs {depth_runs}), "
                           f"full-search launches {full}")
    if not _state_devices_ok(final[0], mesh):
        raise RuntimeError("sweep: a state tensor is not on its rank's device of the card")
    print(f"sweep: every state tensor of the {len(runs)} ranks on {mesh.devices[0]}",
          flush=True)
    return stores


def _store_ba_phase(card, stores):
    """Phase 11: the ring on the stores' window poses and point blocks, and
    BA on each window, single and sharded over grid_mesh(1, 8). Returns the
    ring's launches on the windows."""
    cfg = fast_config()
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    W = min(5, min(int(st.count) for st in stores))
    print(f"stores: keyframes {[int(st.count) for st in stores]}, window W={W}", flush=True)
    if W < 2:
        raise RuntimeError(f"stores hold too few keyframes for a BA window ({W})")
    slots = [window_slots(st, W) for st in stores]
    mesh = sequence_mesh(len(stores))

    _reset_counts()  # count this path's launches only
    poses = [st.pose[sl] for st, sl in zip(stores, slots)]
    blocks = [torch.cat([st.xs[sl], st.ys[sl], st.inv_depth[sl], st.intensity[sl]], dim=1)
              for st, sl in zip(stores, slots)]
    got = (ring_exchange.gather_keyframe_poses(poses, mesh, axis="seq"),
           ring_exchange.ring_all_gather(blocks, mesh, axis="seq"))
    torch.cuda.synchronize()
    _, _, ring = _counts()
    for name, outs, shards in (("poses", got[0], poses), ("point blocks", got[1], blocks)):
        plain = ring_exchange.ring_gather_plain(shards)
        ok = all(torch.equal(o, p) for o, p in zip(outs, plain))
        print(f"{'PASS' if ok else 'FAIL'}  ring on the window {name}: {len(shards)} ranks of "
              f"{tuple(shards[0].shape)}, bitwise vs plain", flush=True)
        if not ok:
            raise RuntimeError(f"ring on the window {name} differs from its plain version")
    if ring != 2:
        raise RuntimeError(f"ring launches on the windows: {ring}, expected 2")

    model = grid_mesh(1, 8)
    for s, (st, sl) in enumerate(zip(stores, slots)):
        problem = BAProblem(images=st.image[sl], xs=st.xs[sl], ys=st.ys[sl],
                            inv_depth=st.inv_depth[sl], intensity=st.intensity[sl],
                            point_valid=st.point_valid[sl], pose=st.pose[sl],
                            kf_valid=st.occupied[sl])
        for fix in (True, False):
            bacfg = BAConfig(iters=4, fix_depths=fix, window=W)
            t0 = time.perf_counter()
            single = ba_solve(problem, cam, bacfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sharded = ba_solve_sharded(problem, cam, model, bacfg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dpose = float((sharded.pose - single.pose).abs().max())
            dinv = (sharded.inv_depth - single.inv_depth).abs()
            n1, n2 = int(single.num_residuals), int(sharded.num_residuals)
            c0, c1 = float(single.cost_initial), float(single.cost_final)
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (single.pose, single.inv_depth, sharded.pose, sharded.inv_depth))
            ok = (finite and c1 <= c0
                  and float(sharded.cost_final) <= float(sharded.cost_initial))
            if fix:
                # run_slam's BA (slam.py:112): held to ba_solve as
                # tests/test_distributed.py:81-87 holds the reference.
                ok = ok and dpose <= 2e-4 and float(dinv.max()) <= 1e-4 and n1 == n2
                gates = "gated: dpose <= 2e-4, dinv <= 1e-4, equal residuals"
            else:
                # Free depths: lanes with a near-zero depth Hessian take steps
                # of bd / Hdd that float32 rounding decides, so the single and
                # the sharded solve part (the reference's own two do on such
                # windows; ROADMAP C9). Gated on cost and finiteness only.
                gates = (f"not gated against ba_solve (ROADMAP C9): "
                         f"{int((dinv > 1e-4).sum())} lanes differ by > 1e-4")
            print(f"{'PASS' if ok else 'FAIL'}  BA store {s} W={W} P={problem.xs.shape[1]} "
                  f"fix_depths={fix}: cost {c0:.6f} -> {c1:.6f} (sharded "
                  f"{float(sharded.cost_final):.6f}), residuals {n1}/{n2}, max|dpose|="
                  f"{dpose:.3e}, max|dinv|={float(dinv.max()):.3e} ({gates}); ba_solve "
                  f"{1e3 * (t1 - t0):.3f} ms, ba_solve_sharded (8 ranks) {1e3 * (t2 - t1):.3f} "
                  f"ms [{card}]", flush=True)
            if not ok:
                raise RuntimeError(f"BA on store {s} (fix_depths={fix}) fails its gates")
    return ring


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
    built = _build.build_all(["disparity_band", "disparity_full", "ring_gather"])
    print(f"build: all kernels in {time.perf_counter() - t0:.3f} s", flush=True)
    for name, (lib_path, seconds) in built.items():
        _build.load(name)
        print(f"build: {lib_path.name} in {seconds:.3f} s", flush=True)
        log = lib_path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    failures, errs = [], {"band": [], "full": []}
    for case in SELECTED_CASES:
        for lr in (False, True):
            _selected_case(*case, lr, failures, errs)
    for case in SELECTED_LR_CASES:
        _selected_case(*case, True, failures, errs)
    for case in DENSE_CASES:
        _dense_case(*case, failures, errs)
    for case in SECOND_CASES:
        _dense_case(*case, failures, errs, second_best=True)
    for case in TIE_CASES:
        _tie_case(*case, failures)
    for seed in BAND_EQUAL_SEEDS:
        _band_equal_case(seed, failures)
    if failures:
        raise RuntimeError(f"kernel parity failed: {failures}")

    timing = {
        "band": _timing("band", "band [12, 192] lr",
                        dict(boundary=4, min_disparity=MIN_D, max_disparity=192, lr=True), card),
        "full": _timing("full", "full search lr",
                        dict(boundary=4, min_disparity=None, max_disparity=None, lr=True), card),
    }
    _timing("full", f"band [12, {W_KITTI}] lr",
            dict(boundary=4, min_disparity=MIN_D, max_disparity=W_KITTI, lr=True), card)

    band_launches, e2e_runs, e2e_results = _e2e(card)
    launches = {"band": band_launches, "full": _e2e_full_search(card)}

    timing["ring"], errs["ring"] = _ring_phase(card)
    stores = _sweep_phase(card, e2e_runs, e2e_results)
    launches["ring"] = _store_ba_phase(card, stores)

    sources = {
        "band": ("disparity_band", "odometry_torch/csrc/disparity_band.cu",
                 "odometry_tpu/kernels/disparity_pallas.py:124"),
        "full": ("disparity_full", "odometry_torch/csrc/disparity_full.cu",
                 "odometry_tpu/kernels/disparity_pallas.py:69"),
        "ring": ("ring_gather", "odometry_torch/csrc/ring_gather.cu",
                 "odometry_tpu/distributed/ring_exchange.py:47"),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": max(errs[k]),
        "library_ms": None,
        **timing[k],
    } for k, (name, source, replaces) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
