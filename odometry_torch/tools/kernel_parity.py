"""Kernel parity harness on the card (counterpart of ``tools/tpu_parity.py``).

Holds the band-search kernel B1 (``csrc/disparity_band.cu``) and the
full-search kernel B2 (``csrc/disparity_full.cu``) against their plain
PyTorch version on the card, on blurred synthetic stereo pairs. The kernels
sum squared differences directly; the plain version expands
||L||^2 + ||R||^2 - 2 L.R, whose float32 rounding grows with the norms. So a
winner may differ only at a near-tie, where the plain version's SSDs of the
two winners differ by less than TIE_ABS + TIE_REL * (ln + rn), and flips
stay rare (budgets after ``tools/tpu_parity.py:66-91,127-159``).

Cases (``--case``):

* ``band``, ``full``, ``dense``: ``tools/tpu_parity.py``'s own cases at its
  sizes: selected pixels on the band [1, D] with the lr check off and on,
  the full search, and every interior pixel's winners at 376x1241. Besides
  the tie and flip budgets, |best_kernel - best_plain| stays within
  tpu_parity's value budget (0.5, dense 1.0, + |best| * 512 * 2^-23).
* ``selected``, ``winner_maps``: the same checks at the presets' bands
  (fast_config's [12, 192], accurate_config's [12, 1241], the full search)
  at 376x1241, and ``second`` held to the plain version where both picked
  the same winner;
* ``ties``: B1 and B2 bit for bit against the plain version on
  ``tie_stereo_pair`` images (exact SSDs, exact ties; B1 also on bands
  narrower than its blocking's spread and at widths that are not a multiple
  of 128), and B2 on the band [12, 192] bit for bit against B1;
* ``tiled``: rows too wide for one block (ROADMAP C10) bit for bit against
  the plain version at 8x6000, and the tiled route forced at 376x1241 bit
  for bit against the one-block route.

Usage (on a machine with a CUDA card; there is no interpreter to fall back
to, so without one it refuses)::

    python -m odometry_torch.tools.kernel_parity [--case NAME]

It prints one PASS/FAIL line per check and exits 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.data.synthetic import make_scene, render_stereo, tie_stereo_pair
from odometry_torch.device import card_line, resolve_device
from odometry_torch.image.pyramid import gaussian_blur3
from odometry_torch.kernels import disparity_band, disparity_full
from odometry_torch.kernels.disparity import _finalize, pattern_stack
from odometry_torch.kernels.select import select_points

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
# (kernel, H, W, min_disparity, max_disparity, seed) at the presets' bands;
# None is the band [1, max_d], or the full search for max_d.
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
# Bit for bit on tie_stereo_pair images: (kernel, H, W, min_disparity,
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
# ROADMAP C10: rows wider than a block's shared memory holds take the tiled
# route. (kernel, min_disparity, max_disparity) on WIDE tie images, lr on and off.
WIDE = (8, 6000)
WIDE_CASES = (("band", MIN_D, 192), ("full", None, None), ("full", MIN_D, W_KITTI))
# The tiled route forced at KITTI size against the one-block route, bit for
# bit on all four maps: (kernel, max_disparity), lr and second_best on.
FORCED_TILED_CASES = (("band", 192), ("full", None))
# Parity budgets. A winner may differ only at a near-tie (see the module
# docstring); flips at most these shares of the matched (selected) or
# interior (dense) pixels.
TIE_ABS = 0.5
TIE_REL = 8 * 2.0**-24
MAX_FLIP_FRACTION_SELECTED = 0.005
MAX_FLIP_FRACTION_DENSE = 0.01
SSD_TH = 900.0
# tools/tpu_parity.py's value budget: |dbest| <= abs + |best| * 512 * 2^-23
# (0.5 on selected pixels, 1.0 on every pixel).
TPU_VAL_REL = 512 * 2.0**-23


class Result(NamedTuple):
    label: str
    ok: bool
    detail: str
    kernel: str  # "band" or "full"
    err: float | None  # max |best_kernel - best_plain|; None for bitwise checks


def stereo(H, W, seed):
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


def _tpu_value_ok(best_k, best_p, region, val_abs) -> bool:
    """tools/tpu_parity.py's value budget over `region`."""
    d = (best_k - best_p)[region].abs()
    return bool((d <= val_abs + best_p[region].abs() * TPU_VAL_REL).all())


def _band_label(min_d, max_d):
    return f"d[{min_d or 1},{max_d or 'W'}]"


def _selected_case(kernel, H, W, min_d, D, seed, lr, results, val_abs=None):
    """Winners at select_points' pixels after ``_finalize`` (SSD threshold,
    lr check): flips and matched-set changes within the budget, flips at
    ties, best within the tie band (and tpu_parity's value budget when
    `val_abs` is given)."""
    ls, rs = stereo(H, W, seed)
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
    if val_abs is not None:
        val_ok = val_ok and _tpu_value_ok(bk, bp, both, val_abs)
    budget = max(2, int(MAX_FLIP_FRACTION_SELECTED * n))
    ok = tie_ok and val_ok and int(flip.sum()) + match_diff <= budget
    results.append(Result(
        f"{kernel} H{H} W{W} {_band_label(min_d, D)} s{seed} lr={lr}", ok,
        f"matched={n} flips={int(flip.sum())} matched_diff={match_diff} budget={budget} "
        f"ties_ok={tie_ok} max|dbest|={err:.4f}", kernel, err))
    return ok


def _dense_case(kernel, H, W, min_d, D, seed, results, second_best=False, val_abs=None):
    """Winner maps at every interior pixel: match and rmatch flips <= 1% and
    at ties, best within the tie band (and tpu_parity's value budget when
    `val_abs` is given); with `second_best`, ``second`` as the plain
    version's where both picked the same winner."""
    ls, rs = stereo(H, W, seed)
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
    if val_abs is not None:
        val_ok = val_ok and _tpu_value_ok(bk, bp, interior, val_abs)
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
    label = f"{kernel} dense H{H} W{W} {_band_label(min_d, D)} s{seed}" + (
        " second_best" if second_best else "")
    results.append(Result(label, ok, detail, kernel, err))
    return ok


def _bitwise(results, label, kernel, got, want, extra_ok=True):
    diffs = [int((a != b).sum()) for a, b in zip(got, want)]
    ok = sum(diffs) == 0 and extra_ok
    names = "/".join(("best", "match", "rmatch", "second")[: len(diffs)])
    results.append(Result(label, ok, f"bitwise, differing {names} {diffs}", kernel, None))
    return ok


def _tie_case(kernel, H, W, min_d, max_d, results):
    """A kernel against its plain version on tie_stereo_pair images, bit for
    bit on best, match and rmatch."""
    ls, rs = (torch.from_numpy(a).cuda() for a in tie_stereo_pair(H, W, seed=H + W))
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=W if max_d == "W" else max_d,
              lr=True)
    fn, plain = KERNELS[kernel]
    got = fn(ls, rs, **kw)
    want = plain(ls, rs, **kw)
    torch.cuda.synchronize()
    return _bitwise(results, f"{kernel} tie H{H} W{W} {_band_label(min_d, max_d)} vs plain",
                    kernel, got[:3], want[:3])


def _band_equal_case(seed, results):
    """B2 with max_disparity=192 against B1 on the band [12, 192] at KITTI
    size, bit for bit on all four maps."""
    ls, rs = stereo(*KITTI, seed)
    kw = dict(boundary=4, min_disparity=MIN_D, max_disparity=192, lr=True, second_best=True)
    full = disparity_full.disparity_full(ls, rs, **kw)
    band = disparity_band.disparity_band(ls, rs, **kw)
    torch.cuda.synchronize()
    return _bitwise(results, f"full vs band H{KITTI[0]} W{KITTI[1]} d[{MIN_D},192] s{seed}",
                    "full", full, band)


def _wide_case(kernel, min_d, max_d, lr, results):
    """A kernel on WIDE tie images (the tiled route) against its plain
    version, bit for bit on best, match and rmatch."""
    H, W = WIDE
    ls, rs = (torch.from_numpy(a).cuda() for a in tie_stereo_pair(H, W, seed=H + W))
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=lr)
    fn, plain = KERNELS[kernel]
    route = disparity_band.route(W, lr)
    got = fn(ls, rs, **kw)
    want = plain(ls, rs, **kw)
    torch.cuda.synchronize()
    return _bitwise(results, f"{kernel} tie H{H} W{W} {_band_label(min_d, max_d)} lr={lr} "
                    f"({route} route) vs plain", kernel, got[:3], want[:3],
                    extra_ok=route == disparity_band.TILED)


def _forced_tiled_case(kernel, max_d, results):
    """At KITTI size the tiled route, forced, against the one-block route,
    bit for bit on all four maps."""
    ls, rs = stereo(*KITTI, 0)
    fn, _ = KERNELS[kernel]
    kw = dict(boundary=4, min_disparity=MIN_D, max_disparity=max_d, lr=True, second_best=True)
    one = fn(ls, rs, force_route=disparity_band.ONE_BLOCK, **kw)
    tiled = fn(ls, rs, force_route=disparity_band.TILED, **kw)
    torch.cuda.synchronize()
    return _bitwise(results, f"{kernel} tiled vs one-block H{KITTI[0]} W{KITTI[1]} "
                    f"{_band_label(MIN_D, max_d)}", kernel, one, tiled)


def case_band(results, sizes=((48, 256, 64, 0), (64, 384, 192, 0),
                              (376, 1241, 192, 0), (376, 1241, 192, 2),
                              (376, 1241, 192, 5))):
    """B1 on tools/tpu_parity.py's band cases: (H, W, D, seed), band [1, D],
    lr off and on."""
    ok = True
    for H, W, D, seed in sizes:
        for lr in (False, True):
            ok &= _selected_case("band", H, W, None, D, seed, lr, results, val_abs=0.5)
    return ok


def case_full(results, sizes=((48, 256), (64, 640))):
    """B2 on tools/tpu_parity.py's full-search cases: (H, W), lr off and on."""
    ok = True
    for H, W in sizes:
        for lr in (False, True):
            ok &= _selected_case("full", H, W, None, None, 0, lr, results, val_abs=0.5)
    return ok


def case_dense(results, sizes=((376, 1241, 192, 7), (376, 1241, 192, 0))):
    """B1's winner maps at every interior pixel on tools/tpu_parity.py's
    dense cases: (H, W, D, seed), band [1, D], lr on."""
    ok = True
    for H, W, D, seed in sizes:
        ok &= _dense_case("band", H, W, None, D, seed, results, val_abs=1.0)
    return ok


def case_selected(results):
    """Selected pixels at the presets' bands (SELECTED_CASES, lr off and on;
    SELECTED_LR_CASES, lr on)."""
    ok = True
    for case in SELECTED_CASES:
        for lr in (False, True):
            ok &= _selected_case(*case, lr, results)
    for case in SELECTED_LR_CASES:
        ok &= _selected_case(*case, True, results)
    return ok


def case_winner_maps(results):
    """Every interior pixel at the presets' bands, and ``second``."""
    ok = True
    for case in DENSE_CASES:
        ok &= _dense_case(*case, results)
    for case in SECOND_CASES:
        ok &= _dense_case(*case, results, second_best=True)
    return ok


def case_ties(results):
    """Bit for bit on tie images, and B2 against B1 on fast_config's band."""
    ok = True
    for case in TIE_CASES:
        ok &= _tie_case(*case, results)
    for seed in BAND_EQUAL_SEEDS:
        ok &= _band_equal_case(seed, results)
    return ok


def case_tiled(results):
    """The tiled route: at WIDE against the plain version, and forced at
    KITTI size against the one-block route."""
    ok = True
    for case in WIDE_CASES:
        for lr in (False, True):
            ok &= _wide_case(*case, lr, results)
    for case in FORCED_TILED_CASES:
        ok &= _forced_tiled_case(*case, results)
    return ok


CASES = {"band": case_band, "full": case_full, "dense": case_dense,
         "selected": case_selected, "winner_maps": case_winner_maps, "ties": case_ties,
         "tiled": case_tiled}


def run(cases=None, log=None) -> list[Result]:
    """Run `cases` (names of CASES; all by default) on the card; returns the
    results. `log(line)` gets each result's PASS/FAIL line as it comes.
    Raises without a card."""
    resolve_device("cuda")
    results: list[Result] = []
    for name in cases or CASES:
        start = len(results)
        t0 = time.perf_counter()
        CASES[name](results)
        for r in results[start:]:
            if log is not None:
                log(f"{'PASS' if r.ok else 'FAIL'}  [{name}] {r.label}: {r.detail}")
        if log is not None:
            log(f"[{name}] {len(results) - start} checks in {time.perf_counter() - t0:.1f} s")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), default=None)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    results = run([args.case] if args.case else None, log=lambda s: print(s, flush=True))
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
