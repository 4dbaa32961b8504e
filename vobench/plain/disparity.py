"""Epipolar 8-point-pattern SSD disparity search, plain (a copy of
``odometry_torch/kernels/disparity.py`` whose winner maps are searched here in
plain PyTorch, never by the port's kernels).

Pattern offsets (dy, dx), identical to ``ComputeSsdPattern8``
(``depth_estimate.cpp:420-433``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.plain.precision import q

PATTERN_OFFSETS = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (2, 0))

def pattern_stack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 8, H, W): the 8-point pattern value at each
    pixel, reading zero-padded neighbours at the border."""
    H, W = img.shape[-2:]
    padded = torch.nn.functional.pad(img, (2, 2, 2, 2))
    return torch.stack(
        [padded[..., 2 + dy : 2 + dy + H, 2 + dx : 2 + dx + W] for dy, dx in PATTERN_OFFSETS],
        dim=-3,
    )


class DisparityResult(NamedTuple):
    disparity: torch.Tensor  # (H, W) float, 0 where no accepted match
    inv_depth: torch.Tensor  # (H, W) float = disparity / (fx * baseline)
    matched: torch.Tensor  # (H, W) bool
    best_ssd: torch.Tensor  # (H, W) float (1e10 where no candidates)


def disparity_winner_maps(left: torch.Tensor, right: torch.Tensor, *, boundary: int = 4,
                          max_disparity: int | None = None,
                          min_disparity: int | None = None, lr_check: bool = False,
                          second_best: bool = False, second_excl: int = 2):
    """(best, match, rmatch, second) dense winner maps of the blurred images,
    (H, W) or a batch (B, H, W), searched one image at a time.

    best[y, x] = lowest SSD for left pixel x over right columns xr with
    ``boundary <= xr`` and ``min_d <= x - xr <= max_d`` (1e10 where none);
    match[y, x] = the smallest such xr reaching it (0 where none);
    rmatch[y, xr] = smallest x reaching column xr's minimum over the same
    pairs (0 for columns with no pair; zeros when `lr_check` is False);
    second[y, x] = best SSD outside +-`second_excl` of the winner (1e10 fill).

    Each pair's SSD is the direct sum of squares in the pattern's order, one
    float32 rounding per operation as the SSD kernels round it (``ssd8``: the
    first square, then seven fused multiply-adds); a fused multiply-add is
    one rounding of the exact d*d + s, taken here through float64, where d*d
    is exact.
    """
    kw = dict(boundary=boundary, min_disparity=min_disparity,
              max_disparity=max_disparity, lr=lr_check,
              second_best=second_best, second_excl=second_excl)
    if left.dim() == 3:
        per_image = [_winners_one(a, b, **kw) for a, b in zip(left, right)]
        return tuple(torch.stack(maps) for maps in zip(*per_image))
    return _winners_one(left, right, **kw)


BIG = 1e10
_ROW_CHUNK = 8


def _ssd_direct(pl: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """(8, R, W, 1) left and (8, R, 1, W) right pattern values -> (R, W, W)
    float32 SSD of every (x, xr) pair of each row, in the kernels' order."""
    d = q(pl[0] - pr[0])
    s = q(d * d)
    for k in range(1, 8):
        d = q(pl[k] - pr[k]).double()
        s = q((s.double() + d * d).float())
    return s


def _winners_one(left_s, right_s, *, boundary, min_disparity, max_disparity, lr, second_best,
                 second_excl):
    H, W = left_s.shape
    dev = left_s.device
    PL = q(pattern_stack(left_s))
    PR = q(pattern_stack(right_s))
    xs = torch.arange(W, device=dev)[:, None]
    xr = torch.arange(W, device=dev)[None, :]
    d = xs - xr
    cand_ok = (xr >= boundary) & (d >= max(1, min_disparity or 1))
    if max_disparity is not None:
        cand_ok = cand_ok & (d <= max_disparity)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    best = torch.empty((H, W), dtype=torch.float32, device=dev)
    match = torch.empty((H, W), dtype=torch.int32, device=dev)
    rmatch = torch.zeros((H, W), dtype=torch.int32, device=dev)
    second = torch.full((H, W), BIG, dtype=torch.float32, device=dev)
    for r0 in range(0, H, _ROW_CHUNK):
        r1 = min(H, r0 + _ROW_CHUNK)
        ssd = _ssd_direct(PL[:, r0:r1, :, None], PR[:, r0:r1, None, :])
        ssd = torch.where(cand_ok, ssd, big)
        best[r0:r1] = torch.amin(ssd, dim=2)
        m = torch.argmin(ssd, dim=2)
        match[r0:r1] = m.to(torch.int32)
        if lr:
            rmatch[r0:r1] = torch.argmin(ssd, dim=1).to(torch.int32)
        if second_best:
            near = torch.abs(xr[None] - m[:, :, None]) <= second_excl
            second[r0:r1] = torch.amin(torch.where(near, big, ssd), dim=2)
    return best, match, rmatch, second


def _finalize(left, best, match, rmatch, select_mask, *, fx, baseline, boundary,
              ssd_th, lr_check, lr_tol) -> DisparityResult:
    """Winner thresholding + optional LR consistency + map assembly, of
    (H, W) maps or a batch (B, H, W)."""
    H, W = left.shape[-2:]
    ys_f = torch.arange(H, device=left.device)[:, None].expand(H, W)
    xs_f = torch.arange(W, device=left.device)[None, :].expand(H, W)
    row_ok = (ys_f >= boundary) & (ys_f < H - boundary) & (xs_f < W - boundary)
    matched = select_mask & row_ok & (best <= ssd_th)
    if lr_check:
        back = torch.gather(rmatch, -1, torch.clamp(match, 0, W - 1).long())
        matched = matched & (torch.abs(back - xs_f) <= lr_tol)
    disp = torch.where(matched, (xs_f - match).float(), 0.0)
    inv_depth = disp / float(fx * baseline)
    best = torch.where(select_mask & row_ok, best, 1e10)
    return DisparityResult(disp, inv_depth, matched, best)


def disparity_search(left: torch.Tensor, right: torch.Tensor, select_mask: torch.Tensor, *,
                     fx: float, baseline: float, boundary: int = 4, ssd_th: float = 900.0,
                     max_disparity: int | None = None, min_disparity: int | None = None,
                     lr_check: bool = False, lr_tol: int = 1) -> DisparityResult:
    """Stereo matching for selected pixels (dense-map API): winner maps, then
    threshold, optional left-right check and disparity -> inverse depth."""
    best, match, rmatch, _ = disparity_winner_maps(
        left, right, boundary=boundary, max_disparity=max_disparity,
        min_disparity=min_disparity, lr_check=lr_check,
    )
    return _finalize(left, best, match, rmatch, select_mask, fx=fx, baseline=baseline,
                     boundary=boundary, ssd_th=ssd_th, lr_check=lr_check, lr_tol=lr_tol)
