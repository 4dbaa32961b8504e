"""Epipolar 8-point-pattern SSD disparity search (port of ``kernels/disparity.py``).

``disparity_winner_maps`` dispatches on the device of its inputs:

* CPU tensors run the plain version, the row-chunked norm expansion
  ``||P_L||^2 + ||P_R||^2 - 2 P_L.P_R`` of the reference's XLA path
  (``disparity.py:191-238``), in
  :func:`odometry_torch.kernels.disparity_band.disparity_band_plain`;
* CUDA tensors with a finite `max_disparity` run the hand-written band kernel
  (``csrc/disparity_band.cu``);
* CUDA tensors with ``max_disparity=None`` (the full search of
  ``kitti_config``/``accurate_config``) raise: that kernel is not ported yet.

The plain version never runs silently on the card.

Pattern offsets (dy, dx), identical to ``ComputeSsdPattern8``
(``depth_estimate.cpp:420-433``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PATTERN_OFFSETS = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (2, 0))


def pattern_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (8, H, W): the 8-point pattern value at each pixel, reading
    zero-padded neighbours at the border."""
    H, W = img.shape
    padded = torch.nn.functional.pad(img, (2, 2, 2, 2))
    return torch.stack(
        [padded[2 + dy : 2 + dy + H, 2 + dx : 2 + dx + W] for dy, dx in PATTERN_OFFSETS]
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
    """(best, match, rmatch, second) dense winner maps of the blurred images.

    best[y, x] = lowest SSD for left pixel x over right columns xr with
    ``boundary <= xr`` and ``min_d <= x - xr <= max_d`` (1e10 where none);
    match[y, x] = the smallest such xr reaching it (0 where none);
    rmatch[y, xr] = smallest x reaching column xr's minimum over the same
    pairs (0 for columns with no pair; zeros when `lr_check` is False);
    second[y, x] = best SSD outside +-`second_excl` of the winner (1e10 fill).
    """
    from odometry_torch.kernels import disparity_band

    kw = dict(boundary=boundary, min_disparity=min_disparity,
              max_disparity=max_disparity, lr=lr_check,
              second_best=second_best, second_excl=second_excl)
    if left.device.type == "cpu":
        return disparity_band.disparity_band_plain(left, right, **kw)
    if max_disparity is None:
        raise NotImplementedError(
            "full-search disparity (max_disparity=None) on CUDA needs the "
            "full-search kernel, ROADMAP B2, which is not ported yet")
    return disparity_band.disparity_band(left, right, **kw)


def _finalize(left, best, match, rmatch, select_mask, *, fx, baseline, boundary,
              ssd_th, lr_check, lr_tol) -> DisparityResult:
    """Winner thresholding + optional LR consistency + map assembly."""
    H, W = left.shape
    ys_f = torch.arange(H, device=left.device)[:, None].expand(H, W)
    xs_f = torch.arange(W, device=left.device)[None, :].expand(H, W)
    row_ok = (ys_f >= boundary) & (ys_f < H - boundary) & (xs_f < W - boundary)
    matched = select_mask & row_ok & (best <= ssd_th)
    if lr_check:
        back = torch.gather(rmatch, 1, torch.clamp(match, 0, W - 1).long())
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
