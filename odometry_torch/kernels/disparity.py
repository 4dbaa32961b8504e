"""Epipolar 8-point-pattern SSD disparity search (port of ``kernels/disparity.py``).

``disparity_winner_maps`` dispatches on the device of its inputs:

* CPU tensors run the plain version, the row-chunked norm expansion
  ``||P_L||^2 + ||P_R||^2 - 2 P_L.P_R`` of the reference's XLA path
  (``disparity.py:191-238``), in
  :func:`odometry_torch.kernels.disparity_band.disparity_band_plain`;
* CUDA tensors go to a hand-written kernel chosen as the reference chooses
  its Pallas kernel (:func:`_route`): a narrow band to the band kernel
  (``csrc/disparity_band.cu``), the full search and any wider band to the
  full-search kernel (``csrc/disparity_full.cu``), the band applied as a
  limit on its scan. So fast_config launches only the band kernel, and
  ``kitti_config``/``accurate_config`` only the full-search kernel.

The plain version never runs silently on the card.

Pattern offsets (dy, dx), identical to ``ComputeSsdPattern8``
(``depth_estimate.cpp:420-433``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PATTERN_OFFSETS = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (2, 0))

# The widest band (rounded up to 128 columns) that goes to the band kernel.
# This mirrors the reference's routing (``band_fits_vmem``,
# ``disparity_pallas.py:61-66``: the TPU kernel's VMEM slab), so that each
# preset launches the counterpart of the kernel the reference launches; it is
# not a limit of this card.
MAX_BAND_P = 256


def _route(max_disparity: int | None) -> str:
    """"band" or "full": which kernel a CUDA search with this cap takes."""
    if max_disparity is not None and -(-max_disparity // 128) * 128 <= MAX_BAND_P:
        return "band"
    return "full"


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
    from odometry_torch.kernels import disparity_band, disparity_full

    kw = dict(boundary=boundary, min_disparity=min_disparity,
              max_disparity=max_disparity, lr=lr_check,
              second_best=second_best, second_excl=second_excl)
    if left.device.type == "cpu":
        return disparity_band.disparity_band_plain(left, right, **kw)
    if _route(max_disparity) == "band":
        return disparity_band.disparity_band(left, right, **kw)
    return disparity_full.disparity_full(left, right, **kw)


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


def disparity_search_reference(left, right, select_mask, *, fx: float, baseline: float,
                               boundary: int = 4, ssd_th: float = 900.0):
    """Slow direct-SSD golden model (no matmul expansion) for parity tests: the
    reference's numpy scan (``kernels/disparity.py:263-305``), copied as it
    is. Takes and returns numpy arrays: (disp, inv_depth, matched, best)."""
    import numpy as np

    left = np.asarray(left)
    right = np.asarray(right)
    mask = np.asarray(select_mask)
    H, W = left.shape
    disp = np.zeros((H, W), np.float32)
    inv_depth = np.zeros((H, W), np.float32)
    matched = np.zeros((H, W), bool)
    best_map = np.full((H, W), 1e10, np.float32)

    def pat(img, y, x):
        return np.array([img[y + dy, x + dx] for dy, dx in PATTERN_OFFSETS], np.float32)

    for y in range(boundary, H - boundary):
        for x in range(boundary, W - boundary):
            if not mask[y, x]:
                continue
            pl = pat(left, y, x)
            smallest = 1e10
            match = -1
            for rx in range(boundary, x):
                ssd = float(np.sum((pl - pat(right, y, rx)) ** 2))
                if ssd < smallest:
                    smallest = ssd
                    match = rx
            best_map[y, x] = smallest
            if smallest <= ssd_th:
                matched[y, x] = True
                disp[y, x] = abs(x - match)
                inv_depth[y, x] = disp[y, x] / (fx * baseline)
    return disp, inv_depth, matched, best_map
