"""Blockwise adaptive gradient-threshold point selection (port of
``kernels/select.py``, reference ``depth_estimate.cpp:300-342``).

Only sorted values are used (medians, k-th largest), so ``torch.sort``
gives the reference's numbers exactly. Images are (H, W) or a batch
(B, H, W); the blocks of every image are sorted in one call.
"""

from __future__ import annotations

import torch

from vobench.plain.pyramid import central_gradients


def _grid(H: int, W: int, boundary: int, block_rows: int, block_cols: int):
    bh = (H - 2 * boundary) // block_rows
    bw = (W - 2 * boundary) // block_cols
    if bh < 1 or bw < 1:
        raise ValueError("image too small for the requested block grid")
    return bh, bw


def _to_blocks(a, boundary, block_rows, block_cols, bh, bw):
    """(..., H, W) -> (..., blocks, pixels of a block)."""
    lead = a.shape[:-2]
    region = a[..., boundary : boundary + block_rows * bh, boundary : boundary + block_cols * bw]
    return (region.reshape(-1, block_rows, bh, block_cols, bw)
            .permute(0, 1, 3, 2, 4).reshape(*lead, block_rows * block_cols, bh * bw))


def _from_blocks(b, H, W, boundary, block_rows, block_cols, bh, bw, fill):
    lead = b.shape[:-2]
    img = (b.reshape(-1, block_rows, block_cols, bh, bw)
           .permute(0, 1, 3, 2, 4).reshape(*lead, block_rows * bh, block_cols * bw))
    out = torch.full((*lead, H, W), fill, dtype=b.dtype, device=b.device)
    out[..., boundary : boundary + block_rows * bh, boundary : boundary + block_cols * bw] = img
    return out


def select_points(img: torch.Tensor, *, boundary: int = 4, block_rows: int = 16,
                  block_cols: int = 32, grad_th: float = 8.0,
                  max_points_per_block: int = 80,
                  min_points_per_block: int = 0) -> torch.Tensor:
    """(H, W) bool mask of selected high-gradient pixels of the blurred `img`.

    Per block: median gradient + `grad_th` is the threshold, at most
    `max_points_per_block` hits in row-major scan order are kept, and with
    `min_points_per_block` = k > 0 each block also contributes its top-k
    gradients (> 1.0), bounded to k in scan order.
    """
    H, W = img.shape[-2:]
    bh, bw = _grid(H, W, boundary, block_rows, block_cols)
    gx, gy = central_gradients(img)
    grad = torch.sqrt(gx * gx + gy * gy)
    blocks = _to_blocks(grad, boundary, block_rows, block_cols, bh, bw)

    sorted_blocks = torch.sort(blocks, dim=-1).values
    median = sorted_blocks[..., (bh * bw) // 2]
    above = blocks > (median + grad_th)[..., None]
    if min_points_per_block > 0:
        k = min(min_points_per_block, bh * bw)
        kth = sorted_blocks[..., -k]
        fallback = (blocks >= kth[..., None]) & (blocks > 1.0)
        fallback = fallback & (torch.cumsum(fallback.to(torch.int32), dim=-1) <= k)
        above = above | fallback
    order = torch.cumsum(above.to(torch.int32), dim=-1)
    keep = above & (order <= max_points_per_block)
    return _from_blocks(keep, H, W, boundary, block_rows, block_cols, bh, bw, False)


def block_median_map(values: torch.Tensor, mask: torch.Tensor, *, boundary: int = 4,
                     block_rows: int = 16, block_cols: int = 32) -> torch.Tensor:
    """Masked per-block median of `values` broadcast to (H, W); +inf for
    blocks with no masked pixel and outside the covered region."""
    H, W = values.shape[-2:]
    bh, bw = _grid(H, W, boundary, block_rows, block_cols)
    n = bh * bw
    v = _to_blocks(values, boundary, block_rows, block_cols, bh, bw)
    m = _to_blocks(mask, boundary, block_rows, block_cols, bh, bw)
    big = torch.tensor(float("inf"), dtype=torch.float32, device=values.device)
    sv = torch.sort(torch.where(m, v, big), dim=-1).values
    count = torch.sum(m, dim=-1)
    med_idx = torch.clamp((count - 1) // 2, 0, n - 1)
    med = torch.gather(sv, -1, med_idx[..., None])[..., 0]
    med = torch.where(count > 0, med, big)
    return _from_blocks(med[..., None].expand(*med.shape, n), H, W, boundary, block_rows,
                        block_cols, bh, bw, float("inf"))
