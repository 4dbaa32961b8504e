"""Full-search SSD stereo search: the CUDA kernel's wrapper and its plain version.

:func:`disparity_full` launches ``csrc/disparity_full.cu``, the port of the
TPU kernel ``odometry_tpu/kernels/disparity_pallas.py:_kernel`` (the search of
``kitti_config`` and ``accurate_config``). It takes ``max_disparity=None``
(the full search over ``boundary <= xr < x``) or a band too wide for the band
kernel, applied as a limit on each scan.

:func:`disparity_full_plain` is the same contract in plain PyTorch. It is the
band kernel's plain version: one row-chunked norm expansion of the
reference's XLA path (``odometry_tpu/kernels/disparity.py:191-238``) serves
both contracts, ``max_disparity=None`` being the full search.

Both return ``(best, match, rmatch, second)`` (see
:func:`odometry_torch.kernels.disparity.disparity_winner_maps`).
"""

from __future__ import annotations

import torch

from odometry_torch.kernels.disparity_band import _min_d, check_images, launch
from odometry_torch.kernels.disparity_band import (  # noqa: F401  (re-exported)
    disparity_band_plain as disparity_full_plain,
)

# Kernel launches made by disparity_full(); tests and chip_smoke.py read it to
# show a run went through the kernel.
LAUNCHES = 0


def disparity_full(left_s: torch.Tensor, right_s: torch.Tensor, *, boundary: int,
                   min_disparity: int | None, max_disparity: int | None, lr: bool,
                   second_best: bool = False, second_excl: int = 2,
                   force_route: str | None = None):
    """Launch the CUDA full-search kernel on the current stream (no synchronise).

    `left_s`/`right_s`: (H, W) or (B, H, W) float32 contiguous CUDA tensors
    (the blurred images), of any width: rows too wide for one block take the
    tiled route (:func:`odometry_torch.kernels.disparity_band.route`;
    `force_route` forces one). Raises on anything the kernel does not take,
    or if a launch is refused. Forward and reverse winners come from one pass
    over the pairs, bit for bit those of a strict-< ascending scan of each
    column, on either route; each image of a batch gets the bits of its own
    call. Adds each launch to ``LAUNCHES`` (1 per call on the one-block
    route, TILED_LAUNCHES on the tiled, whatever B is).
    """
    global LAUNCHES
    check_images("disparity_full", left_s, right_s)
    W = left_s.shape[-1]
    min_d = _min_d(min_disparity)
    max_d = W if max_disparity is None else int(max_disparity)
    if max_d < min_d:
        raise ValueError(f"disparity_full: empty band [{min_d}, {max_d}]")
    out, launches = launch("disparity_full", left_s, right_s, boundary=boundary, min_d=min_d,
                           max_d=max_d, lr=lr, second_best=second_best,
                           second_excl=second_excl, force_route=force_route)
    LAUNCHES += launches
    return out
