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

# Shared memory a block may use on the H100 (232,448 bytes). The kernel
# stages five rows of both images whole: 2 x 5 x (W + 4) floats.
_SMEM_LIMIT = 232448


def staged_bytes(width: int) -> int:
    """Dynamic shared memory of one block at image width `width`."""
    return 4 * 2 * 5 * (width + 4)


def disparity_full(left_s: torch.Tensor, right_s: torch.Tensor, *, boundary: int,
                   min_disparity: int | None, max_disparity: int | None, lr: bool,
                   second_best: bool = False, second_excl: int = 2):
    """Launch the CUDA full-search kernel on the current stream (no synchronise).

    `left_s`/`right_s`: (H, W) float32 contiguous CUDA tensors (the blurred
    images). Raises on anything the kernel does not take (a width whose
    staged rows exceed a block's shared memory among them), or if the launch
    is refused.
    """
    global LAUNCHES
    check_images("disparity_full", left_s, right_s)
    W = left_s.shape[1]
    if staged_bytes(W) > _SMEM_LIMIT:
        raise ValueError(f"disparity_full: width {W} needs {staged_bytes(W)} B of shared "
                         f"memory per block, more than the {_SMEM_LIMIT} B a block can use")
    min_d = _min_d(min_disparity)
    max_d = W if max_disparity is None else int(max_disparity)
    if max_d < min_d:
        raise ValueError(f"disparity_full: empty band [{min_d}, {max_d}]")
    out = launch("disparity_full", left_s, right_s, boundary=boundary, min_d=min_d,
                 max_d=max_d, lr=lr, second_best=second_best, second_excl=second_excl)
    LAUNCHES += 1
    return out
