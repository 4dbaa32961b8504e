"""Image / depth pyramids and gradients (port of ``image/pyramid.py``).

Only the reference's off-TPU branches are ported: the separable
shifted-sum convolution plus a strided slice (``pyramid.py:72-87,112-114,
173-176``). Its banded and one-hot matmul forms work around the TPU's
layout and have no use here.

* 3x3 Gaussian blur == ``cv::GaussianBlur(3x3, sigma=0)``: taps
  [1/4, 1/2, 1/4], REFLECT_101 borders (``F.pad(mode="reflect")``).
* ``pyr_down`` == ``cv::pyrDown``: [1,4,6,4,1]/16, even-index decimation,
  floor(n/2) output.
* Level 1 of the image pyramid is built from the UNsmoothed input
  (reference quirk, ``pyramid.py:143-145``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GAUSS3 = (0.25, 0.5, 0.25)
GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _sep_conv(img: torch.Tensor, taps) -> torch.Tensor:
    """Separable 2D convolution with REFLECT_101 borders via shifted sums,
    accumulated in the reference's tap order."""
    r = len(taps) // 2
    h, w = img.shape
    p = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    horiz = torch.zeros((h + 2 * r, w), dtype=img.dtype, device=img.device)
    for i, t in enumerate(taps):
        horiz = horiz + t * p[:, i : i + w]
    out = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for i, t in enumerate(taps):
        out = out + t * horiz[i : i + h, :]
    return out


def gaussian_blur3(img: torch.Tensor) -> torch.Tensor:
    """cv::GaussianBlur(img, Size(3,3), 0) equivalent."""
    return _sep_conv(img, GAUSS3)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown with forced floor(n/2) output size."""
    h, w = img.shape
    oh, ow = h // 2, w // 2
    return _sep_conv(img, GAUSS5)[: 2 * oh : 2, : 2 * ow : 2]


def median_blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median with REPLICATE borders (cv::medianBlur semantics)."""
    h, w = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    stack = torch.stack([p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)])
    return torch.median(stack, dim=0).values


def gaussian_image_pyramid(img: torch.Tensor, num_levels: int,
                           smooth: bool = True) -> Tuple[torch.Tensor, ...]:
    """The reference's ``GaussianImagePyramidNaive``: level 0 = blur3(img),
    level 1 = pyrDown(RAW img), level l>=2 = pyrDown(level l-1)."""
    levels = [gaussian_blur3(img) if smooth else img]
    if num_levels > 1:
        levels.append(pyr_down(img))
    for _ in range(2, num_levels):
        levels.append(pyr_down(levels[-1]))
    return tuple(levels)


def depth_pyramid(dep: torch.Tensor, num_levels: int, smooth: bool = False,
                  indexing: str = "odd") -> Tuple[torch.Tensor, ...]:
    """The reference's ``MedianDepthPyramidNaive``: level 0 is `dep` (its 3x3
    median when `smooth`), then decimation at odd (reference) or even
    (aligned) indices, no averaging."""
    if indexing not in ("odd", "even"):
        raise ValueError(f"bad indexing mode {indexing!r}")
    off = 1 if indexing == "odd" else 0
    levels = [median_blur3(dep) if smooth else dep]
    for _ in range(1, num_levels):
        prev = levels[-1]
        oh, ow = prev.shape[0] // 2, prev.shape[1] // 2
        levels.append(prev[off : off + 2 * oh : 2, off : off + 2 * ow : 2])
    return tuple(levels)


def central_gradients(img: torch.Tensor):
    """Clamped central differences (``ComputePixelGradient``,
    ``image_processing_global.h:62-69``)."""
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    down = torch.cat([img[1:, :], img[-1:, :]], dim=0)
    up = torch.cat([img[:1, :], img[:-1, :]], dim=0)
    return 0.5 * (right - left), 0.5 * (down - up)


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    gx, gy = central_gradients(img)
    return torch.sqrt(gx * gx + gy * gy)
