"""Image sampling at scattered coordinates (port of ``image/sampling.py``).

Images are (H, W), or a batch (B, H, W) whose coordinate tensors carry the
same leading B: image b is sampled at coordinates [b]. The gathers are
copies, so an image of a batch gets the bits of its own call.
"""

from __future__ import annotations

import torch

from vobench.plain.precision import q as held


def gather_2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img[..., yi, xi] for in-bounds integer index tensors of any matching
    shape; with a batch of images (..., H, W) the indices lead with the same
    batch dims."""
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    idx = (yi.long() * w + xi.long()).reshape(*lead, -1)
    return held(torch.gather(img.reshape(*lead, h * w), -1, idx).reshape(yi.shape))


def clip_gather_2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    return gather_2d(img, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1))


def sample_floor(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample at (floor(v), floor(u)), clipped to bounds (the reference's
    parity mode, ``kImg2.at<float>(floor(v), floor(u))``)."""
    return clip_gather_2d(img, torch.floor(v).long(), torch.floor(u).long())


def sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at continuous (u, v), edges clamped."""
    h, w = img.shape[-2:]
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    v00 = gather_2d(img, y0i, x0i)
    v01 = gather_2d(img, y0i, x1i)
    v10 = gather_2d(img, y1i, x0i)
    v11 = gather_2d(img, y1i, x1i)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return held(top * (1.0 - fy) + bot * fy)


def sample_channels_mm(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The "mm" sampler's semantics: bilinear sampling of C channels at N
    points with the reference's bf16 rounding.

    The reference (``sample_channels_mm``, ``sampling.py:70-130``) contracts
    bf16 channels against bf16 one-hot x-weights on the MXU with float32
    accumulation, then reduces the rows with float32 y-weights. The one-hot
    matmul is a TPU workaround; the numbers it produces are reproduced here by
    a gather of bf16-rounded values, upcast to float32:

    * channel values and the x-weight ``fx`` are rounded to bf16, and
      ``1 - fx`` is computed in bf16;
    * every product of two bf16 values is exact in float32, so the x-blend
      is one float32 rounding of a two-term sum, as in the matmul;
    * y-weights and the final blend stay float32.

    With ``dtype=torch.float32`` (the reference's HIGHEST-precision mode)
    nothing is rounded to bf16.

    Args:
      imgs: (C, H, W) channel stack, or a batch (B, C, H, W). u, v: (N,)
        continuous pixel coordinates, (B, N) for a batch.
    Returns:
      (C, N) float32 samples, (B, C, N) for a batch.
    """
    lead, (C, H, W) = imgs.shape[:-3], imgs.shape[-3:]
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0).to(dtype)
    wx0 = (1 - fx).float()[..., None, :]
    wx1 = fx.float()[..., None, :]
    fy = (v - y0)[..., None, :]
    x0i = x0.long()
    y0i = y0.long()
    # Out-of-image taps carry weight 0 in the reference (the one-hot has no
    # column W / row H); clamping them keeps the gather in bounds.
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    q = imgs.to(dtype).float().reshape(*lead, C, H * W)
    g = lambda yi, xi: torch.gather(q, -1, (yi * W + xi)[..., None, :].expand(*lead, C, -1))
    top = g(y0i, x0i) * wx0 + g(y0i, x1i) * wx1
    bot = g(y1i, x0i) * wx0 + g(y1i, x1i) * wx1
    return held(top * (1.0 - fy) + bot * fy)


def sample_bilinear_mm(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Single-channel :func:`sample_channels_mm`."""
    return sample_channels_mm(img.unsqueeze(-3), u, v, dtype).squeeze(-2)


def remap_bilinear(img: torch.Tensor, map_u: torch.Tensor, map_v: torch.Tensor) -> torch.Tensor:
    """cv::remap equivalent: dst[y, x] = img(map_v[y, x], map_u[y, x]),
    bilinear; applies precomputed undistort/rectify grids (``camera.cpp:79``)."""
    return sample_bilinear(img, map_u, map_v)
