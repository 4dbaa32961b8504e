"""Dense photometric residual/Jacobian + normal equations, the dense tracking
engine (port of ``kernels/photometric.py``; reference
``LevenbergMarquardtOptimizer::ComputeResidualJacobianNaive``,
``lm_optimizer.cpp:163-264``).

Every pixel of a pyramid level is a lane: a skipped pixel (invalid depth,
behind the camera, out of bounds) is a zero-weight lane, the 2x6 warp
Jacobian chain is an elementwise map to an (H, W, 6) field, and ``J^T W J`` /
``J^T W r`` are (6, N) x (N, 6) products.

Interp "floor" is the reference's nearest-via-floor lookup with gradients at
the integer pixel, neighbours clamped (``lm_optimizer.cpp:208-217``);
"bilinear" and "mm" both sample bilinearly here, as the reference's dense
path does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from odometry_torch.camera.pinhole import Pinhole, backproject, warp_points
from odometry_torch.image.sampling import clip_gather_2d, sample_bilinear


class ResidualSystem(NamedTuple):
    """Per-pixel linearization of the photometric error at one pose."""

    r: torch.Tensor  # (H, W) residual I2(warp(x)) - I1(x), 0 where invalid
    J: torch.Tensor  # (H, W, 6) d r / d twist, 0 where invalid
    valid: torch.Tensor  # (H, W) bool


def residual_jacobian(img_kf: torch.Tensor, inv_depth_kf: torch.Tensor, img_cur: torch.Tensor,
                      cam: Pinhole, T: torch.Tensor, *, boundary: int = 4,
                      min_inv_depth: float = 0.01, interp: str = "floor",
                      affine_ab: tuple | None = None) -> ResidualSystem:
    """Dense ``ComputeResidualJacobianNaive`` (lm_optimizer.cpp:190-237) at
    one level: `cam` holds this level's intrinsics, `T` maps keyframe-camera
    points to the current camera, |inv_depth| < `min_inv_depth` is invalid."""
    H, W = img_kf.shape
    dev = img_kf.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    d = inv_depth_kf
    depth_valid = torch.abs(d) >= min_inv_depth
    border = (ys >= boundary) & (ys < H - boundary) & (xs >= boundary) & (xs < W - boundary)
    z = 1.0 / torch.where(depth_valid, d, torch.ones_like(d))

    X, Y, Z = backproject(cam, xs, ys, z)
    u, v, _, warp_valid = warp_points(cam, T, X, Y, Z, H, W)
    valid = depth_valid & border & warp_valid

    if interp == "floor":
        # float -> int casts of out-of-range values are undefined in torch;
        # clamp in float first (the result is the same clipped pixel).
        xi = torch.clamp(torch.floor(u), -1.0, float(W)).long().clamp(0, W - 1)
        yi = torch.clamp(torch.floor(v), -1.0, float(H)).long().clamp(0, H - 1)
        I2w = clip_gather_2d(img_cur, yi, xi)
        # Gradient at the integer warped pixel, neighbours clamped
        # (ComputePixelGradient, image_processing_global.h:62-69).
        gx = 0.5 * (clip_gather_2d(img_cur, yi, xi + 1) - clip_gather_2d(img_cur, yi, xi - 1))
        gy = 0.5 * (clip_gather_2d(img_cur, yi + 1, xi) - clip_gather_2d(img_cur, yi - 1, xi))
    elif interp in ("bilinear", "mm"):
        I2w = sample_bilinear(img_cur, u, v)
        gx = 0.5 * (sample_bilinear(img_cur, u + 1.0, v) - sample_bilinear(img_cur, u - 1.0, v))
        gy = 0.5 * (sample_bilinear(img_cur, u, v + 1.0) - sample_bilinear(img_cur, u, v - 1.0))
    else:
        raise ValueError(f"unknown interp mode {interp!r}")

    if affine_ab is not None:
        a_fit, b_fit = affine_ab
        r = I2w - (a_fit * img_kf + b_fit)
    else:
        r = I2w - img_kf

    # 2x6 pinhole warp Jacobian at the keyframe point (lm_optimizer.cpp:232-233),
    # twist order [v, w]; rows contracted with the image gradient.
    inv_Z = 1.0 / torch.where(Z == 0, torch.ones_like(Z), Z)
    fx_z = cam.fx * inv_Z
    fy_z = cam.fy * inv_Z
    xy = X * Y
    inv_Z2 = inv_Z * inv_Z
    a = gx * fx_z
    b = gy * fy_z
    J = torch.stack(
        [
            a,
            b,
            -(a * X + b * Y) * inv_Z,
            -a * xy * inv_Z - gy * cam.fy * (1.0 + Y * Y * inv_Z2),
            gx * cam.fx * (1.0 + X * X * inv_Z2) + b * xy * inv_Z,
            -a * Y + b * X,
        ],
        dim=-1,
    )
    vf = valid.to(r.dtype)
    return ResidualSystem(r * vf, J * vf[..., None], valid)


class NormalEqs(NamedTuple):
    JtWJ: torch.Tensor  # (6, 6)
    JtWr: torch.Tensor  # (6,)
    err: torch.Tensor  # scalar: (1/n) r^T W r  (lm_optimizer.cpp:129)
    num_valid: torch.Tensor  # scalar int


def normal_equations(sys: ResidualSystem, weights: torch.Tensor) -> NormalEqs:
    """Reduce the dense system to 6x6 normal equations; `weights` (H, W) are
    the robust weights (invalid lanes of r and J are already zero)."""
    w = weights * sys.valid.to(weights.dtype)
    Jf = sys.J.reshape(-1, 6)
    rf = sys.r.reshape(-1)
    wf = w.reshape(-1)
    Jw = Jf * wf[:, None]
    JtWJ = Jw.T @ Jf
    JtWr = Jw.T @ rf
    num_valid = torch.sum(sys.valid)
    err = torch.sum(wf * rf * rf) / torch.clamp(num_valid, min=1).to(rf.dtype)
    return NormalEqs(JtWJ, JtWr, err, num_valid)
