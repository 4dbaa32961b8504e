"""SE(3)/SO(3) Lie-group math on float32 tensors, batched over leading dims.

Port of ``odometry_tpu/geometry/se3.py``. Twist convention ``xi = [v, w]``
(translation first), Taylor fallbacks below the float32 cutoff instead of
branches, so every function is safe at theta = 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_terms(theta_sq: torch.Tensor):
    """(A, B, C) = (sin th/th, (1-cos th)/th^2, (th - sin th)/th^3)."""
    theta = torch.sqrt(theta_sq + 1e-30)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_th = torch.where(small, torch.ones_like(theta), theta)
    sin_t = torch.sin(safe_th)
    cos_t = torch.cos(safe_th)
    A = torch.where(small, 1.0 - theta_sq / 6.0, sin_t / safe_th)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe_th - sin_t) / (safe_sq * safe_th))
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_terms(theta_sq)
    W = hat(w)
    WW = W @ W
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * WW


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, (..., 3, 3) -> (..., 3); robust near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    near_pi = cos_theta < -0.99999
    small = theta < 1e-4
    scale_generic = theta / torch.where(torch.abs(sin_theta) < 1e-12,
                                        torch.ones_like(sin_theta), 2.0 * sin_theta)
    scale_small = 0.5 + theta * theta / 12.0
    scale = torch.where(small, scale_small, scale_generic)
    w_generic = scale[..., None] * v
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12), min=0.0))
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    sign = lambda s: torch.where(s >= 0, 1.0, -1.0).to(R.dtype)
    ax = axis_abs[..., 0]
    ay = axis_abs[..., 1] * sign(s01)
    az = axis_abs[..., 2] * sign(s02)
    axis_pi = torch.stack([ax, ay, az], dim=-1)
    ax_small = ax < 1e-3
    az2 = axis_abs[..., 2] * sign(s12)
    axis_pi = torch.where(ax_small[..., None],
                          torch.stack([ax, axis_abs[..., 1], az2], dim=-1), axis_pi)
    norm = torch.linalg.norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    w_pi = axis_pi * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> homogeneous transform (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_terms(theta_sq)
    W = hat(w)
    WW = W @ W
    eye = _eye3(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    W = hat(w)
    WW = W @ W
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    A, B, _ = _sinc_terms(theta_sq)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - A / (2.0 * B)) / safe_sq)
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * WW
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_identity(batch=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4)).clone()


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) for the [v, w] twist ordering: (..., 6, 6)."""
    R, t = mat_to_rt(T)
    tR = hat(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R, t = mat_to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotation_angles_xyz(R: torch.Tensor) -> torch.Tensor:
    """Per-axis rotation angles [angleX, angleY, angleZ] of the keyframe
    criterion (``Sophus::SO3::angleX/Y/Z``, so3.hpp:127-154)."""
    ax = torch.atan2(R[..., 2, 1] - R[..., 1, 2], R[..., 1, 1] + R[..., 2, 2])
    ay = torch.atan2(R[..., 0, 2] - R[..., 2, 0], R[..., 0, 0] + R[..., 2, 2])
    az = torch.atan2(R[..., 1, 0] - R[..., 0, 1], R[..., 0, 0] + R[..., 1, 1])
    return torch.stack([ax, ay, az], dim=-1)
