"""Pinhole camera with per-level intrinsics (port of ``camera/pinhole.py``).

``Pinhole`` is a small frozen dataclass of Python floats. Each value is
rounded to float32, as the reference holds its intrinsics in float32 arrays,
so the per-level recursion produces the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Intrinsics for a single pyramid level (float32-valued Python floats)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "Pinhole":
        return Pinhole(_f32(fx), _f32(fy), _f32(cx), _f32(cy))


def level_intrinsics(cam: Pinhole, level: int) -> Pinhole:
    """Intrinsics at pyramid level `level` (``GetCxLevel``,
    ``image_processing_global.h:22-28``; fx / 2^l)."""
    cx, cy = np.float32(cam.cx), np.float32(cam.cy)
    half, one_half = np.float32(2.0), np.float32(0.5)
    for _ in range(level):
        cx = (cx + one_half) / half + one_half
        cy = (cy + one_half) / half + one_half
    scale = np.float32(2.0**level)
    return Pinhole(float(np.float32(cam.fx) / scale), float(np.float32(cam.fy) / scale),
                   float(cx), float(cy))


def intrinsic_pyramid(cam: Pinhole, num_levels: int) -> Tuple[Pinhole, ...]:
    return tuple(level_intrinsics(cam, l) for l in range(num_levels))


def backproject(cam: Pinhole, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Pixel coords + depth -> camera-frame 3D points (X, Y, Z=z)."""
    X = z * (x - cam.cx) / cam.fx
    Y = z * (y - cam.cy) / cam.fy
    return X, Y, z


def project(cam: Pinhole, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor):
    """Camera-frame 3D -> pixel coords (u, v). Caller handles Z<=0 masking."""
    safe_z = torch.where(Z == 0, torch.ones_like(Z), Z)
    u = cam.fx * X / safe_z + cam.cx
    v = cam.fy * Y / safe_z + cam.cy
    return u, v


def warp_points(cam: Pinhole, T: torch.Tensor, X, Y, Z, height: int, width: int):
    """Rigidly transform camera-frame points and project into the same camera
    (``WarpPixel``, ``image_processing_global.h:42-59``): returns (u, v, Zw,
    valid), valid combining the z > 0 check and the floor-in-bounds check."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Xw = R[..., 0, 0] * X + R[..., 0, 1] * Y + R[..., 0, 2] * Z + t[..., 0]
    Yw = R[..., 1, 0] * X + R[..., 1, 1] * Y + R[..., 1, 2] * Z + t[..., 1]
    Zw = R[..., 2, 0] * X + R[..., 2, 1] * Y + R[..., 2, 2] * Z + t[..., 2]
    u, v = project(cam, Xw, Yw, Zw)
    uf = torch.floor(u)
    vf = torch.floor(v)
    valid = (Zw > 0.0) & (uf >= 0.0) & (vf >= 0.0) & (uf < width) & (vf < height)
    return u, v, Zw, valid
