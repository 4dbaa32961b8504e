"""Stereo calibration: Kalibr camchain parsing + rectification precompute
(port of ``camera/calibration.py``).

Replaces the reference's camera setup path (C3): the hand-rolled YAML parser
``ReadStereoCalibrationFile`` (``camera.cpp:168-352``), ``cv::stereoRectify``
-based ``SetUpStereoCameraSystem`` (``camera.cpp:85-166``) and the
undistort/rectify remap precompute (``camera.cpp:40-81``).

Everything is host-side numpy run once at startup; the products are plain
arrays (rectified intrinsics + per-pixel remap grids) that the pipeline
applies as bilinear gathers (image/sampling.remap_bilinear). The rectifying
geometry follows Bouguet's algorithm (the same one OpenCV implements).

Supported model: pinhole intrinsics + radtan (plumb-bob) distortion, the
reference's configuration (``calibration_file/camchain.yaml:3-4``).

PyYAML is imported inside :func:`parse_kalibr_yaml` only, so the rest of the
module, and the CLI, never need it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from odometry_torch.config import CameraConfig


@dataclasses.dataclass(frozen=True)
class MonoCalibration:
    fx: float
    fy: float
    cx: float
    cy: float
    distortion: np.ndarray  # (4,) radtan [k1, k2, p1, p2]
    width: int
    height: int


@dataclasses.dataclass(frozen=True)
class StereoCalibration:
    cam0: MonoCalibration
    cam1: MonoCalibration
    # cam1-from-cam0 extrinsics (Kalibr T_cn_cnm1: takes a point in cam0 to cam1)
    R_10: np.ndarray  # (3, 3)
    t_10: np.ndarray  # (3,)


@dataclasses.dataclass(frozen=True)
class RectifiedStereo:
    """Products consumed by the pipeline."""

    camera: CameraConfig  # shared rectified intrinsics + baseline
    map0_u: np.ndarray  # (H, W) sample coords into the raw left image
    map0_v: np.ndarray
    map1_u: np.ndarray
    map1_v: np.ndarray
    R_rect0: np.ndarray  # rectifying rotations (raw cam -> rectified cam)
    R_rect1: np.ndarray


def parse_kalibr_yaml(path: str) -> StereoCalibration:
    """Parse a Kalibr camchain (pinhole/radtan) like the reference's parser."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)

    def mono(block) -> MonoCalibration:
        if block.get("camera_model", "pinhole") != "pinhole":
            raise ValueError("only pinhole cameras supported")
        if block.get("distortion_model", "radtan") not in ("radtan", "plumb_bob", "none"):
            raise ValueError("only radtan distortion supported")
        fu, fv, pu, pv = block["intrinsics"]
        dist = np.asarray(block.get("distortion_coeffs", [0, 0, 0, 0]), np.float64)
        w, h = block["resolution"]
        return MonoCalibration(fu, fv, pu, pv, dist, int(w), int(h))

    cam0 = mono(doc["cam0"])
    cam1 = mono(doc["cam1"])
    T = np.asarray(doc["cam1"]["T_cn_cnm1"], np.float64)
    return StereoCalibration(cam0, cam1, T[:3, :3], T[:3, 3])


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    a = w / th
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * v


def _distort_radtan(x, y, dist):
    k1, k2, p1, p2 = dist[:4]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def stereo_rectify(calib: StereoCalibration) -> RectifiedStereo:
    """Bouguet rectification: split the relative rotation, align baselines.

    Produces row-aligned rectified cameras sharing one intrinsic matrix, plus
    remap grids mapping rectified pixels to raw-image sample locations.
    """
    c0, c1 = calib.cam0, calib.cam1
    H, W = c0.height, c0.width

    # Split the relative rotation: with x1 = R_10 x0, rotating cam0 by
    # exp(om/2) and cam1 by exp(-om/2) lands both in the common middle
    # orientation (exp(-om/2) R_10 = exp(om/2)).
    om = _log_so3(calib.R_10)
    R0_half = _rodrigues(om / 2.0)
    R1_half = _rodrigues(-om / 2.0)
    t = R1_half @ calib.t_10  # baseline vector in the common frame

    # Rectifying rotation: x-axis along the baseline.
    e1 = t / np.linalg.norm(t)
    if abs(e1[0]) >= abs(e1[1]):
        sign = -1.0 if e1[0] < 0 else 1.0
    else:
        sign = -1.0 if e1[1] < 0 else 1.0
    e1 = e1 * sign
    e2 = np.array([-e1[1], e1[0], 0.0])
    n = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n < 1e-12 else e2 / n
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3])

    R_rect0 = R_align @ R0_half
    R_rect1 = R_align @ R1_half

    # Shared rectified intrinsics: average focal, centered principal point.
    fx_new = (c0.fx + c0.fy + c1.fx + c1.fy) / 4.0
    cx_new = (W - 1) / 2.0
    cy_new = (H - 1) / 2.0
    baseline = float(np.linalg.norm(calib.t_10))

    def build_map(c: MonoCalibration, R_rect: np.ndarray):
        us, vs = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        x = (us - cx_new) / fx_new
        y = (vs - cy_new) / fx_new
        rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ R_rect  # R^T applied
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        xd, yd = _distort_radtan(xn, yn, c.distortion)
        mu = (c.fx * xd + c.cx).astype(np.float32)
        mv = (c.fy * yd + c.cy).astype(np.float32)
        return mu, mv

    m0u, m0v = build_map(c0, R_rect0)
    m1u, m1v = build_map(c1, R_rect1)
    cam_cfg = CameraConfig(
        fx=float(fx_new), fy=float(fx_new), cx=float(cx_new), cy=float(cy_new),
        baseline=baseline, height=H, width=W,
    )
    return RectifiedStereo(cam_cfg, m0u, m0v, m1u, m1v, R_rect0, R_rect1)


def setup_stereo_from_kalibr(path: str) -> RectifiedStereo:
    """One-call equivalent of ``SetUpStereoCameraSystem`` (camera.cpp:85-166)."""
    return stereo_rectify(parse_kalibr_yaml(path))
