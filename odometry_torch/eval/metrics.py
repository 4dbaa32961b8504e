"""Trajectory evaluation: reference-parity metric + standard ATE/RPE (numpy;
the port's copy of ``odometry_tpu/eval/metrics.py``).

* :func:`mean_translation_error` is the reference's ``eval_pose``
  (``run_odometry_kitti_offline.cpp:361-372``): the unaligned mean Euclidean
  distance between predicted and GT translations.
* :func:`ate_rmse` is the standard absolute-trajectory-error RMSE with
  optional SE(3) (Umeyama, scale-free) alignment.
* :func:`rpe` is the relative pose error over a fixed frame delta, the KITTI
  devkit-style drift metric.

All functions take (N, 4, 4) or (N, 3, 4) pose arrays (cam-to-world).
"""

from __future__ import annotations

import numpy as np


def _to34(poses: np.ndarray) -> np.ndarray:
    poses = np.asarray(poses)
    if poses.shape[-2:] == (4, 4):
        return poses[..., :3, :]
    if poses.shape[-2:] == (3, 4):
        return poses
    raise ValueError(f"bad pose array shape {poses.shape}")


def _to44(poses: np.ndarray) -> np.ndarray:
    poses = _to34(poses)
    n = poses.shape[0]
    out = np.tile(np.eye(4, dtype=poses.dtype), (n, 1, 1))
    out[:, :3, :] = poses
    return out


def mean_translation_error(gt: np.ndarray, pred: np.ndarray) -> float:
    """The reference's printed metric: mean ||t_pred - t_gt|| (no alignment)."""
    gt = _to34(gt)
    pred = _to34(pred)
    return float(np.linalg.norm(pred[:, :, 3] - gt[:, :, 3], axis=1).mean())


def align_umeyama(gt_t: np.ndarray, pred_t: np.ndarray):
    """Rigid alignment (rotation+translation, no scale) of pred onto gt."""
    mu_g = gt_t.mean(0)
    mu_p = pred_t.mean(0)
    gc = gt_t - mu_g
    pc = pred_t - mu_p
    H = pc.T @ gc
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_p
    return R, t


def ate_rmse(gt: np.ndarray, pred: np.ndarray, align: bool = True) -> float:
    """Standard ATE RMSE over translations, optionally rigidly aligned."""
    gt_t = _to34(gt)[:, :, 3]
    pred_t = _to34(pred)[:, :, 3]
    if align:
        R, t = align_umeyama(gt_t, pred_t)
        pred_t = pred_t @ R.T + t
    err = np.linalg.norm(pred_t - gt_t, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe(gt: np.ndarray, pred: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`.

    Returns (trans_rmse [m], rot_rmse [rad]).
    """
    gt44 = _to44(gt)
    pred44 = _to44(pred)
    n = gt44.shape[0]
    terrs, rerrs = [], []
    for i in range(n - delta):
        dg = np.linalg.inv(gt44[i]) @ gt44[i + delta]
        dp = np.linalg.inv(pred44[i]) @ pred44[i + delta]
        e = np.linalg.inv(dg) @ dp
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(c))
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return float(np.sqrt((terrs**2).mean())), float(np.sqrt((rerrs**2).mean()))
