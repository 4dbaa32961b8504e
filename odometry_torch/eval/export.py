"""Trajectory / keyframe export in the reference's output formats (port of
``eval/export.py``; PNGs written by ``data/png.py``).

* KITTI-devkit pose txt: 12 space-separated floats per line (row-major 3x4),
  identical to ``save_txt`` (``run_odometry_kitti_offline.cpp:374-430``).
* Keyframe dumps: grayscale PNG, 16-bit disparity PNG scaled by fx*baseline,
  16-bit validity-mask PNG — the ``save_to_vis`` outputs (``:432-473``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from odometry_torch.data.png import write_png


def save_kitti_poses(path: str, poses: np.ndarray) -> None:
    """Write (N, 3, 4) or (N, 4, 4) poses in KITTI devkit format."""
    poses = np.asarray(poses)
    if poses.shape[-2:] == (4, 4):
        poses = poses[:, :3, :]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.6f}" for v in p.reshape(-1)) + "\n")


def load_kitti_poses(path: str) -> np.ndarray:
    """Read KITTI devkit pose txt -> (N, 3, 4) float32."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                raise ValueError(f"bad KITTI pose line with {len(vals)} values")
            rows.append(np.asarray(vals, np.float32).reshape(3, 4))
    return np.stack(rows)


def save_keyframe_dumps(
    out_dir: str,
    images: Sequence[np.ndarray],
    disparities: Sequence[np.ndarray],
    masks: Sequence[np.ndarray],
    keyframe_ids: Sequence[int],
    disparity_scale: float,
) -> None:
    """Per-keyframe PNG dumps + keyframe-id list (save_to_vis equivalent).

    disparity PNGs are uint16(disparity_scale * inverse_depth) like the
    reference's ``386.1448 * dep`` (``run_odometry_kitti_offline.cpp:453``).
    """
    for sub in ("gray_img_left", "disparity_left", "mask_left", "keyframe_ids"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for i, (img, disp, mask) in enumerate(zip(images, disparities, masks)):
        write_png(os.path.join(out_dir, "gray_img_left", f"{i}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))
        d16 = np.where(mask != 0, disparity_scale * disp, 0.0).astype(np.uint16)
        write_png(os.path.join(out_dir, "disparity_left", f"{i}.png"), d16)
        write_png(os.path.join(out_dir, "mask_left", f"{i}.png"), mask.astype(np.uint16))
    with open(os.path.join(out_dir, "keyframe_ids", "keyframe_id.txt"), "w") as f:
        for kid in keyframe_ids:
            f.write(f"{kid}\n")
