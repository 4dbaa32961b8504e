"""Middlebury stereo pair loader (reference test_disparity.cpp fixture role;
port of ``data/middlebury.py``, reading PNGs with ``data/png.py``).

Loads a rectified pair + ground-truth disparity PNG (classic Middlebury
layout: view1.png / view5.png / disp1.png with a disparity scale factor).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from odometry_torch.data import png


def load_pair(
    root: str,
    left_name: str = "view1.png",
    right_name: str = "view5.png",
    disp_name: str = "disp1.png",
    disp_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (left_gray, right_gray, gt_disparity) float32 arrays.

    gt_disparity is 0 where unknown; divided by `disp_scale` (Middlebury
    third-size datasets store disp*3, full-size store disp*1).
    """
    left = png.read_gray(os.path.join(root, left_name), rule="pil")
    right = png.read_gray(os.path.join(root, right_name), rule="pil")
    disp = png.read_png(os.path.join(root, disp_name)).astype(np.float32)
    if disp.ndim == 3:
        disp = disp[..., 0]
    disp = disp / disp_scale
    return left, right, disp
