"""KITTI odometry dataset loader (port of ``data/kitti.py``; replaces
``load_data``/``load_gt_pose``, ``run_odometry_kitti_offline.cpp:287-359``).

Expects the standard layout:

  root/
    dataset/sequences/<seq>/image_0/XXXXXX.png   (left gray)
    dataset/sequences/<seq>/image_1/XXXXXX.png   (right gray)
    dataset/sequences/<seq>/calib.txt            (optional, P0/P1 rows)
    poses/<seq>.txt                              (GT, training seqs only)

PNGs are read by ``data/png.py`` (no PIL), colour converted by PIL's grey
rule as the reference's ``Image.convert("L")`` does.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from odometry_torch.config import CameraConfig
from odometry_torch.data import png


def load_gray(path: str) -> np.ndarray:
    """PNG -> float32 grayscale array, matching cv::imread(IMREAD_GRAYSCALE)
    then convertTo(CV_32F) (``run_odometry_kitti_offline.cpp:342-358``)."""
    return png.read_gray(path, rule="pil")


def frame_paths(root: str, seq: str, frame_id: int) -> Tuple[str, str]:
    name = f"{frame_id:06d}.png"
    base = os.path.join(root, "dataset", "sequences", seq)
    return os.path.join(base, "image_0", name), os.path.join(base, "image_1", name)


def num_frames(root: str, seq: str) -> int:
    d = os.path.join(root, "dataset", "sequences", seq, "image_0")
    return len([f for f in os.listdir(d) if f.endswith(".png")])


class StereoFrames:
    """The (left, right) float32 pairs of a list of path pairs.

    `decoder` names what decodes them: "native" (the C++ prefetcher of
    ``data/native_loader.py``, decode in worker threads) or "png" (the numpy
    decoder of ``data/png.py``); `reason` says why the native decoder was not
    used when it was asked for and could not be (its build or its decode of
    the first frame failed)."""

    def __init__(self, paths, use_native: bool = True):
        self.paths = list(paths)
        self.decoder, self.reason, self._shape = "png", None, None
        if use_native and self.paths:
            from odometry_torch.data.native_loader import NativeLoaderUnavailable, png_read_gray

            try:
                self._shape = png_read_gray(self.paths[0][0]).shape
                self.decoder = "native"
            except (NativeLoaderUnavailable, IOError) as e:
                self.reason = str(e)

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.decoder == "native":
            from odometry_torch.data.native_loader import StereoPrefetcher

            yield from StereoPrefetcher([p[0] for p in self.paths],
                                        [p[1] for p in self.paths], *self._shape)
            return
        for lp, rp in self.paths:
            yield load_gray(lp), load_gray(rp)


def stereo_frames(root: str, seq: str = "00", start: int = 0, count: int | None = None,
                  use_native: bool = True) -> StereoFrames:
    """The sequence's (left, right) float32 pairs.

    With use_native (default) decoding runs in the C++ prefetch runtime, so
    IO overlaps device compute; where it cannot be built or cannot decode
    frame 0, ``data/png.py`` decodes instead. The returned object's `decoder`
    says which ran.
    """
    n = num_frames(root, seq)
    end = n if count is None else min(n, start + count)
    return StereoFrames([frame_paths(root, seq, i) for i in range(start, end)], use_native)


def load_poses(root: str, seq: str = "00", count: int | None = None) -> np.ndarray:
    """GT poses (N, 3, 4) from poses/<seq>.txt (row-major 12 floats/line)."""
    path = os.path.join(root, "poses", f"{seq}.txt")
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append(np.asarray([float(v) for v in line.split()], np.float32).reshape(3, 4))
            if count is not None and len(rows) >= count:
                break
    return np.stack(rows)


def load_calib(root: str, seq: str = "00") -> CameraConfig:
    """Parse P0/P1 projection rows of calib.txt into a CameraConfig.

    Falls back to the reference's hard-coded seq-00 values
    (``run_odometry_kitti_offline.cpp:38-41``) if the file is absent.
    """
    path = os.path.join(root, "dataset", "sequences", seq, "calib.txt")
    if not os.path.exists(path):
        return CameraConfig()
    P = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            P[key.strip()] = np.asarray([float(v) for v in vals.split()],
                                        np.float64).reshape(3, 4)
    P0, P1 = P["P0"], P["P1"]
    fx, fy = P0[0, 0], P0[1, 1]
    cx, cy = P0[0, 2], P0[1, 2]
    baseline = float(-P1[0, 3] / P1[0, 0])
    # Image size probed from frame 0.
    lp, _ = frame_paths(root, seq, 0)
    h, w = load_gray(lp).shape
    return CameraConfig(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                        baseline=baseline, height=h, width=w)
