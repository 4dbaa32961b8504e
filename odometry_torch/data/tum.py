"""TUM RGB-D sequence loader (sensor-depth tracking path; port of
``data/tum.py``, reading PNGs with ``data/png.py`` instead of PIL).

Plays the role of the fixture loader in the reference's tracker test
(``test_optimizer.cpp:116-157``): the reference consumes an
``associated.txt`` whose rows are pre-associated
``gt_ts tx ty tz qx qy qz qw rgb_ts rgb_path depth_ts depth_path`` triplets
(items[1..7] pose, items[9] rgb, items[11] depth). We support that format,
the plain 4-column rgb/depth format, and — when no association file exists —
building associations from the raw ``rgb.txt``/``depth.txt``/
``groundtruth.txt`` index files with the standard TUM ``associate.py``
algorithm (nearest-timestamp greedy matching under a max-difference bound).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from odometry_torch.data import png

DEPTH_SCALE = 5000.0  # TUM convention: uint16 / 5000 = meters
MAX_DIFFERENCE = 0.02  # seconds; associate.py default


def load_gray(path: str) -> np.ndarray:
    """PNG -> float32 grayscale (PIL's grey rule for colour images)."""
    return png.read_gray(path, rule="pil")


def load_depth(path: str) -> np.ndarray:
    """uint16 depth PNG -> float32 meters (0 where invalid)."""
    return png.read_png(path).astype(np.float32) / DEPTH_SCALE


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_difference: float = MAX_DIFFERENCE
) -> List[Tuple[int, int]]:
    """TUM ``associate.py`` semantics: all (i, j) pairs with
    |ts_a[i] - ts_b[j]| < max_difference, greedily accepted in order of
    ascending time difference, each index used at most once. Returns index
    pairs sorted by ts_a."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    diff = np.abs(ts_a[:, None] - ts_b[None, :])
    ii, jj = np.nonzero(diff < max_difference)
    order = np.argsort(diff[ii, jj], kind="stable")
    used_a, used_b, out = set(), set(), []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort(key=lambda p: ts_a[p[0]])
    return out


@dataclasses.dataclass
class AssociatedFrame:
    gray_ts: float
    gray_path: str
    depth_ts: float
    depth_path: str
    gt_pose: Optional[np.ndarray] = None  # (4, 4) when the file carries GT


def _read_index(path: str) -> Tuple[np.ndarray, List[str]]:
    """Parse a TUM index file (``rgb.txt``/``depth.txt``): ts filename rows."""
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            ts.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(ts), names


def read_associations_full(
    seq_dir: str,
    fname: str = "associated.txt",
    max_difference: float = MAX_DIFFERENCE,
) -> List[AssociatedFrame]:
    """Load (or build) the frame association list.

    Priority: an existing association file (4-column rgb/depth or the
    reference's 12-column gt+rgb+depth format); otherwise associate
    ``rgb.txt`` x ``depth.txt`` with :func:`associate`.
    """
    path = os.path.join(seq_dir, fname)
    if os.path.exists(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 12:
                    # Reference format (test_optimizer.cpp:117-150):
                    # gt_ts tx ty tz qx qy qz qw rgb_ts rgb depth_ts depth
                    tx, ty, tz = (float(v) for v in parts[1:4])
                    qx, qy, qz, qw = (float(v) for v in parts[4:8])
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :3] = _quat_to_mat(qx, qy, qz, qw)
                    T[:3, 3] = [tx, ty, tz]
                    out.append(
                        AssociatedFrame(
                            float(parts[8]), os.path.join(seq_dir, parts[9]),
                            float(parts[10]), os.path.join(seq_dir, parts[11]),
                            T,
                        )
                    )
                elif len(parts) >= 4:
                    out.append(
                        AssociatedFrame(
                            float(parts[0]), os.path.join(seq_dir, parts[1]),
                            float(parts[2]), os.path.join(seq_dir, parts[3]),
                        )
                    )
        return out

    rgb_ts, rgb_names = _read_index(os.path.join(seq_dir, "rgb.txt"))
    dep_ts, dep_names = _read_index(os.path.join(seq_dir, "depth.txt"))
    pairs = associate(rgb_ts, dep_ts, max_difference)
    return [
        AssociatedFrame(
            float(rgb_ts[i]), os.path.join(seq_dir, rgb_names[i]),
            float(dep_ts[j]), os.path.join(seq_dir, dep_names[j]),
        )
        for i, j in pairs
    ]


def read_associations(seq_dir: str, fname: str = "associated.txt") -> List[Tuple[str, str]]:
    """Back-compat: [(gray_path, depth_path), ...]."""
    return [(a.gray_path, a.depth_path) for a in read_associations_full(seq_dir, fname)]


def rgbd_frames(
    seq_dir: str, count: int | None = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (gray float32, inverse_depth float32 with 0=invalid) frames."""
    assoc = read_associations_full(seq_dir)
    if count is not None:
        assoc = assoc[:count]
    for a in assoc:
        gray = load_gray(a.gray_path)
        depth = load_depth(a.depth_path)
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0).astype(np.float32)
        yield gray, inv


def load_groundtruth(seq_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps (N,), poses (N, 4, 4)) from tx..qw rows."""
    ts, poses = [], []
    with open(os.path.join(seq_dir, "groundtruth.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = vals
            R = _quat_to_mat(qx, qy, qz, qw)
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.stack(poses)


def associate_groundtruth(
    frame_ts: np.ndarray,
    gt_ts: np.ndarray,
    gt_poses: np.ndarray,
    max_difference: float = MAX_DIFFERENCE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame GT poses by timestamp association.

    Returns (poses (N, 4, 4), matched (N,) bool); unmatched frames carry
    identity and matched=False.
    """
    n = len(frame_ts)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    matched = np.zeros(n, bool)
    for i, j in associate(np.asarray(frame_ts), gt_ts, max_difference):
        poses[i] = gt_poses[j]
        matched[i] = True
    return poses, matched


def _quat_to_mat(qx, qy, qz, qw):
    q = np.asarray([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
