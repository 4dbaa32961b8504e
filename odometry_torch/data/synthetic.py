"""Synthetic textured-plane stereo scenes with exact ground truth (port of
``data/synthetic.py``: ``PlaneScene``, ``make_scene``, ``render``,
``render_stereo``, ``right_camera_pose``, ``drive_trajectory``).

``make_scene`` makes the same numpy ``default_rng`` draws as the reference,
so a scene's parameters are bit-identical for a seed; they are placed on the
scene's device as float32 tensors. The renderer computes in float32, as the
reference's does on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.device import resolve_device
from odometry_torch.geometry import mat_to_rt, se3_exp

_ROW_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class PlaneScene:
    """Textured plane n . p = d.

    texture(p) = sum_k amp_k sin(freq_k . p + phase_k)
               + sum_j blob_amp_j exp(-|p - c_j|^2 / (2 s_j^2))

    The reference's ``ridge`` term serves only its natural-texture scenes,
    which are not ported yet (ROADMAP A7).
    """

    normal: torch.Tensor  # (3,) unit
    offset: torch.Tensor  # scalar d
    freqs: torch.Tensor  # (K, 3)
    amps: torch.Tensor  # (K,)
    phases: torch.Tensor  # (K,)
    blob_centers: torch.Tensor  # (J, 3)
    blob_inv2s2: torch.Tensor  # (J,) = 1 / (2 s_j^2)
    blob_amps: torch.Tensor  # (J,)

    def texture(self, p: torch.Tensor) -> torch.Tensor:
        """p: (N, 3) world points -> (N,) intensity in roughly [0, 255]."""
        s = torch.sin(p @ self.freqs.T + self.phases)
        val = s @ self.amps
        diff = p[:, None, :] - self.blob_centers  # (N, J, 3)
        r2 = torch.sum(diff * diff, dim=-1)
        val = val + torch.exp(-r2 * self.blob_inv2s2) @ self.blob_amps
        return 127.5 + val


def make_scene(seed: int = 0, *, num_waves: int = 48, num_blobs: int = 600,
               depth: float = 12.0, tilt: float = 0.15, freq_scale: float = 8.0,
               contrast: float = 55.0, device) -> PlaneScene:
    """A mildly tilted plane ~`depth` meters in front of the z-axis camera,
    with its parameters on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = np.array([tilt * rng.standard_normal(), tilt * rng.standard_normal(), -1.0])
    n = n / np.linalg.norm(n)
    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(0.125 * freq_scale), np.log(2.0 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.35
    amps = amps * (contrast / np.sqrt(np.sum(amps**2) / 2.0))
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    d = float(n @ np.array([0.0, 0.0, depth]))
    extent = 1.5 * depth
    nb = max(num_blobs, 1)
    centers = np.zeros((nb, 3))
    centers[:, 0] = rng.uniform(-extent, extent, nb)
    centers[:, 1] = rng.uniform(-0.5 * depth, 0.5 * depth, nb)
    centers[:, 2] = (d - centers[:, 0] * n[0] - centers[:, 1] * n[1]) / n[2]
    widths = np.exp(rng.uniform(np.log(0.10), np.log(0.5), nb))
    blob_amps = rng.uniform(40.0, 90.0, nb) * rng.choice([-1.0, 1.0], nb)
    if num_blobs == 0:
        blob_amps[:] = 0.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return PlaneScene(
        normal=f32(n), offset=f32(d), freqs=f32(freqs), amps=f32(amps),
        phases=f32(phases), blob_centers=f32(centers),
        blob_inv2s2=f32(1.0 / (2.0 * widths**2)), blob_amps=f32(blob_amps),
    )


def render(scene: PlaneScene, cam: Pinhole, T_wc, height: int, width: int):
    """Render image + depth from camera pose T_wc (cam-to-world) on the
    scene's device. Returns (image (H, W), z_depth (H, W)).

    Rows are rendered _ROW_CHUNK at a time so the (pixels, blobs, 3)
    intermediate stays bounded (about 0.15 GB at KITTI width)."""
    dev = scene.normal.device
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
    R, t = mat_to_rt(T_wc)
    img = torch.empty((height, width), dtype=torch.float32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    rx = (xs - cam.cx) / cam.fx
    for y0 in range(0, height, _ROW_CHUNK):
        y1 = min(height, y0 + _ROW_CHUNK)
        ys = torch.arange(y0, y1, dtype=torch.float32, device=dev)[:, None]
        ry = ((ys - cam.cy) / cam.fy).expand(-1, width)
        rxx = rx.expand(y1 - y0, -1)
        rw = torch.stack([R[i, 0] * rxx + R[i, 1] * ry + R[i, 2] for i in range(3)], dim=-1)
        denom = rw @ scene.normal
        denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
        tstar = (scene.offset - torch.dot(scene.normal, t)) / denom
        p = t + tstar[..., None] * rw
        img[y0:y1] = scene.texture(p.reshape(-1, 3)).reshape(y1 - y0, width)
        z[y0:y1] = tstar
    return img, z


def right_camera_pose(T_wc_left: torch.Tensor, baseline: float) -> torch.Tensor:
    """Rectified right camera: displaced by +baseline along the left cam x-axis."""
    R, t = mat_to_rt(T_wc_left)
    out = T_wc_left.clone()
    out[:3, 3] = t + R[:, 0] * baseline
    return out


def render_stereo(scene: PlaneScene, cam: Pinhole, baseline: float, T_wc, height: int,
                  width: int):
    """Render a rectified stereo pair + left depth. Returns (left, right, z)."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=scene.normal.device)
    left, z = render(scene, cam, T_wc, height, width)
    right, _ = render(scene, cam, right_camera_pose(T_wc, baseline), height, width)
    return left, right, z


def drive_trajectory(num_frames: int, *, step: float = 0.3, forward_frac: float = 0.15,
                     yaw_rate: float = 0.002, seed: int = 0) -> np.ndarray:
    """Lateral-dominant driving poses (N, 4, 4) float32, cam-to-world (the
    reference's numpy draws; the twists are exponentiated in float32)."""
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    poses = [T.copy()]
    for _ in range(num_frames - 1):
        twist = np.array(
            [
                step * (1.0 + 0.1 * rng.standard_normal()),
                0.05 * step * rng.standard_normal(),
                forward_frac * step * rng.standard_normal(),
                0.2 * yaw_rate * rng.standard_normal(),
                yaw_rate * rng.standard_normal(),
                0.2 * yaw_rate * rng.standard_normal(),
            ],
            np.float32,
        )
        delta = se3_exp(torch.from_numpy(twist)).numpy()
        T = (T @ delta).astype(np.float32)
        poses.append(T.copy())
    return np.stack(poses)
