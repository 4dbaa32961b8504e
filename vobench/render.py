"""The benchmark's frames: a frozen copy of the port's driving-scene renderer
and trajectory (``odometry_torch/data/synthetic.py``: ``make_driving_scene``,
``MultiPlaneScene``, ``render``, ``right_camera_pose``, ``drive_trajectory``),
so that a later change to the program cannot move the traffic. ``render``
becomes :func:`render_many`, the same arithmetic for every pixel with several
poses in one launch of each operation (22 lanes' 2,156 frames in 22 s on an
H100, against 38-40 s frame by frame). ``tests/test_vobench_render.py``
holds the frames equal to the port's.

The scene's parameters are numpy ``default_rng`` draws from its seed, placed
on the device as float32; the renderer computes in float32 on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vobench.plain.pinhole import Pinhole
from vobench.plain.se3 import mat_to_rt, se3_exp

_ROW_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class MultiPlaneScene:
    """Textured planes composited by nearest positive ray intersection.

    texture(p) = 127.5 + sum_k amp_k sin(freq_k . p + phase_k)
               + sum_j blob_amp_j exp(-|p - c_j|^2 / (2 s_j^2))
    """

    normals: torch.Tensor  # (P, 3) unit normals
    offsets: torch.Tensor  # (P,) plane offsets: n . p = d
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


def make_driving_scene(seed: int = 0, *, ground_y: float = 1.6, wall_z: float = 16.0,
                       side_x: float = 5.0, num_waves: int = 48, num_blobs: int = 500,
                       freq_scale: float = 6.0, contrast: float = 55.0,
                       device) -> MultiPlaneScene:
    """Street-like scene: ground plane + front wall + two side walls (camera
    +z forward, +y down; the ground is y = `ground_y`)."""
    rng = np.random.default_rng(seed)
    jig = lambda s: 1.0 + 0.08 * rng.standard_normal(s)  # break exact symmetry
    normals = np.array(
        [
            [0.0, 1.0, 0.02 * rng.standard_normal()],  # ground (y = ground_y)
            [0.03 * rng.standard_normal(), 0.0, 1.0],  # front wall (z = wall_z)
            [1.0, 0.0, 0.12 * jig(())],                # right wall
            [-1.0, 0.0, 0.12 * jig(())],               # left wall
        ]
    )
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    anchor = np.array(
        [
            [0.0, ground_y, 0.0],
            [0.0, 0.0, wall_z * jig(())],
            [side_x * jig(()), 0.0, 0.0],
            [-side_x * jig(()), 0.0, 0.0],
        ]
    )
    offsets = np.einsum("pj,pj->p", normals, anchor)

    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(0.125 * freq_scale), np.log(2.0 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.35
    amps = amps * (contrast / np.sqrt(np.sum(amps**2) / 2.0))
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    nb = max(num_blobs, 1)
    centers = np.stack(
        [
            rng.uniform(-side_x, side_x, nb),
            rng.uniform(-2.0, ground_y, nb),
            rng.uniform(1.0, wall_z, nb),
        ],
        axis=1,
    )
    widths = np.exp(rng.uniform(np.log(0.10), np.log(0.5), nb))
    blob_amps = rng.uniform(40.0, 90.0, nb) * rng.choice([-1.0, 1.0], nb)
    if num_blobs == 0:
        blob_amps[:] = 0.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=torch.device(device))
    return MultiPlaneScene(
        normals=f32(normals), offsets=f32(offsets), freqs=f32(freqs), amps=f32(amps),
        phases=f32(phases), blob_centers=f32(centers),
        blob_inv2s2=f32(1.0 / (2.0 * widths**2)), blob_amps=f32(blob_amps),
    )


def right_camera_pose(T_wc_left: torch.Tensor, baseline: float) -> torch.Tensor:
    """Rectified right camera: displaced by +baseline along the left cam x-axis."""
    R, t = mat_to_rt(T_wc_left)
    out = T_wc_left.clone()
    out[:3, 3] = t + R[:, 0] * baseline
    return out


def render_many(scene: MultiPlaneScene, cam: Pinhole, T_wc, height: int, width: int,
                group: int = 8) -> torch.Tensor:
    """Images (n, H, W) of `scene` from n cam-to-world poses `T_wc`, `group`
    poses at a time, _ROW_CHUNK rows of each in one launch of each operation
    (the (pixels, blobs, 3) intermediate stays near 1 GB at KITTI width)."""
    dev = scene.freqs.device
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
    n = T_wc.shape[0]
    img = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    rx = (xs - cam.cx) / cam.fx
    for g0 in range(0, n, group):
        g1 = min(n, g0 + group)
        R, t = mat_to_rt(T_wc[g0:g1])
        num = torch.stack([scene.offsets - scene.normals @ t[k] for k in range(g1 - g0)])
        for y0 in range(0, height, _ROW_CHUNK):
            y1 = min(height, y0 + _ROW_CHUNK)
            ys = torch.arange(y0, y1, dtype=torch.float32, device=dev)[:, None]
            ry = ((ys - cam.cy) / cam.fy).expand(-1, width)
            rxx = rx.expand(y1 - y0, -1)
            Rb = R[:, None, None]  # (g, 1, 1, 3, 3)
            rw = torch.stack([Rb[..., i, 0] * rxx + Rb[..., i, 1] * ry + Rb[..., i, 2]
                              for i in range(3)], dim=-1)  # (g, rows, W, 3)
            denom = rw @ scene.normals.T  # (g, rows, W, P)
            tp = num[:, None, None, :] / torch.where(torch.abs(denom) < 1e-9,
                                                     torch.full_like(denom, 1e-9), denom)
            tp = torch.where(tp > 0.05, tp, torch.full_like(tp, float("inf")))
            tstar = torch.amin(tp, dim=-1)
            tstar = torch.where(torch.isfinite(tstar), tstar, torch.full_like(tstar, 100.0))
            p = t[:, None, None, :] + tstar[..., None] * rw
            img[g0:g1, y0:y1] = scene.texture(p.reshape(-1, 3)).reshape(g1 - g0, y1 - y0,
                                                                        width)
    return img


def stereo_sequence(scene: MultiPlaneScene, cam: Pinhole, baseline: float, poses,
                    height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(left, right) images (n, H, W) along cam-to-world `poses` (n, 4, 4)."""
    T = torch.as_tensor(poses, dtype=torch.float32, device=scene.freqs.device)
    T_right = torch.stack([right_camera_pose(T[k], baseline) for k in range(T.shape[0])])
    return (render_many(scene, cam, T, height, width),
            render_many(scene, cam, T_right, height, width))


def drive_trajectory(num_frames: int, *, step: float = 0.3, forward_frac: float = 0.15,
                     yaw_rate: float = 0.002, seed: int = 0) -> np.ndarray:
    """Lateral-dominant driving poses (N, 4, 4) float32, cam-to-world (numpy
    draws; the twists are exponentiated in float32)."""
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
