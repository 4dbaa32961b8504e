"""Synthetic stereo scenes with exact ground truth (port of
``data/synthetic.py``: ``PlaneScene``, ``MultiPlaneScene``, ``make_scene``,
``make_driving_scene``, ``make_natural_scene``, ``render``, ``render_stereo``,
``right_camera_pose``, ``drive_trajectory``, ``stereo_sequence`` and the
photometric nuisance model).

The scene makers make the same numpy ``default_rng`` draws as the
reference, so a scene's parameters are bit-identical for a seed; they are
placed on the scene's device as float32 tensors. The renderer computes in
float32, as the reference's does on the CPU. The nuisance model is host-side
numpy, as in the reference.
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

    `ridge` > 0 adds sum_k ridge * amp_k * (|sin(freq_k . p + phase_k)| - 2/pi),
    the turbulence term of the natural-texture scenes. It is a Python float,
    so the plain scenes (ridge 0) skip the term on the host.
    """

    normal: torch.Tensor  # (3,) unit
    offset: torch.Tensor  # scalar d
    freqs: torch.Tensor  # (K, 3)
    amps: torch.Tensor  # (K,)
    phases: torch.Tensor  # (K,)
    blob_centers: torch.Tensor  # (J, 3)
    blob_inv2s2: torch.Tensor  # (J,) = 1 / (2 s_j^2)
    blob_amps: torch.Tensor  # (J,)
    ridge: float = 0.0

    def texture(self, p: torch.Tensor) -> torch.Tensor:
        """p: (N, 3) world points -> (N,) intensity in roughly [0, 255]."""
        s = torch.sin(p @ self.freqs.T + self.phases)
        val = s @ self.amps
        if self.ridge:
            val = val + self.ridge * ((torch.abs(s) - 2.0 / np.pi) @ self.amps)
        diff = p[:, None, :] - self.blob_centers  # (N, J, 3)
        r2 = torch.sum(diff * diff, dim=-1)
        val = val + torch.exp(-r2 * self.blob_inv2s2) @ self.blob_amps
        return 127.5 + val


def _f32(dev):
    return lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)


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
    f32 = _f32(dev)
    return PlaneScene(
        normal=f32(n), offset=f32(d), freqs=f32(freqs), amps=f32(amps),
        phases=f32(phases), blob_centers=f32(centers),
        blob_inv2s2=f32(1.0 / (2.0 * widths**2)), blob_amps=f32(blob_amps),
    )


@dataclasses.dataclass(frozen=True)
class MultiPlaneScene:
    """Several textured planes composited by nearest positive ray intersection.

    A single plane leaves near-null directions in the 6x6 normal equations;
    a ground plane plus walls at different depths conditions the system the
    way street scenes do (the reference's reason for it). The texture is one
    function of the world point, :meth:`PlaneScene.texture`.
    """

    normals: torch.Tensor  # (P, 3) unit normals
    offsets: torch.Tensor  # (P,) plane offsets: n . p = d
    freqs: torch.Tensor
    amps: torch.Tensor
    phases: torch.Tensor
    blob_centers: torch.Tensor
    blob_inv2s2: torch.Tensor
    blob_amps: torch.Tensor
    ridge: float = 0.0

    texture = PlaneScene.texture


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
    f32 = _f32(resolve_device(device))
    return MultiPlaneScene(
        normals=f32(normals), offsets=f32(offsets), freqs=f32(freqs), amps=f32(amps),
        phases=f32(phases), blob_centers=f32(centers),
        blob_inv2s2=f32(1.0 / (2.0 * widths**2)), blob_amps=f32(blob_amps),
    )


def make_natural_scene(seed: int = 0, *, num_waves: int = 72, num_blobs: int = 500,
                       depth: float = 14.0, tilt: float = 0.15, freq_scale: float = 8.0,
                       contrast: float = 55.0, ridge: float = 1.0, device) -> PlaneScene:
    """Natural-texture plane: a multi-octave ridged (turbulence) spectrum, its
    amplitude calibrated numerically to `contrast` over a camera-footprint
    patch (the reference's numpy draws and calibration)."""
    rng = np.random.default_rng(seed)
    n = np.array([tilt * rng.standard_normal(), tilt * rng.standard_normal(), -1.0])
    n = n / np.linalg.norm(n)
    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(0.08 * freq_scale), np.log(2.5 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.9
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    d = float(n @ np.array([0.0, 0.0, depth]))
    span = 0.25 * depth
    px = rng.uniform(-span, span, (4096, 1))
    py = rng.uniform(-span, span, (4096, 1))
    pz = (d - px * n[0] - py * n[1]) / n[2]
    pts = np.concatenate([px, py, pz], axis=1)
    s = np.sin(pts @ freqs.T + phases)
    val = s @ amps + ridge * ((np.abs(s) - 2.0 / np.pi) @ amps)
    amps = amps * (contrast / max(float(val.std()), 1e-6))

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
    f32 = _f32(resolve_device(device))
    return PlaneScene(
        normal=f32(n), offset=f32(d), freqs=f32(freqs), amps=f32(amps),
        phases=f32(phases), blob_centers=f32(centers),
        blob_inv2s2=f32(1.0 / (2.0 * widths**2)), blob_amps=f32(blob_amps),
        ridge=float(np.float32(ridge)),
    )


@dataclasses.dataclass(frozen=True)
class PhotometricNuisance:
    """Camera/exposure imperfections applied to rendered frames (host side):
    exposure gain/bias drift over `drift_period` frames shared by both eyes,
    a constant inter-eye gain mismatch, radial vignetting and Gaussian sensor
    noise, all deterministic in (seed, frame index, eye)."""

    gain_amp: float = 0.06
    bias_amp: float = 6.0
    noise_sigma: float = 1.5
    vignette: float = 0.06
    eye_gain_mismatch: float = 0.02
    drift_period: float = 40.0
    seed: int = 0


def apply_nuisance(img, frame_idx: int, nuisance: PhotometricNuisance,
                   eye: int = 0) -> np.ndarray:
    """Apply the nuisance model to one rendered frame (numpy, host side)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    rng = np.random.default_rng((nuisance.seed, 7919))
    gain_phase = rng.uniform(0, 2 * np.pi)
    bias_phase = rng.uniform(0, 2 * np.pi)
    ang = 2.0 * np.pi * frame_idx / nuisance.drift_period
    gain = 1.0 + nuisance.gain_amp * np.sin(ang + gain_phase)
    bias = nuisance.bias_amp * np.sin(ang + bias_phase)
    if eye == 1:
        gain *= 1.0 + nuisance.eye_gain_mismatch
    ys = (np.arange(h, dtype=np.float32)[:, None] - h / 2.0) / (h / 2.0)
    xs = (np.arange(w, dtype=np.float32)[None, :] - w / 2.0) / (w / 2.0)
    r2 = (ys * ys + xs * xs) / 2.0  # corner => 1
    out = (127.5 + gain * (img - 127.5) + bias) * (1.0 - nuisance.vignette * r2)
    noise_rng = np.random.default_rng((nuisance.seed, frame_idx, eye))
    out = out + noise_rng.normal(0.0, nuisance.noise_sigma, img.shape)
    return out.astype(np.float32)


def render(scene, cam: Pinhole, T_wc, height: int, width: int):
    """Render image + depth of a PlaneScene or MultiPlaneScene from camera
    pose T_wc (cam-to-world) on the scene's device. Returns (image (H, W),
    z_depth (H, W)).

    Rows are rendered _ROW_CHUNK at a time so the (pixels, blobs, 3)
    intermediate stays bounded (about 0.15 GB at KITTI width)."""
    dev = scene.freqs.device
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
        if isinstance(scene, MultiPlaneScene):
            # Nearest positive intersection over all planes.
            denom = rw @ scene.normals.T  # (rows, W, P)
            num = scene.offsets - scene.normals @ t  # (P,)
            tp = num / torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
            tp = torch.where(tp > 0.05, tp, torch.full_like(tp, float("inf")))
            tstar = torch.amin(tp, dim=-1)
            tstar = torch.where(torch.isfinite(tstar), tstar, torch.full_like(tstar, 100.0))
        else:
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


def render_stereo(scene, cam: Pinhole, baseline: float, T_wc, height: int, width: int):
    """Render a rectified stereo pair + left depth. Returns (left, right, z)."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=scene.freqs.device)
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


def stereo_sequence(scene, cam: Pinhole, baseline: float, poses: np.ndarray, height: int,
                    width: int):
    """Yield (left, right) numpy pairs along a trajectory, rendered on the
    scene's device."""
    for T in poses:
        left, right, _ = render_stereo(scene, cam, baseline, T, height, width)
        yield left.cpu().numpy(), right.cpu().numpy()
