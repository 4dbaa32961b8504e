"""A batch of tracking problems for the tracker's tests, on any device.

Imports neither JAX nor the reference, so the card's tests (run on a machine
without JAX) use it too.
"""

import dataclasses

import torch

from odometry_torch import config
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render
from odometry_torch.geometry import se3_identity
from odometry_torch.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_torch.tracking import tracker as tt

# The tracker's presets by sampler, the dense engine, and the t-distribution.
TRACK_CFGS = {
    "floor": lambda: config.kitti_config().tracker,
    "bilinear": lambda: config.accurate_config().tracker,
    "mm": lambda: config.fast_config().tracker,
    "dense": lambda: dataclasses.replace(config.kitti_config().tracker, engine="dense"),
    "tdist": lambda: config.tum_rgbd_config().tracker,
}


def tracker_batch(B: int, H: int, W: int, cfg, device, seed: int = 0) -> dict:
    """Lane b tracks frame 1 of scene and drive `seed + b` against frame 0,
    the keyframe, whose inverse depth is exact. Returns the camera, the
    keyframe's image and inverse-depth pyramids and point lists, the current
    frame's pyramid and identity starting poses, each leading with B."""
    cam = Pinhole.create(0.56 * W, 0.56 * W, W / 2.0, H / 2.0)
    kf, inv_depth, cur = [], [], []
    for b in range(B):
        scene = make_scene(seed + b, depth=14.0, device=device)
        poses = drive_trajectory(2, step=0.35, seed=seed + b)
        img0, z0 = render(scene, cam, poses[0], H, W)
        img1, _ = render(scene, cam, poses[1], H, W)
        kf.append(img0)
        inv_depth.append(1.0 / z0)
        cur.append(img1)
    n = cfg.num_levels
    pyr_kf = gaussian_image_pyramid(torch.stack(kf), n)
    dpyr_kf = depth_pyramid(torch.stack(inv_depth), n, indexing=cfg.depth_decimation)
    return dict(cam=cam, pyr_kf=pyr_kf, dpyr_kf=dpyr_kf,
                kf_levels=tt.prepare_keyframe(pyr_kf, dpyr_kf, cfg),
                pyr_cur=gaussian_image_pyramid(torch.stack(cur), n),
                T0=se3_identity(batch=(B,), device=device))


def solve(batch: dict, cfg):
    """The tracker's solve of `batch` with the engine `cfg` names."""
    if cfg.engine == "dense":
        return tt.solve_pose(batch["pyr_kf"], batch["dpyr_kf"], batch["pyr_cur"], batch["cam"],
                             cfg, batch["T0"])
    return tt.solve_pose_points(batch["kf_levels"], batch["pyr_cur"], batch["cam"], cfg,
                                batch["T0"])


def leaves(result) -> list:
    """The pose, the flag and every LevelStats field of a TrackResult."""
    return [result.T, result.ok] + [t for st in result.stats for t in st]
