"""vobench's frozen renderer and trajectory equal the port's."""

import numpy as np
import pytest
import torch

from odometry_torch.camera.pinhole import Pinhole as PortPinhole
from odometry_torch.data import synthetic
from vobench import render
from vobench.plain.pinhole import Pinhole


@pytest.mark.parametrize("seed", [0, 7])
def test_trajectory_equals_the_ports(seed):
    np.testing.assert_array_equal(render.drive_trajectory(9, step=0.25, seed=seed),
                                  synthetic.drive_trajectory(9, step=0.25, seed=seed))


@pytest.mark.parametrize("seed,H,W", [(0, 20, 36), (3, 20, 36), (1, 40, 64), (4, 40, 64)])
def test_stereo_frames_equal_the_ports(seed, H, W):
    """``stereo_sequence`` (several poses per launch, row chunks of 16, the
    last one partial) against the port's ``render_stereo`` frame by frame."""
    cam = (30.0, 30.0, W / 2 - 0.5, H / 2 - 0.5)
    ours = render.make_driving_scene(seed, side_x=20.0, wall_z=26.0, device="cpu")
    port = synthetic.make_driving_scene(seed, side_x=20.0, wall_z=26.0, device="cpu")
    poses = render.drive_trajectory(11, step=0.25, seed=seed)
    left, right = render.stereo_sequence(ours, Pinhole.create(*cam), 0.54, poses, H, W)
    for i, T in enumerate(poses):
        a, b, _ = synthetic.render_stereo(port, PortPinhole.create(*cam), 0.54, T, H, W)
        assert torch.equal(left[i], a) and torch.equal(right[i], b)
