"""``odometry_torch.tools.profile_step`` against the reference's
``tools/profile_step.py``: the tracker it times runs the LM iterations per
level (coarsest first) that the reference's ``solve_pose_points`` reports
in its ``stats`` on the same inputs (the reference's state after init,
carried across with ``interop.state_from_numpy``, and the same frame), at
the presets' own iteration limits and at the fixed counts the tool times
(``precision=2.0``, ``step_tol=0.0``: exactly k per level)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_tpu.image.pyramid import gaussian_image_pyramid as j_pyramid
from odometry_tpu.pipeline import odometry as jo
from odometry_tpu.tracking.tracker import solve_pose_points as j_solve
from odometry_torch import config as tc
from odometry_torch import interop
from odometry_torch.image.pyramid import gaussian_image_pyramid
from odometry_torch.tools import profile_step as ps
from test_torch_accuracy_sweep import _reference_config

H, W = 96, 320


# Each preset and iteration limit compiles the reference's tracker anew
# (about 2 s each, 8 s for the first): fast_config and the counts 1 and 2
# run with the slow tests.
@pytest.fixture(scope="module",
                params=["accurate", pytest.param("fast", marks=pytest.mark.slow)])
def inputs(request):
    """(preset, reference cfg, port cfg, reference state, carried state,
    frame 1's left image) for the tool's frames: make_scene(3) along
    drive_trajectory(step=0.35, seed=4)."""
    name = request.param
    cfg_j, cfg_t = _reference_config(name, H, W), tc.at_size(ps.CONFIGS[name](), H, W)
    c = cfg_j.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_scene(3, depth=14.0)
    frames = [tuple(np.asarray(a) for a in render_stereo(scene, cam, c.baseline,
                                                         jnp.asarray(T), H, W)[:2])
              for T in drive_trajectory(2, step=0.35, seed=4)]
    state, ok = jax.jit(lambda l, r: jo.init(l, r, cfg_j))(*frames[0])
    assert bool(ok)
    carried = interop.state_from_numpy(jax.tree_util.tree_map(np.asarray, state), "cpu")
    return name, cfg_j, cfg_t, state, carried, frames[1][0]


@pytest.mark.parametrize("fixed", [None, pytest.param(1, marks=pytest.mark.slow),
                                   pytest.param(2, marks=pytest.mark.slow), 4])
def test_tracker_iterations_match_reference_stats(inputs, fixed):
    name, cfg_j, cfg_t, state, carried, left = inputs
    n = cfg_t.tracker.num_levels
    assert n == cfg_j.tracker.num_levels
    tj, tt = cfg_j.tracker, cfg_t.tracker
    if fixed is not None:
        fix = dict(max_iterations=(fixed,) * n, precision=2.0, step_tol=0.0)
        tj, tt = dataclasses.replace(tj, **fix), dataclasses.replace(tt, **fix)
    c = cfg_j.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    res = jax.jit(lambda kf, l, T0: j_solve(kf, j_pyramid(l, n, True), cam, tj, T0))(
        state.kf_track, jnp.asarray(left), state.pose_init)
    want = [int(s.iters) for s in res.stats]
    got = ps.level_iterations(ps.track(carried, gaussian_image_pyramid(
        torch.from_numpy(left), n, smooth=True), cfg_t, tt))
    assert got == want
    if fixed is not None:
        assert got == [fixed] * n
