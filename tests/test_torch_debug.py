"""Debug checks: a poisoned frame raises at that frame in the port, with the
reference's messages (``odometry_tpu/utils/debug.py:37-42``, whose own run
tests/test_pipeline.py::test_debug_checks_localize_nan_frame checks); the
production path absorbs it. The 96x160 fixture of
tests/test_pipeline.py:25-49, rendered by the reference."""

import numpy as np
import pytest

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import drive_trajectory, make_scene, stereo_sequence
from odometry_torch import config as tc
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.utils.debug import DebugCheckError, checked_init, debug_config

from test_torch_checkpoint import H, W, _config

CFG_J, CFG_T = _config(jc), _config(tc)


@pytest.fixture(scope="module")
def frames():
    cam = JPinhole.create(240.0, 240.0, W / 2.0, H / 2.0)
    poses = drive_trajectory(5, step=0.25, seed=2)
    return list(stereo_sequence(make_scene(11, depth=12.0), cam, CFG_J.camera.baseline,
                                poses, H, W))


def _poison(frames, eye):
    bad = [tuple(np.array(im) for im in f) for f in frames]
    bad[2][eye][10, 10] = np.nan
    return bad


def test_nan_left_input_raises_at_its_frame(frames):
    bad = _poison(frames, 0)
    with pytest.raises(DebugCheckError) as ei:
        run_sequence(bad, CFG_T, debug_checks=True, device="cpu")
    assert "non-finite LEFT input frame" in str(ei.value)
    assert "frame 2" in str(ei.value)
    # Production path: absorbed (no exception), tracking flags handle it.
    res = run_sequence(bad, CFG_T, debug_checks=False, device="cpu")
    assert res.num_frames >= 3


def test_nan_right_input_raises_right_message(frames):
    with pytest.raises(DebugCheckError, match=r"non-finite RIGHT input frame \(frame 2\)"):
        run_sequence(_poison(frames, 1), CFG_T, debug_checks=True, device="cpu")


def test_checked_init_and_clean_run(frames):
    left = np.array(frames[0][0])
    left[0, 0] = np.inf
    with pytest.raises(DebugCheckError, match=r"LEFT input frame \(frame 0\)"):
        checked_init(CFG_T)(left, frames[0][1], device="cpu")
    clean = run_sequence(frames[:3], CFG_T, debug_checks=True, device="cpu")
    plain = run_sequence(frames[:3], CFG_T, device="cpu")
    np.testing.assert_array_equal(clean.poses, plain.poses)


def test_debug_config_runs_depth_every_frame():
    lazy = tc.fast_config()
    assert not lazy.depth_every_frame
    assert debug_config(lazy).depth_every_frame
    assert debug_config(lazy).tracker == lazy.tracker
