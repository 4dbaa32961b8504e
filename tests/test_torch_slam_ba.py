"""The SLAM loop with BA after every keyframe: the port's ``run_slam``
against the reference's on tests/test_slam.py's fixture (16 frames of
``drive_trajectory`` over a plane at 96x160, window 3). The fixture and its
tolerances are those of tests/test_torch_slam.py.
"""

import numpy as np
import pytest

from test_torch_slam import POSE_ATOL, _run, _same_decisions


@pytest.fixture(scope="module")
def ba_run():
    return _run("ba_every_keyframe")


def test_run_slam_with_ba_matches_reference(ba_run):
    """BA after every keyframe: the same keyframes and BA runs, every emitted
    pose and every stored pose within 5e-4, the path lengths within float32
    rounding."""
    truth, rj, rt, log = ba_run
    _same_decisions(rj, rt, truth)
    assert rt.ba_runs >= 1 and rt.loop_closures == 0 and not log["t_prop"]
    assert set(rt.stage_report) == {"ba"}
    np.testing.assert_allclose(rt.poses, np.asarray(rj.poses), rtol=0, atol=POSE_ATOL)
    occ = rt.store.occupied.numpy()
    np.testing.assert_allclose(rt.store.pose.numpy()[occ], np.asarray(rj.store.pose)[occ],
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(rt.store.path.numpy(), np.asarray(rj.store.path), rtol=1e-5,
                               atol=POSE_ATOL)


def test_run_slam_with_ba_tracks_the_truth(ba_run):
    """The reference's own claim, on the port: BA after every keyframe keeps
    the translations within 0.15 m RMS (tests/test_slam.py:53)."""
    truth, _, rt, _ = ba_run
    err = np.linalg.norm(rt.poses[:, :3, 3] - truth[:, :3, 3], axis=1)
    assert float(np.sqrt(np.mean(err**2))) < 0.15
