"""Checkpoint and resume: the port's runner against itself and the reference.

The 96x160 fixture of tests/test_pipeline.py:25-49 (make_scene(11),
drive_trajectory(12, step=0.25, seed=2)), rendered once by the reference and
handed to both packages as numpy; each package gets its own configuration.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import drive_trajectory, make_scene, stereo_sequence
from odometry_tpu.pipeline import runner as jrunner
from odometry_tpu.utils import checkpoint as jckpt
from odometry_torch import config as tc
from odometry_torch import interop
from odometry_torch.pipeline import runner as trunner
from odometry_torch.utils import checkpoint as tckpt

H, W = 96, 160
# C1's tolerance: a state carried across steps on in the other package.
POSE_TOL = 5e-4


def _config(C):
    return C.PipelineConfig(
        camera=C.CameraConfig(fx=240.0, fy=240.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=C.TrackerConfig(interp="bilinear", num_levels=3, max_iterations=(10, 20, 30),
                                depth_decimation="even"),
        depth=C.DepthConfig(block_rows=8, block_cols=16, min_valid_points=30,
                            interp="bilinear"),
        keyframe=C.KeyframeConfig(motion_threshold=0.2),
    )


CFG_J, CFG_T = _config(jc), _config(tc)


@pytest.fixture(scope="module")
def frames():
    cam = JPinhole.create(240.0, 240.0, W / 2.0, H / 2.0)
    poses = drive_trajectory(12, step=0.25, seed=2)
    return list(stereo_sequence(make_scene(11, depth=12.0), cam, CFG_J.camera.baseline,
                                poses, H, W))


@pytest.fixture(scope="module")
def port_full(frames):
    return trunner.run_sequence(frames, CFG_T, device="cpu")


def test_port_resume_is_bit_for_bit(frames, port_full, tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    # "Crash" after 9 frames with periodic checkpoints, then resume the whole sequence.
    part = trunner.run_sequence(frames[:9], CFG_T, checkpoint_path=ckpt, checkpoint_every=4,
                                device="cpu")
    assert "checkpoint" in part.stage_report and os.path.exists(ckpt)
    res = trunner.run_sequence(frames, CFG_T, checkpoint_path=ckpt, resume=True, device="cpu")
    assert "resume" in res.stage_report
    assert res.num_frames == port_full.num_frames == len(frames)
    np.testing.assert_array_equal(res.poses, port_full.poses)
    assert res.keyframe_ids == port_full.keyframe_ids
    assert len(res.keyframe_ids) >= 2
    assert res.lost_ids == port_full.lost_ids
    assert res.fps > 0  # over the 3 frames run after the resume
    assert len(res.per_frame_ms) == len(frames) - 9


@pytest.fixture(scope="module")
def ref_runs(frames, tmp_path_factory):
    """The reference's checkpoint at frame 8 (a run of 9 frames, saving every
    4) and its uninterrupted run."""
    ckpt = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    jrunner.run_sequence(frames[:9], CFG_J, checkpoint_path=ckpt, checkpoint_every=4)
    return ckpt, jrunner.run_sequence(frames, CFG_J)


def test_carried_state_writes_the_reference_file(frames, ref_runs, tmp_path):
    """The reference's saved state, carried across, is written by the port
    with the reference file's keys and arrays."""
    ckpt, _ = ref_runs
    jstate0, _ = jrunner._compiled(CFG_J, False)[0](frames[0][0], frames[0][1])
    payload = jckpt.load_pytree(ckpt, jrunner._checkpoint_template(jstate0))
    tstate = interop.state_from_numpy(jax.tree_util.tree_map(np.asarray, payload["state"]), "cpu")
    tp = str(tmp_path / "t.npz")
    tckpt.save_pytree(tp, trunner._checkpoint_payload(
        tstate, list(payload["poses"]), payload["keyframe_ids"], payload["lost_ids"],
        payload["frame_id"]))
    with np.load(ckpt) as a, np.load(tp) as b:
        assert a.files == b.files
        assert any("state/kf_track/0/pts/xs" in k for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # And it loads back onto the template's device with the template's dtypes.
    back = tckpt.load_pytree(tp, trunner._checkpoint_template(tstate))
    for (k, x), (_, y) in zip(tckpt._flatten(back["state"]), tckpt._flatten(tstate)):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert bool((x == y).all()), k


def test_reference_checkpoint_resumes_in_the_port(frames, ref_runs):
    ckpt, ref_full = ref_runs
    res = trunner.run_sequence(frames, CFG_T, checkpoint_path=ckpt, resume=True, device="cpu")
    assert "resume" in res.stage_report
    assert res.num_frames == ref_full.num_frames == len(frames)
    assert res.keyframe_ids == ref_full.keyframe_ids
    np.testing.assert_array_equal(res.poses[:9], ref_full.poses[:9])  # read from the file
    np.testing.assert_allclose(res.poses[9:], ref_full.poses[9:], atol=POSE_TOL, rtol=0)


def test_mismatched_template_raises(frames, tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    res = trunner.run_sequence(frames[:3], CFG_T, checkpoint_path=ckpt, checkpoint_every=2,
                               device="cpu")
    from odometry_torch.pipeline.odometry import init

    state, _ = init(frames[0][0], frames[0][1], CFG_T, device="cpu")
    like = trunner._checkpoint_template(state)
    assert tckpt.load_pytree(ckpt, like)["poses"].shape == (res.num_frames, 4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_pytree(ckpt, dict(like, poses=np.zeros((res.num_frames + 2, 4, 4),
                                                            np.float32)))
    fewer = dataclasses.replace(state, kf_pyr=state.kf_pyr[:2])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_pytree(ckpt, trunner._checkpoint_template(fewer))
