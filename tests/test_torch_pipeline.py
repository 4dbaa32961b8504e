"""The whole slice: fast_config odometry through the port and the reference.

Same frames (rendered once by the reference, handed over as numpy) through
the reference's ``run_sequence`` and the port's, on the 144x320 camera of
tests/test_pipeline.py:288-297; then one ``step`` from a reference state
carried across with ``interop.state_from_numpy``.

The frames show the reference's street scene (``make_driving_scene``), not
its single plane: a plane leaves near-null directions in the 6x6 normal
equations, so two float32 implementations drift apart along them by ~1e-3 m
over a long keyframe baseline (the reference says as much of its own
trajectory parity tests, data/synthetic.py:MultiPlaneScene).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.config import CameraConfig, fast_config
from odometry_tpu.data.synthetic import drive_trajectory, make_driving_scene, stereo_sequence
from odometry_tpu.pipeline import odometry as jo
from odometry_tpu.pipeline.runner import run_sequence as j_run_sequence
from odometry_torch import interop
from odometry_torch.pipeline import odometry as to
from odometry_torch.pipeline.runner import run_sequence as t_run_sequence

HS, WS = 144, 320
CAM_CFG = CameraConfig(fx=180.0, fy=180.0, cx=WS / 2.0, cy=HS / 2.0, baseline=0.537,
                       height=HS, width=WS)
CFG = dataclasses.replace(fast_config(), camera=CAM_CFG)
# Enough frames for one promotion (about every 10 frames at this step).
NUM_FRAMES = 13


@pytest.fixture(scope="module")
def sequence():
    cam = JPinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    poses = drive_trajectory(NUM_FRAMES, step=0.35, seed=4)
    frames = list(stereo_sequence(make_driving_scene(3), cam, 0.537, poses, HS, WS))
    return poses, frames


@pytest.fixture(scope="module", params=["bilinear", "mm"])
def runs(request, sequence):
    _, frames = sequence
    cfg = dataclasses.replace(CFG, tracker=dataclasses.replace(CFG.tracker,
                                                               interp=request.param))
    return request.param, j_run_sequence(frames, cfg), t_run_sequence(frames, cfg, device="cpu")


def test_run_sequence_matches_reference(sequence, runs):
    poses, _ = sequence
    interp, rj, rt = runs
    assert rj.failed_at is None and rt.failed_at is None
    assert rt.num_frames == rj.num_frames == NUM_FRAMES
    assert rt.keyframe_ids == rj.keyframe_ids
    assert len(rt.keyframe_ids) >= 2  # at least one promotion ran depth again
    assert rt.lost_ids == rj.lost_ids
    err_j = np.linalg.norm(rj.poses[:, :3, 3] - poses[:, :3, 3], axis=1)
    err_t = np.linalg.norm(rt.poses[:, :3, 3] - poses[:, :3, 3], axis=1)
    assert err_t.mean() < 0.05
    if interp == "bilinear":
        # fast_config with the smooth sampler: every pose within 1e-3 m and
        # 1e-3 per rotation entry (measured: 4e-5).
        np.testing.assert_allclose(rt.poses[:, :3, 3], rj.poses[:, :3, 3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(rt.poses[:, :3, :3], rj.poses[:, :3, :3], rtol=0, atol=1e-3)
    else:
        # fast_config as shipped. The "mm" sampler's bf16 x-weight makes the
        # LM paths of any two float32 implementations part (the reference's
        # own compiled and op-by-op runs among them; tests/test_torch_tracker.py,
        # ROADMAP C), by up to 4e-2 m at this promotion frame. Held instead:
        # the same keyframe and lost decisions (above) and the same accuracy.
        assert abs(err_t.mean() - err_j.mean()) < 0.01
        np.testing.assert_allclose(rt.poses[:, :3, 3], rj.poses[:, :3, 3], rtol=0, atol=0.05)


def test_step_from_carried_state(sequence):
    """One step from the reference's state, carried across: same summary."""
    _, frames = sequence
    j_init = jax.jit(lambda l, r: jo.init(l, r, CFG))
    j_step = jax.jit(lambda s, l, r: jo.step(s, l, r, CFG))
    state, ok = j_init(*map(jnp.asarray, frames[0]))
    assert bool(ok)
    for left, right in frames[1:3]:
        state, _ = j_step(state, jnp.asarray(left), jnp.asarray(right))
    carried = interop.state_from_numpy(jax.tree_util.tree_map(np.asarray, state), "cpu")
    back = interop.state_to_numpy(carried)
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, state)),
                    _leaves(back)):
        np.testing.assert_array_equal(a, b)

    left, right = frames[3]
    _, out_j = j_step(state, jnp.asarray(left), jnp.asarray(right))
    new_t, out_t = to.step(carried, torch.from_numpy(left), torch.from_numpy(right), CFG)
    sj, st = np.asarray(out_j.summary), out_t.summary.numpy()
    # [0:32] the two poses, within the "mm" tracker's 5e-4
    # (tests/test_torch_tracker.py:POSE_ATOL, ROADMAP C); [32:36] flags;
    # [36] motion; [37] depth survivors; [38] final tracking cost.
    np.testing.assert_allclose(st[:32], sj[:32], rtol=0, atol=5e-4)
    np.testing.assert_array_equal(st[32:36], sj[32:36])
    np.testing.assert_allclose(st[36:38], sj[36:38], rtol=0, atol=5e-4)
    np.testing.assert_allclose(st[38], sj[38], rtol=1e-2)
    assert int(new_t.frame_id) == int(state.frame_id) + 1 == 3


def _leaves(state):
    out = []

    def collect(v):
        if isinstance(v, tuple):
            for u in v:
                collect(u)
        else:
            out.append(v)

    for f in dataclasses.fields(state):
        collect(getattr(state, f.name))
    return out


def test_unported_options_and_devices_raise(sequence):
    _, frames = sequence
    for kw in (dict(checkpoint_path="state.npz"), dict(resume=True), dict(debug_checks=True)):
        with pytest.raises(NotImplementedError, match="A9"):
            t_run_sequence(frames[:2], CFG, device="cpu", **kw)
    dense = dataclasses.replace(CFG, tracker=dataclasses.replace(CFG.tracker, engine="dense"))
    with pytest.raises(NotImplementedError, match="photometric"):
        to.init(*frames[0], dense, device="cpu")
    # The card is never swapped for the CPU.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_run_sequence(frames[:2], CFG, device="cuda")
