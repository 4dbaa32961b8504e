"""The sweep's default layout is the reference's (ROADMAP C14).

In the reference a rank is a device: ``sequence_mesh()`` takes every device
and ``run_sweep`` steps each device's sequences as one ``vmap`` batch, so on
one device the whole sweep is one batch. The port's ``sequence_mesh()``
gives one rank per device it is given, and ``run_sweep`` without a mesh
takes it: on one device every sequence is stepped as one batch, with one
depth run per batched depth step. ``sequence_mesh(S)`` stays the explicit
layout of S ranks stepped in turn.

Sizes are tests/test_torch_batch.py's (64x96, 4 sequences, 3 frames), which
also holds that batch to the reference's ``vmap`` on a one-device mesh.
"""

import numpy as np
import pytest

from odometry_torch import config as tc
from odometry_torch.distributed import sweep as tsw
from odometry_torch.distributed.mesh import sequence_mesh
from odometry_torch.pipeline import odometry as to
from odometry_torch.utils.batch import batch_size
from tests.test_torch_batch import NUM_FRAMES, NUM_SEQS, _configs
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

CFG_T = _configs(tc)


@pytest.fixture(scope="module")
def sequences():
    """NUM_SEQS sequences of NUM_FRAMES numpy (left, right) pairs, rendered
    by the port on the CPU: scene s, drive_trajectory(seed=s)."""
    from odometry_torch.camera.pinhole import Pinhole
    from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo

    c = CFG_T.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    return [[tuple(a.numpy() for a in render_stereo(make_scene(s, depth=14.0, device="cpu"),
                                                    cam, c.baseline, T, c.height, c.width)[:2])
             for T in drive_trajectory(NUM_FRAMES, step=0.35, seed=s)]
            for s in range(NUM_SEQS)]


def test_sequence_mesh_gives_one_rank_per_device():
    assert sequence_mesh(device="cpu").shape == {"seq": 1}
    assert sequence_mesh(device=["cpu"] * 3).shape == {"seq": 3}
    assert sequence_mesh(NUM_SEQS, device="cpu").shape == {"seq": NUM_SEQS}


def _counted_sweep(monkeypatch, sequences, mesh):
    """run_sweep with the compute_depth calls counted and the per-rank
    state batch sizes seen by progress."""
    calls, sizes = [0], []
    real = to.compute_depth

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(to, "compute_depth", counted)
    poses = tsw.run_sweep(sequences, CFG_T, mesh, device="cpu",
                          progress=lambda i, states, outs, ok: sizes.append(
                              [batch_size(s) for s in states]))
    monkeypatch.setattr(to, "compute_depth", real)
    return poses, calls[0], sizes


def test_default_sweep_is_one_batch(monkeypatch, sequences):
    poses, depth_calls, sizes = _counted_sweep(monkeypatch, sequences, None)
    one, one_calls, _ = _counted_sweep(monkeypatch, sequences, sequence_mesh(1, device="cpu"))
    # One rank holding all S sequences, on every frame, and one depth run per
    # frame for all of them (depth every frame; S in turn).
    assert sizes == [[NUM_SEQS]] * NUM_FRAMES
    assert depth_calls == one_calls == NUM_FRAMES
    np.testing.assert_array_equal(poses, one)
