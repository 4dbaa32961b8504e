"""The dense tracking engine on the batched sweep's path, and its counters.

``init_batch``/``step_batch`` under ``tools.profile_step.dense_config()``
(kitti_config with ``engine="dense"``: every pixel of every pyramid level,
depth every frame) are held lane by lane to the benchmark's plain reference,
``vobench/plain``'s ``init``/``step`` on each sequence alone, on driving
frames cut to 96x320 by ``config.at_size``. The batch is the reference's
batch (``step_batch``) bit for bit. A lane stepped alone takes the unbatched
6x6 products and pixel sums (``utils/batch.py:one_lane_unbatched``), so it
parts from its lane of the batch by float32 rounding, which floor warps and
the LM's accept/reject test can amplify (ROADMAP C13): poses are held within
LANE_ATOL, and every decision, counter and iteration count is equal.

The counters: ``DENSE_PX`` adds B * H_l * W_l an iteration,
``dense_weighted()`` adds every lane's ``num_valid``, ``DENSE_ITERS`` the
iterations; the point engine moves none of them.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from odometry_torch import config as tc
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.data.synthetic import drive_trajectory, make_driving_scene, render_stereo
from odometry_torch.pipeline import odometry as to
from odometry_torch.tools.profile_step import dense_config
from odometry_torch.tracking import tracker as tt
from torch_tools_reference import one_torch_thread  # noqa: F401
from torch_tracker_inputs import TRACK_CFGS, solve, tracker_batch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LANES, FRAMES, H, W = 2, 4, 96, 320
# A lane of the batch against the reference on that lane alone. Most steps
# part by float32 rounding (~1e-6); where a rounding moves a floor warp
# across a pixel or flips an LM accept, the converged pose moves by ~1e-3
# (1.07e-3 at frame 3 of lane 0 here). The benchmark holds ref_sweep's
# translation gap, a median, within 4e-3 m at full size.
LANE_ATOL = 3e-3
DECISIONS = ("promoted", "lost", "depth_ok", "track_ok")
COUNTS = ("frame_id", "kf_count", "healthy", "lost_streak")


@pytest.fixture(scope="module")
def cfg():
    return tc.at_size(dense_config(), H, W)


@pytest.fixture(scope="module")
def frames(cfg):
    """(left, right), each (FRAMES, LANES, H, W): lane s drives scene s of
    the driving family along drive_trajectory(seed=s), as the benchmark's
    KITTI sweep does at full size."""
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    left, right = torch.empty(2, FRAMES, LANES, H, W)
    for s in range(LANES):
        scene = make_driving_scene(s, side_x=20.0, wall_z=26.0, device="cpu")
        for i, T in enumerate(drive_trajectory(FRAMES, step=0.25, seed=s)):
            left[i, s], right[i, s] = render_stereo(scene, cam, c.baseline, T, H, W)[:2]
    return left, right


def _counters():
    return tt.DENSE_PX, tt.dense_weighted(), tt.DENSE_ITERS


def test_dense_sweep_follows_the_plain_reference_lane_by_lane(cfg, frames):
    from vobench import harness
    from vobench.plain import config as plain_config
    from vobench.plain import odometry as po

    assert cfg.tracker.engine == "dense" and cfg.depth_every_frame
    pcfg = harness.build_config(plain_config, dataclasses.asdict(cfg))
    left, right = frames
    state, _ = to.init_batch(left[0], right[0], cfg, device="cpu")
    batch, _ = po.init_batch(left[0], right[0], pcfg, device="cpu")
    refs = [po.init(left[0, b], right[0, b], pcfg, device="cpu")[0] for b in range(LANES)]
    px0, weighted0, iters0 = _counters()
    for i in range(1, FRAMES):
        state, out = to.step_batch(state, left[i], right[i], cfg)
        batch, bout = po.step_batch(batch, left[i], right[i], pcfg)
        assert torch.equal(out.pose_to_kf, bout.pose_to_kf)
        for k in ("cur_pose", "kf_pose", "pose_init", *COUNTS):
            assert torch.equal(getattr(state, k), getattr(batch, k)), (i, k)
        for b in range(LANES):
            refs[b], want = po.step(refs[b], left[i, b], right[i, b], pcfg)
            torch.testing.assert_close(out.pose_to_kf[b], want.pose_to_kf, rtol=0,
                                       atol=LANE_ATOL)
            for k in ("cur_pose", "kf_pose", "pose_init"):
                torch.testing.assert_close(getattr(state, k)[b], getattr(refs[b], k), rtol=0,
                                           atol=LANE_ATOL)
            for k in DECISIONS:
                assert bool(getattr(out, k)[b]) == bool(getattr(want, k)), (i, b, k)
            for k in COUNTS:
                assert int(getattr(state, k)[b]) == int(getattr(refs[b], k)), (i, b, k)
            assert int(out.num_valid_depth[b]) == int(want.num_valid_depth)
            for got_l, want_l in zip(out.track_stats, want.track_stats):
                assert int(got_l.iters[b]) == int(want_l.iters)
    # Every step ran the dense engine on the whole batch.
    px, weighted, iters = (a - b for a, b in zip(_counters(), (px0, weighted0, iters0)))
    assert iters > 0 and 0 < weighted < px


@pytest.fixture(scope="module")
def dense_batch():
    cfg = TRACK_CFGS["dense"]()
    return cfg, tracker_batch(LANES, 48, 160, cfg, "cpu", seed=3)


def test_dense_px_counts_every_pixel_of_every_iteration(dense_batch):
    cfg, batch = dense_batch
    px0, iters0, lm0 = tt.DENSE_PX, tt.DENSE_ITERS, tt.LM_ITERS
    res = solve(batch, cfg)
    # The loop runs to the batch's most iterations at each level.
    per_level = [int(st.iters.max()) for st in res.stats]
    sizes = [p.shape[-2] * p.shape[-1] for p in reversed(batch["pyr_kf"])]
    assert tt.DENSE_ITERS - iters0 == tt.LM_ITERS - lm0 == sum(per_level) > 0
    assert tt.DENSE_PX - px0 == sum(n * LANES * s for n, s in zip(per_level, sizes))


def test_dense_weighted_sums_num_valid_of_a_dispatched_solve(dense_batch, monkeypatch):
    cfg, batch = dense_batch
    system, seen = tt._dense_system, []

    def recording(*args):
        eqs = system(*args)
        seen.append(int(eqs.num_valid.sum()))
        return eqs

    monkeypatch.setattr(tt, "_dense_system", recording)
    weighted0, lm0 = tt.dense_weighted(), tt.LM_ITERS
    solve(batch, cfg)
    assert len(seen) == tt.LM_ITERS - lm0 > 0  # one system an iteration
    assert tt.dense_weighted() - weighted0 == sum(seen) > 0


@pytest.mark.parametrize("sampler", ["floor", "mm"])
def test_point_engine_leaves_the_dense_counters(sampler):
    cfg = TRACK_CFGS[sampler]()
    batch = tracker_batch(LANES, 48, 160, cfg, "cpu", seed=3)
    before, lm0 = _counters(), tt.LM_ITERS
    solve(batch, cfg)
    assert tt.LM_ITERS > lm0
    assert _counters() == before
