"""The batched sweep step: a rank's sequences as one batched state, stepped
by ``step_batch`` (the counterpart of the reference's ``jax.vmap(step)``),
held to the reference's ``vmap``-ped ``batched_step`` on a one-device mesh
and to each sequence stepped alone; and the batched pieces under it
(extraction, the depth scatter, the SSD plain versions, the LM loop's
frozen lanes, lazy depth on a sub-batch, interop of the batched state).

Sizes are the distributed tests' (64x96, 4 sequences, 3 frames). A batch
of one takes the unbatched products (``utils/batch.py:one_lane_unbatched``),
so a lane of a larger batch, whose pose and normal-equation products are
batched, agrees with its own run to float32 rounding (about 1e-6 here):
poses are held within LANE_ATOL, and iteration counts, keyframes and depth
health equal. The depth frontend has no such product: its lanes are held
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_tpu.distributed import sweep as jsw
from odometry_tpu.kernels import points as jpts
from odometry_torch import config as tc
from odometry_torch import interop
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.depth import estimator as te
from odometry_torch.distributed import sweep as tsw
from odometry_torch.distributed.mesh import sequence_mesh
from odometry_torch.kernels import disparity_band
from odometry_torch.kernels.points import PointSet, extract_points
from odometry_torch.pipeline import odometry as to
from odometry_torch.tracking import tracker as tt
from odometry_torch.utils.batch import lane

NUM_SEQS, NUM_FRAMES = 4, 3
# C1's tolerance for poses of two float32 trackers (tests/test_torch_tracker.py).
POSE_ATOL = 5e-4
# A lane of the batch against its own run: float32 rounding of the batched
# products (about 1e-6 here).
LANE_ATOL = 1e-5


def _configs(C, H=64, W=96, **pipeline):
    """tests/test_distributed.py's 64x96 configuration from config module `C`."""
    return C.PipelineConfig(
        camera=C.CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=C.TrackerConfig(num_levels=2, max_iterations=(6, 6), interp="bilinear",
                                depth_decimation="even"),
        depth=C.DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=6,
                            interp="bilinear"),
        keyframe=C.KeyframeConfig(**pipeline.pop("keyframe", {})),
        **pipeline,
    )


CFG_J, CFG_T = _configs(jc), _configs(tc)


@pytest.fixture(scope="module")
def sequences():
    """NUM_SEQS sequences of NUM_FRAMES numpy (left, right) pairs, rendered
    by the reference: scene s, drive_trajectory(seed=s)."""
    c = CFG_J.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    out = []
    for s in range(NUM_SEQS):
        scene = make_scene(s, depth=14.0)
        out.append([tuple(np.array(a) for a in
                          render_stereo(scene, cam, c.baseline, jnp.asarray(T), c.height,
                                        c.width)[:2])
                    for T in drive_trajectory(NUM_FRAMES, step=0.35, seed=s)])
    return out


def _frames(sequences, i, k):
    return np.stack([seq[i][k] for seq in sequences])


@pytest.fixture(scope="module")
def reference_vmap(sequences):
    """The reference's batched init and steps on a ONE-device seq mesh (a
    vmap of all 4): the initial batched state (numpy leaves) and per step
    (poses, depth_ok, promoted, global_ok)."""
    mesh = JMesh(np.array(jax.devices()[:1]), ("seq",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("seq")))
    states = jsw.batched_init(put(_frames(sequences, 0, 0)), put(_frames(sequences, 0, 1)),
                              CFG_J, mesh)
    init_tree = jax.tree_util.tree_map(np.asarray, states)
    steps = []
    for i in range(1, NUM_FRAMES):
        states, outs, ok = jsw.batched_step(states, put(_frames(sequences, i, 0)),
                                            put(_frames(sequences, i, 1)), CFG_J, mesh)
        steps.append((np.asarray(outs.cur_pose), np.asarray(outs.depth_ok),
                      np.asarray(outs.promoted), bool(ok)))
    return init_tree, steps


@pytest.fixture(scope="module")
def port_batch(sequences):
    """The port's sweep on sequence_mesh(1): one rank, one batched state of
    all 4 sequences; per step (states, outs, global_ok)."""
    mesh = sequence_mesh(1, device="cpu")
    states = tsw.batched_init(_frames(sequences, 0, 0), _frames(sequences, 0, 1), CFG_T, mesh)
    steps = []
    for i in range(1, NUM_FRAMES):
        states, outs, ok = tsw.batched_step(states, _frames(sequences, i, 0),
                                            _frames(sequences, i, 1), CFG_T, mesh)
        steps.append((states, outs, ok))
    return steps


def test_one_rank_batch_matches_the_reference_vmap(reference_vmap, port_batch):
    """Poses within POSE_ATOL of the reference's vmap of 4; depth_ok,
    keyframes and global_ok equal."""
    _, ref_steps = reference_vmap
    for (ref_pose, ref_ok, ref_promoted, ref_global), (states, outs, ok) in zip(ref_steps,
                                                                             port_batch):
        assert len(states) == len(outs) == 1
        out = outs[0]
        assert out.cur_pose.shape == (NUM_SEQS, 4, 4)
        np.testing.assert_allclose(out.cur_pose.numpy(), ref_pose, rtol=0, atol=POSE_ATOL)
        np.testing.assert_array_equal(out.depth_ok.numpy(), ref_ok)
        np.testing.assert_array_equal(out.promoted.numpy(), ref_promoted)
        assert bool(ok) == ref_global
        assert states[0].frame_id.shape == (NUM_SEQS,)


def test_each_lane_is_its_sequence_stepped_alone(sequences, port_batch):
    """Lane s of the batch against ``step`` of sequence s alone: poses
    within LANE_ATOL, per-level LM iterations, keyframes, depth health and
    depth products equal."""
    for s, seq in enumerate(sequences):
        state, _ = to.init(*seq[0], CFG_T, device="cpu")
        for i, (states, outs, _) in enumerate(port_batch, start=1):
            state, out = to.step(state, torch.from_numpy(seq[i][0]),
                                 torch.from_numpy(seq[i][1]), CFG_T)
            got = tsw.sequence_view(outs, s)
            np.testing.assert_allclose(got.cur_pose.numpy(), out.cur_pose.numpy(), rtol=0,
                                       atol=LANE_ATOL)
            assert ([int(st.iters) for st in got.track_stats]
                    == [int(st.iters) for st in out.track_stats])
            assert bool(got.promoted) == bool(out.promoted)
            assert bool(got.depth_ok) == bool(out.depth_ok)
            assert int(got.num_valid_depth) == int(out.num_valid_depth)
            np.testing.assert_array_equal(got.valid.numpy(), out.valid.numpy())
            view = tsw.sequence_view(states, s)
            assert int(view.kf_count) == int(state.kf_count)
            assert int(view.frame_id) == int(state.frame_id) == i


def _frozen_lane_cfg():
    """A tracker whose loop stops only at max_iters or with no residuals:
    no "good" stop (precision > 1), no lambda bail-out, no step tolerance."""
    return dataclasses.replace(CFG_T.tracker, precision=2.0, lambda_max=1e30, step_tol=0.0,
                               coarse_step_tol=0.0, max_iterations=(7, 5))


def test_frozen_lane_equals_its_single_run(sequences):
    """Lane 0's keyframe has no valid point: its LM loop stops after one
    iteration (no residuals) while lane 1 runs to max_iters on every level.
    Each lane equals its own single solve."""
    cfg = _frozen_lane_cfg()
    c = CFG_T.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    kf_levels, pyr_cur = [], []
    for s in (0, 1):
        state, _ = to.init(*sequences[s][0], CFG_T, device="cpu")
        levels = state.kf_track
        if s == 0:
            levels = tuple(lv._replace(pts=lv.pts._replace(valid=torch.zeros_like(lv.pts.valid)))
                           for lv in levels)
        kf_levels.append(levels)
        left = torch.from_numpy(sequences[s][1][0])
        pyr_cur.append(tuple(to.gaussian_image_pyramid(left, cfg.num_levels)))
    stack = lambda trees: jax.tree_util.tree_map(lambda *ts: torch.stack(ts), *trees)
    batched = tt.solve_pose_points(stack(kf_levels), stack(pyr_cur), cam, cfg)
    iters = [[int(st.iters[b]) for st in batched.stats] for b in (0, 1)]
    assert iters == [[1, 1], [5, 7]]  # coarsest level first
    assert batched.ok.tolist() == [False, True]
    for b in (0, 1):
        single = tt.solve_pose_points(kf_levels[b], pyr_cur[b], cam, cfg)
        got = lane(batched, b)
        np.testing.assert_allclose(got.T.numpy(), single.T.numpy(), rtol=0, atol=LANE_ATOL)
        assert bool(got.ok) == bool(single.ok)
        for a, e in zip(got.stats, single.stats):
            assert int(a.iters) == int(e.iters)
            np.testing.assert_allclose(float(a.err_final), float(e.err_final), rtol=1e-5)


def test_lazy_depth_runs_on_the_candidates_only(sequences, monkeypatch):
    """Lazy depth on a batch whose sequences 1 and 3 repeat frame 0 (no
    motion: no keyframe candidate) while 0 and 2 move past the threshold:
    one depth run of the 2 candidates; the others carry the skip branch's
    zeros with ok True, and each lane equals its single step."""
    cfg = _configs(tc, depth_every_frame=False, keyframe=dict(motion_threshold=0.02))
    seqs = [seq if s % 2 == 0 else [seq[0], seq[0]] for s, seq in enumerate(sequences)]
    mesh = sequence_mesh(1, device="cpu")
    states = tsw.batched_init(_frames(seqs, 0, 0), _frames(seqs, 0, 1), cfg, mesh)
    runs = []
    real = to.compute_depth
    monkeypatch.setattr(to, "compute_depth",
                        lambda left, *a: runs.append(left.shape[0]) or real(left, *a))
    _, outs, ok = tsw.batched_step(states, _frames(seqs, 1, 0), _frames(seqs, 1, 1), cfg, mesh)
    out = outs[0]
    assert runs == [2]
    assert out.promoted.tolist() == [True, False, True, False]
    assert bool(ok) and out.depth_ok.tolist() == [True] * 4
    for s in (1, 3):
        assert int(out.num_valid_depth[s]) == 0
        assert not bool(out.valid[s].any()) and not bool(out.inv_depth[s].any())
    monkeypatch.setattr(to, "compute_depth", real)
    for s, seq in enumerate(seqs[:2]):  # a candidate and a skipped sequence
        state, _ = to.init(*seq[0], cfg, device="cpu")
        _, single = to.step(state, torch.from_numpy(seq[1][0]), torch.from_numpy(seq[1][1]), cfg)
        got = lane(out, s)
        np.testing.assert_allclose(got.cur_pose.numpy(), single.cur_pose.numpy(), rtol=0,
                                   atol=LANE_ATOL)
        np.testing.assert_array_equal(got.inv_depth.numpy(), single.inv_depth.numpy())
        assert bool(got.promoted) == bool(single.promoted)


@pytest.mark.parametrize("order", ["row", "spread", "blocked"])
def test_batched_extraction_equals_per_image(order):
    """extract_points on (3, H, W) against each image's call and the
    reference's ``jnp.nonzero(size=capacity, fill_value=0)`` extraction,
    bit for bit, the zero fill past the survivors included. Image 2 has
    fewer set pixels than the capacity, image 0 more."""
    rng = np.random.default_rng(5)
    H, W, cap = 40, 64, 256
    values = rng.uniform(0.1, 2.0, size=(3, H, W)).astype(np.float32)
    mask = rng.uniform(size=(3, H, W)) < np.array([0.5, 0.1, 0.02])[:, None, None]
    prio = rng.uniform(size=(3, H, W)).astype(np.float32) if order == "blocked" else None
    batched = extract_points(torch.from_numpy(values), torch.from_numpy(mask), cap, order,
                             None if prio is None else torch.from_numpy(prio))
    assert batched.xs.shape == (3, cap) and batched.num.shape == (3,)
    assert int(batched.num[0]) == cap and int(batched.num[2]) < cap
    for b in range(3):
        single = extract_points(torch.from_numpy(values[b]), torch.from_numpy(mask[b]), cap,
                                order, None if prio is None else torch.from_numpy(prio[b]))
        ref = jpts.extract_points(jnp.asarray(values[b]), jnp.asarray(mask[b]), cap, order,
                                  None if prio is None else jnp.asarray(prio[b]))
        for a, e, r in zip(lane(batched, b), single, ref):
            np.testing.assert_array_equal(a.numpy(), e.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    n = int(batched.num[2])
    if order != "blocked":  # the fill: lanes past the survivors read pixel 0
        assert not bool(batched.xs[2, n:].any()) and not bool(batched.ys[2, n:].any())


@pytest.mark.parametrize("reduce", ["add", "amax"])
def test_batched_scatter_equals_per_image(reduce):
    """_scatter of (3, cap) lanes, with repeated pixels and dropped lanes,
    against each image's own _scatter bit for bit, and the reference's
    ``.at[ys, xs].max`` bit for bit and ``.add`` within 1e-6 (a pixel's
    repeated lanes may be summed in another order)."""
    rng = np.random.default_rng(7)
    H, W, cap = 12, 20, 300
    ys = torch.from_numpy(rng.integers(0, H + 2, size=(3, cap)))
    xs = torch.from_numpy(rng.integers(0, W + 2, size=(3, cap)))
    vals = torch.from_numpy(rng.normal(size=(3, cap)).astype(np.float32))
    keep = (ys < H) & (xs < W)
    batched = te._scatter(H, W, ys, xs, vals, keep, reduce)
    assert batched.shape == (3, H, W)
    for b in range(3):
        single = te._scatter(H, W, ys[b], xs[b], vals[b], keep[b], reduce)
        np.testing.assert_array_equal(batched[b].numpy(), single.numpy())
        k = keep[b].numpy()
        at = jnp.zeros((H, W), jnp.float32).at[ys[b].numpy()[k], xs[b].numpy()[k]]
        if reduce == "add":  # repeated pixels: sums of up to a few terms, any order
            np.testing.assert_allclose(batched[b].numpy(), np.asarray(at.add(vals[b].numpy()[k])),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(batched[b].numpy(),
                                          np.asarray(at.max(vals[b].numpy()[k])))


@pytest.mark.parametrize("band", [(12, 40), (None, None)])
def test_plain_ssd_takes_a_batch(band):
    """B1's and B2's plain version on (3, H, W) against three single calls,
    bit for bit on all four maps (the band, and the full search)."""
    rng = np.random.default_rng(3)
    left = torch.from_numpy(rng.uniform(0, 255, size=(3, 24, 80)).astype(np.float32))
    right = torch.roll(left, -9, dims=-1) + torch.from_numpy(
        rng.normal(size=(3, 24, 80)).astype(np.float32))
    kw = dict(boundary=4, min_disparity=band[0], max_disparity=band[1], lr=True,
              second_best=True)
    batched = disparity_band.disparity_band_plain(left, right, **kw)
    for b in range(3):
        single = disparity_band.disparity_band_plain(left[b], right[b], **kw)
        for a, e in zip(batched, single):
            np.testing.assert_array_equal(a[b].numpy(), e.numpy())


def test_flat_lane_fails_global_ok_of_a_one_rank_batch(sequences):
    """A flat frame (no depth survivors) in one lane of a one-rank batch
    makes that lane's depth_ok and global_ok False."""
    mesh = sequence_mesh(1, device="cpu")
    states = tsw.batched_init(_frames(sequences, 0, 0), _frames(sequences, 0, 1), CFG_T, mesh)
    lefts, rights = _frames(sequences, 1, 0), _frames(sequences, 1, 1)
    lefts[2] = rights[2] = 0.0
    _, outs, ok = tsw.batched_step(states, lefts, rights, CFG_T, mesh)
    assert outs[0].depth_ok.tolist() == [True, True, False, True]
    assert not bool(ok)


def test_reference_batched_state_round_trips_one_rank(reference_vmap):
    """The reference's batched state as ONE port state on a one-rank mesh
    and back, bit for bit; a mesh that does not divide it is refused."""
    init_tree, _ = reference_vmap
    states = interop.states_from_batched_numpy(init_tree, sequence_mesh(1, device="cpu"))
    assert len(states) == 1 and states[0].frame_id.shape == (NUM_SEQS,)
    back = interop.states_to_batched_numpy(states)
    ref_leaves = jax.tree_util.tree_leaves(init_tree)
    port_leaves = [leaf for f in dataclasses.fields(back)
                   for leaf in jax.tree_util.tree_leaves(getattr(back, f.name))]
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert a.shape[0] == NUM_SEQS
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        interop.states_from_batched_numpy(init_tree, sequence_mesh(3, device="cpu"))


def test_dense_engine_batch(sequences):
    """The dense engine (``solve_pose``) on a batch of two tracking problems
    (one keyframe, frames 1 and 2) against each single solve (per-level
    iterations equal, poses within LANE_ATOL) and the reference's
    ``jax.vmap(solve_pose)`` (poses within 1e-4, tests/test_torch_dense.py's
    tolerance for one frame, and equal iterations)."""
    from odometry_tpu.image.pyramid import depth_pyramid, gaussian_image_pyramid
    from odometry_tpu.tracking import tracker as jt

    n = 3
    cfg_j, cfg_t = (dataclasses.replace(C.kitti_config().tracker, num_levels=n,
                                        max_iterations=C.kitti_config().tracker.max_iterations[:n],
                                        interp="bilinear") for C in (jc, tc))
    seq = sequences[1]
    state, _ = to.init(*seq[0], CFG_T, device="cpu")
    dpyr = tuple(np.asarray(d) for d in depth_pyramid(jnp.asarray(state.kf_dpyr[0].numpy()), n,
                                                      indexing="even"))
    pyrs = [tuple(np.asarray(p) for p in gaussian_image_pyramid(jnp.asarray(f[0]), n))
            for f in seq]
    c = CFG_T.camera
    cam_t = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    cam_j = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    kf = tuple(np.stack([p, p]) for p in pyrs[0])
    dk = tuple(np.stack([d, d]) for d in dpyr)
    cur = tuple(np.stack([a, b]) for a, b in zip(pyrs[1], pyrs[2]))
    t = lambda tree: tuple(torch.from_numpy(np.array(a)) for a in tree)
    batched = tt.solve_pose(t(kf), t(dk), t(cur), cam_t, cfg_t)
    ref = jax.jit(jax.vmap(lambda a, b, d: jt.solve_pose(a, b, d, cam_j, cfg_j)))(
        *(tuple(map(jnp.asarray, x)) for x in (kf, dk, cur)))
    assert batched.ok.tolist() == [True, True]
    np.testing.assert_allclose(batched.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-4)
    for b in (0, 1):
        single = tt.solve_pose(t(pyrs[0]), t(dpyr), t(pyrs[b + 1]), cam_t, cfg_t)
        got = lane(batched, b)
        np.testing.assert_allclose(got.T.numpy(), single.T.numpy(), rtol=0, atol=LANE_ATOL)
        iters = [int(st.iters) for st in got.stats]
        assert iters == [int(st.iters) for st in single.stats]
        assert iters == [int(st.iters[b]) for st in ref.stats]


def test_init_batch_equals_init_per_sequence(sequences):
    """init_batch's lanes against init of each sequence: the depth products,
    keyframe point lists and poses bit for bit (the frontend's batched
    sums and scatters keep each image's order)."""
    state, ok = to.init_batch(_frames(sequences, 0, 0), _frames(sequences, 0, 1), CFG_T,
                              device="cpu")
    assert ok.shape == (NUM_SEQS,)
    for s, seq in enumerate(sequences):
        single, ok1 = to.init(*seq[0], CFG_T, device="cpu")
        assert bool(ok[s]) == bool(ok1)
        got = lane(state, s)
        for a, e in zip(jax.tree_util.tree_leaves(dataclasses.astuple(got)),
                        jax.tree_util.tree_leaves(dataclasses.astuple(single))):
            np.testing.assert_array_equal(a.numpy(), e.numpy())
    assert isinstance(state.kf_track[0].pts, PointSet)
