"""Loop closure (proposal, verification, correction): the port against the
reference.

The fixture is tests/test_loop_closure.py's ``loop_world``: 13 keyframes of
an out-and-back path through the reference's street scene at 144x320,
rendered by the reference, inserted into a reference ``KeyframeStore`` at
drifted (or true) poses and carried to the port with
``interop.store_from_numpy``. Each package gets its own configuration
objects.

Tolerances. Verification runs the tracker's LM solve with the "bilinear"
sampler, as the reference's tests do (tests/test_loop_closure.py:101): with
"mm" the compiled reference parts from op-by-op arithmetic at ~1e-4 (ROADMAP
C1). Over 4 levels of up to 40 iterations the two float32 solves are held
to 1e-4 in T_rel (measured 4.7e-7 on the accepted loop, 4.6e-7 at the wrong
place) and 1e-4 relative in the final cost (measured 3.3e-5 and 4.9e-6: a
mean over 2,048 robust residuals summed in another order); ``ok`` and the
inlier count must be equal. ``close_loop`` fed the same T_rel is held to the pose graph's
tolerance (tests/test_torch_pose_graph.py: 3e-4).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import make_driving_scene, render_stereo
from odometry_tpu.geometry import se3_exp
from odometry_tpu.image.pyramid import gaussian_blur3
from odometry_tpu.kernels.points import extract_points
from odometry_tpu.kernels.select import select_points
from odometry_tpu.mapping import keyframe as jkf
from odometry_tpu.mapping import loop_closure as jlc
from odometry_torch import config as tc
from odometry_torch import interop
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.mapping import loop_closure as tlc

H, W = 144, 320
FX = 400.0
BASELINE = 386.1448 / 718.856
CAP = 2048
T_ATOL = 1e-4
COST_RTOL = 1e-4
POSE_ATOL = 3e-4


def _out_and_back_poses(n_half: int, step: float):
    """tests/test_loop_closure.py:_out_and_back_poses."""
    poses = []
    for k in range(2 * n_half + 1):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (0.05 * np.sin(0.9 * k), 0.0, step * (k if k <= n_half else 2 * n_half - k))
        poses.append(T)
    return poses


@pytest.fixture(scope="module")
def loop_world():
    cam = JPinhole.create(FX, FX, W / 2.0, H / 2.0)
    poses = _out_and_back_poses(6, 0.25)
    scene = make_driving_scene(3)
    rendered = [render_stereo(scene, cam, BASELINE, jnp.asarray(T), H, W) for T in poses]
    return cam, poses, rendered


def _drifted_chain(poses, eps_twist):
    """Compound a per-step twist error into the chain (odometry drift)."""
    D = np.asarray(se3_exp(jnp.asarray(eps_twist, jnp.float32)))
    est = [poses[0]]
    for k in range(1, len(poses)):
        est.append(est[-1] @ (np.linalg.inv(poses[k - 1]) @ poses[k]) @ D)
    return [e.astype(np.float32) for e in est]


def _build_store(est_poses, rendered, n=None, images=True):
    """The reference's store of the first `n` keyframes (tests/
    test_loop_closure.py:_build_store); `images=False` keeps a 0x0 store."""
    n = len(rendered) if n is None else n
    store = jkf.create_store(len(rendered), CAP, H if images else 0, W if images else 0)
    for k, (l, _r, z) in enumerate(rendered[:n]):
        sel = select_points(gaussian_blur3(l), boundary=4, block_rows=8, block_cols=16,
                            grad_th=8.0, max_points_per_block=80)
        pts = extract_points(1.0 / jnp.asarray(z), sel, CAP, order="row")
        inten = l[pts.ys.astype(jnp.int32), pts.xs.astype(jnp.int32)]
        store = jkf.insert_keyframe(store, pts, inten, jnp.asarray(est_poses[k]), k,
                                    image=l if images else None, path=0.25 * k)
    return store


def _both(store):
    return store, interop.store_from_numpy(store, "cpu")


def _view(store) -> dict:
    """The host mirror run_slam keeps, read off a reference store."""
    return dict(occupied=np.asarray(store.occupied), frame_id=np.asarray(store.frame_id),
                pos=np.asarray(store.pose)[:, :3, 3], path=np.asarray(store.path),
                thumb=np.asarray(store.thumb))


@pytest.fixture(scope="module")
def drifted(loop_world):
    """~0.4% rotation and 8 mm translation error per step
    (tests/test_loop_closure.py:83-84)."""
    _, poses, rendered = loop_world
    return _both(_build_store(_drifted_chain(poses, [0.004, -0.008, 0.003, 0.002, -0.001, 0.004]),
                              rendered))


def _lc(C, **kw):
    return C.LoopClosureConfig(**kw)


def test_loop_closure_config_matches_reference():
    assert dataclasses.asdict(tlc.LoopClosureConfig()) == dataclasses.asdict(
        jlc.LoopClosureConfig())


@pytest.mark.parametrize("with_view", [False, True])
def test_propose_loop_matches_reference(drifted, with_view):
    js, ts = drifted
    kw = dict(radius=1.0, min_separation=4, min_inliers=150)
    view = _view(js) if with_view else None
    got = tlc.propose_loop(ts, _lc(tlc, **kw), view=view)
    want = jlc.propose_loop(js, _lc(jlc, **kw), view=view)
    assert got == want == (0, 12)  # the end of the loop closes against the start
    assert all(type(s) is int for s in got)


@pytest.mark.parametrize("with_view", [False, True])
def test_proposal_appearance_mismatch_matches_reference(loop_world, with_view):
    """Keyframe 6 (the far end) claims the newest's position: the appearance
    gate keeps it from being proposed, in both packages."""
    _, poses, rendered = loop_world
    js = _build_store(poses, rendered)
    js = dataclasses.replace(js, pose=js.pose.at[6].set(js.pose[12]))
    kw = dict(radius=0.5, min_separation=2, appearance_ncc=0.6)
    view = _view(js) if with_view else None
    got = tlc.propose_loop(interop.store_from_numpy(js, "cpu"), _lc(tlc, **kw), view=view)
    want = jlc.propose_loop(js, _lc(jlc, **kw), view=view)
    assert got == want
    assert got is None or got[0] != 6
    # With the gate off, the lying slot is the nearest and is proposed.
    kw["appearance_ncc"] = -1.0
    got = tlc.propose_loop(interop.store_from_numpy(js, "cpu"), _lc(tlc, **kw))
    assert got == jlc.propose_loop(js, _lc(jlc, **kw)) == (6, 12)


@pytest.mark.parametrize("n,images", [(4, True), (5, True), (13, False)])
def test_proposal_edge_cases_match_reference(loop_world, n, images):
    """Too few keyframes for min_separation=4 (4: fewer than 6 occupied; 5:
    no keyframe old enough is within the radius), and a store built without
    images, whose empty thumbnails make the proposal take the nearest
    position."""
    _, poses, rendered = loop_world
    js = _build_store(poses, rendered, n=n, images=images)
    kw = dict(radius=1.0, min_separation=4)
    got = tlc.propose_loop(interop.store_from_numpy(js, "cpu"), _lc(tlc, **kw))
    want = jlc.propose_loop(js, _lc(jlc, **kw))
    assert got == want
    assert (got is None) == (n < 13)


def _verify_both(js, ts, ci, ni, **kw):
    jcam = JPinhole.create(FX, FX, W / 2.0, H / 2.0)
    tcam = Pinhole.create(FX, FX, W / 2.0, H / 2.0)
    wj = jlc.verify_loop(js, ci, ni, jcam, jc.TrackerConfig(interp="bilinear", robust="huber"),
                         _lc(jlc, **kw))
    wt = tlc.verify_loop(ts, ci, ni, tcam, tc.TrackerConfig(interp="bilinear", robust="huber"),
                         _lc(tlc, **kw))
    assert bool(wt.ok) == bool(wj.ok)
    assert int(wt.inliers) == int(wj.inliers)
    np.testing.assert_allclose(wt.T_rel.numpy(), np.asarray(wj.T_rel), rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(float(wt.cost), float(wj.cost), rtol=COST_RTOL)
    return wj, wt


def test_verify_loop_accepts_the_drifted_loop_as_the_reference(loop_world, drifted):
    _, poses, _ = loop_world
    js, ts = drifted
    wj, wt = _verify_both(js, ts, 0, 12, radius=1.0, min_separation=4, min_inliers=150)
    assert bool(wt.ok), (float(wt.cost), int(wt.inliers))
    T_true = np.linalg.inv(poses[12]) @ poses[0]
    assert float(np.abs(wt.T_rel.numpy() - T_true).max()) < 5e-3


def test_verify_loop_rejects_the_wrong_place_as_the_reference(loop_world):
    """tests/test_loop_closure.py:118-136: keyframe 6 claims the start's pose
    (~1.5 m away); the solve finds the true pose and the correction gate
    rejects it, in both packages."""
    _, poses, rendered = loop_world
    js = _build_store(poses, rendered)
    js = dataclasses.replace(js, pose=js.pose.at[6].set(js.pose[0]))
    wj, wt = _verify_both(js, interop.store_from_numpy(js, "cpu"), 6, 12, radius=1.0,
                          min_separation=2, min_inliers=150, max_correction_t=0.5)
    assert not bool(wt.ok)


def test_close_loop_matches_reference(loop_world, drifted):
    """close_loop fed the reference's verified T_rel in both packages: the
    corrected store poses agree, the other fields are untouched, and the
    drift at the loop's end shrinks below 0.35 of itself (the reference's
    own claim)."""
    _, poses, _ = loop_world
    js, ts = drifted
    kw = dict(radius=1.0, min_separation=4, min_inliers=150)
    jcam = JPinhole.create(FX, FX, W / 2.0, H / 2.0)
    ver = jlc.verify_loop(js, 0, 12, jcam, jc.TrackerConfig(interp="bilinear", robust="huber"),
                          _lc(jlc, **kw))
    T_rel = np.array(ver.T_rel)
    j2 = jlc.close_loop(js, 0, 12, jnp.asarray(T_rel), _lc(jlc, **kw))
    t2 = tlc.close_loop(ts, 0, 12, torch.from_numpy(T_rel), _lc(tlc, **kw))
    np.testing.assert_allclose(t2.pose.numpy(), np.asarray(j2.pose), rtol=0, atol=POSE_ATOL)
    assert t2.pose is not ts.pose and torch.equal(ts.pose, interop.store_from_numpy(js, "cpu").pose)
    for f in dataclasses.fields(t2):
        if f.name != "pose":
            assert getattr(t2, f.name) is getattr(ts, f.name)
    before = np.linalg.norm(ts.pose[12, :3, 3].numpy() - poses[12][:3, 3])
    after = np.linalg.norm(t2.pose[12, :3, 3].numpy() - poses[12][:3, 3])
    assert before > 0.05 and after < 0.35 * before, (before, after)
