"""The keyframe store and windowed BA: the port against the reference.

Inputs are made with numpy from a seed (the store) or by the reference's own
BA fixture (tests/test_ba.py:_make_problem: 96x160, K 4, P 512, seed 31,
pose noise 0.02), pulled to numpy and handed to both packages through
``odometry_torch.interop``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.kernels.points import PointSet as JPointSet
from odometry_tpu.mapping import ba as jba
from odometry_tpu.mapping import keyframe as jkf
from odometry_torch import interop
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.kernels.points import PointSet
from odometry_torch.mapping import ba as tba
from odometry_torch.mapping import keyframe as tkf
from test_ba import CAM as JCAM, K, _make_problem

CAM = Pinhole.create(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy)
# Reference tolerances (tests/test_distributed.py:81-87): poses 2e-4, inverse
# depths 1e-4. The gauge prior of 1e8 on the 6K x 6K system makes LAPACK's
# solve and XLA's differ at that level.
POSE_ATOL, INV_ATOL = 2e-4, 1e-4

# ---------------------------------------------------------------- the store

CAP_KF, CAP_PTS, HI, WI = 4, 64, 48, 64


def _image(rng, H, W):
    """A ramp plus noise: pool cells of distinct means, as in a keyframe. (On
    uniform noise every cell's mean is near 127.5, and standardizing the
    thumbnail amplifies the pooling sums' float32 rounding past 1e-6.)"""
    yy, xx = np.mgrid[:H, :W]
    return (2.0 * xx + 1.5 * yy + rng.uniform(-20, 20, (H, W))).astype(np.float32)


def _keyframe(rng, k):
    """Numpy inputs of one insert: (xs, ys, inv_depth, valid, num), intensity,
    pose, frame_id, image, path."""
    valid = rng.random(CAP_PTS) < 0.7
    pts = (rng.uniform(0, WI, CAP_PTS).astype(np.float32),
           rng.uniform(0, HI, CAP_PTS).astype(np.float32),
           rng.uniform(0.05, 1.0, CAP_PTS).astype(np.float32), valid,
           np.int32(valid.sum()))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.standard_normal(3)
    return (pts, rng.uniform(0, 255, CAP_PTS).astype(np.float32), pose, 10 * k + 3,
            _image(rng, HI, WI), np.float32(0.35 * k))


def _insert(mod, store, kf, PS, arr, do=None):
    pts, inten, pose, fid, image, path = kf
    args = (PS(*(arr(a) for a in pts)), arr(inten), arr(pose), fid, arr(image), arr(path))
    if do is None:
        return mod.insert_keyframe(store, *args)
    return mod.maybe_insert_keyframe(store, arr(np.bool_(do)), *args)


def _assert_store_equal(ts, js):
    """Every field equal, the thumbnails within 1e-6 (pooling sums and a norm
    in another float32 summation order)."""
    tn = interop.store_to_numpy(ts)
    for f in dataclasses.fields(tkf.KeyframeStore):
        a, b = getattr(tn, f.name), np.asarray(getattr(js, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if f.name == "thumb":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_keyframe_store_matches_reference():
    rng = np.random.default_rng(7)
    js = jkf.create_store(CAP_KF, CAP_PTS, HI, WI)
    ts = tkf.create_store(CAP_KF, CAP_PTS, HI, WI, device="cpu")
    _assert_store_equal(ts, js)
    for k in range(CAP_KF + 2):  # the ring wraps twice past its capacity
        kf = _keyframe(rng, k)
        js = _insert(jkf, js, kf, JPointSet, jnp.asarray)
        before = ts
        ts = _insert(tkf, ts, kf, PointSet, torch.as_tensor)
        _assert_store_equal(ts, js)
        assert int(before.count) == k  # the old store is left as it was
        if k == 1:  # fewer keyframes than the window: the earliest repeats
            np.testing.assert_array_equal(tkf.window_slots(ts, 3).numpy(),
                                          np.asarray(jkf.window_slots(js, 3)))
            assert tkf.window_slots(ts, 3).tolist() == [0, 0, 1]
    for window in (3, CAP_KF):  # more keyframes than the window
        slots = tkf.window_slots(ts, window)
        assert slots.dtype == torch.int32
        np.testing.assert_array_equal(slots.numpy(), np.asarray(jkf.window_slots(js, window)))
    assert tkf.window_slots(ts, 3).tolist() == [3, 0, 1]

    slots = np.array([1, 3], np.int32)
    poses = rng.standard_normal((2, 4, 4)).astype(np.float32)
    _assert_store_equal(tkf.update_poses(ts, torch.from_numpy(slots), torch.from_numpy(poses)),
                        jkf.update_poses(js, jnp.asarray(slots), jnp.asarray(poses)))

    kf = _keyframe(rng, 9)
    for do in (False, True):
        _assert_store_equal(_insert(tkf, ts, kf, PointSet, torch.as_tensor, do),
                            _insert(jkf, js, kf, JPointSet, jnp.asarray, do))


def test_thumbnail_and_empty_planes():
    img = _image(np.random.default_rng(2), 40, 70)
    np.testing.assert_allclose(tkf.thumbnail(torch.from_numpy(img)).numpy(),
                               np.asarray(jkf.thumbnail(jnp.asarray(img))), rtol=0, atol=1e-6)
    # A 0x0 store keeps empty images and thumbnails through an insert.
    rng = np.random.default_rng(5)
    kf = _keyframe(rng, 0)
    ts = _insert(tkf, tkf.create_store(CAP_KF, CAP_PTS, device="cpu"), kf, PointSet,
                 torch.as_tensor)
    js = _insert(jkf, jkf.create_store(CAP_KF, CAP_PTS), kf, JPointSet, jnp.asarray)
    _assert_store_equal(ts, js)
    assert ts.image.shape == (CAP_KF, 0, 0) and ts.thumb.shape == (CAP_KF, 0, 0)


# ---------------------------------------------------------------- BA


@pytest.fixture(scope="module")
def problem():
    jp, _, _ = _make_problem(pose_noise=0.02)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, interop.ba_problem_from_numpy(tree, "cpu")


def test_linearize_matches_reference(problem):
    """The valid mask exactly; residuals and weights within 1e-4 on 98% of
    the valid lanes and, on every lane, within the reference's own spread
    between its compiled and its op-by-op run. The relative poses already
    differ from XLA's contraction in the last bit, and an image gradient of
    tens of grey levels per pixel turns one ulp of a projected coordinate
    into a few 1e-4 of residual."""
    jp, tp = problem
    cfg_j, cfg_t = jba.BAConfig(window=K), tba.BAConfig(window=K)
    rj, wj, Jij, Jjj, Jdj, vj = jba._linearize(jp, JCAM, cfg_j)
    rc, wc, *_ = jax.jit(lambda p: jba._linearize(p, JCAM, cfg_j))(jp)
    rt, wt, Jit, Jjt, Jdt, vt = tba._linearize(tp, CAM, cfg_t)
    v = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), v)
    assert v.sum() > 2000
    for a, b, c in ((rt, rj, rc), (wt, wj, wc)):
        b = np.asarray(b)
        spread = np.abs(np.asarray(c) - b).max()
        err = np.abs(a.numpy() - b)
        assert err.max() <= max(1e-4, spread), (err.max(), spread)
        assert (err[v] <= 1e-4).mean() >= 0.98
    for a, b in ((Jit, Jij), (Jjt, Jjj), (Jdt, Jdj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())
    # The residual-only pass returns the same residuals and no Jacobians.
    r2, w2, *rest = tba._linearize(tp, CAM, cfg_t, jac=False)
    assert torch.equal(r2, rt) and torch.equal(w2, wt) and rest[:3] == [None, None, None]


@pytest.mark.parametrize("fix_depths", [True, False])
def test_reduced_system_matches_reference(problem, fix_depths):
    """Hred and bred within 1e-4 of the reference's largest entry (they sum
    ~24k products per entry in another order)."""
    jp, tp = problem
    cfg_j = jba.BAConfig(window=K, fix_depths=fix_depths)
    cfg_t = tba.BAConfig(window=K, fix_depths=fix_depths)
    lin_j = jba._linearize(jp, JCAM, cfg_j)
    lin_t = tba._linearize(tp, CAM, cfg_t)
    red_j = jba._assemble_and_reduce(*lin_j[:5], K, cfg_j)
    red_t = tba._assemble_and_reduce(*lin_t[:5], K, cfg_t)
    for name, a, b in zip(("Hred", "bred", "Hdd", "bd", "B", "inv_Hdd"), red_t, red_j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fix_depths", [True, False])
def test_ba_solve_matches_reference(problem, fix_depths):
    jp, tp = problem
    rj = jba.ba_solve(jp, JCAM, jba.BAConfig(window=K, iters=3, fix_depths=fix_depths))
    rt = tba.ba_solve(tp, CAM, tba.BAConfig(window=K, iters=3, fix_depths=fix_depths))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(rt.inv_depth.numpy(), np.asarray(rj.inv_depth), rtol=0,
                               atol=INV_ATOL)
    for a, b in ((rt.cost_initial, rj.cost_initial), (rt.cost_final, rj.cost_final)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    assert int(rt.num_residuals) == int(rj.num_residuals) > 2000
    assert float(rt.cost_final) <= float(rt.cost_initial)
    if fix_depths:
        assert torch.equal(rt.inv_depth, tp.inv_depth)


def test_ba_rolls_back_a_cost_increasing_step(problem, monkeypatch):
    """A step that raises the cost is scored after it is applied and rolled
    back, leaving the state as it was. (The reference's own fixture for this,
    damping 0 and Huber delta 1 at pose noise 0.3, is too ill-conditioned to
    carry over: there the reference's step raises the cost and the port's
    solve, from the same system in another summation order, lowers it.)"""
    _, tp = problem
    step = tba._pose_step
    monkeypatch.setattr(tba, "_pose_step", lambda *a: 50.0 * step(*a))
    res = tba.ba_solve(tp, CAM, tba.BAConfig(window=K, iters=2))
    assert torch.equal(res.pose, tp.pose) and torch.equal(res.inv_depth, tp.inv_depth)
    assert float(res.cost_final) == float(res.cost_initial)
    with pytest.raises(ValueError, match="iters"):
        tba.ba_solve(tp, CAM, tba.BAConfig(iters=0))
