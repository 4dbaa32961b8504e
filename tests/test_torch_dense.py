"""Dense engine: port vs reference residual_jacobian, normal_equations,
solve_pose and the dense refine_depth, at 48x96.

Both packages get the same frames (rendered by the port's renderer, which
tests/test_torch_synthetic.py holds to the reference's), the same exact
keyframe depth and the same starting poses. The reference runs op by op
(``jax.disable_jit()``), as its source is written: compiled, XLA:CPU
contracts the warp arithmetic into fused multiply-adds, which moves "floor"
warps across integer pixels (ROADMAP C2). Against the op-by-op reference the
port's per-pixel systems are bit-identical.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.camera.pinhole import intrinsic_pyramid as j_intrinsic_pyramid
from odometry_tpu.depth import estimator as je
from odometry_tpu.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_tpu.kernels import photometric as jph
from odometry_tpu.tracking import tracker as jt
from odometry_torch import config as tc
from odometry_torch.camera.pinhole import Pinhole as TPinhole
from odometry_torch.camera.pinhole import intrinsic_pyramid as t_intrinsic_pyramid
from odometry_torch.data.synthetic import drive_trajectory, make_driving_scene, render_stereo
from odometry_torch.depth import estimator as te
from odometry_torch.kernels import photometric as tph
from odometry_torch.tracking import tracker as tt

H, W = 48, 96
FX = 0.58 * W
CAM_J = JPinhole.create(FX, FX, W / 2.0, H / 2.0)
CAM_T = TPinhole.create(FX, FX, W / 2.0, H / 2.0)
LEVELS = 3  # adapt_to_camera's cap at 48 px: the coarsest level keeps 12 rows


def _tracker(C, interp):
    t = C.kitti_config().tracker
    return dataclasses.replace(t, num_levels=LEVELS, max_iterations=t.max_iterations[:LEVELS],
                               interp=interp)


@pytest.fixture(scope="module")
def sequence():
    scene = make_driving_scene(3, device="cpu")
    poses = drive_trajectory(3, step=0.25, seed=4)
    frames = [tuple(a.numpy() for a in render_stereo(scene, CAM_T, 0.537, T, H, W))
              for T in poses]
    pyrs = [tuple(np.asarray(p) for p in gaussian_image_pyramid(jnp.asarray(f[0]), LEVELS))
            for f in frames]
    dpyr = tuple(np.asarray(d) for d in depth_pyramid(jnp.asarray(1.0 / frames[0][2]), LEVELS,
                                                      smooth=False, indexing="odd"))
    return poses, frames, pyrs, dpyr


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("interp", ["floor", "bilinear"])
@pytest.mark.parametrize("level", [0, 1])
def test_residual_jacobian_matches_eager_reference(sequence, interp, level):
    poses, _, pyrs, dpyr = sequence
    T1 = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    args = (pyrs[0][level], dpyr[level], pyrs[1][level])
    with jax.disable_jit():
        ref = jph.residual_jacobian(*map(jnp.asarray, args),
                                    j_intrinsic_pyramid(CAM_J, LEVELS)[level], jnp.asarray(T1),
                                    interp=interp)
    port = tph.residual_jacobian(*map(_t, args), t_intrinsic_pyramid(CAM_T, LEVELS)[level],
                                 _t(T1), interp=interp)
    assert int(port.valid.sum()) > 100
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    # Normal equations: the same system, summed in another order (float32),
    # within 1e-5 of the largest entry.
    w = np.random.default_rng(level).uniform(0.1, 1.0, (H >> level, W >> level)).astype(
        np.float32)
    ej = jph.normal_equations(ref, jnp.asarray(w))
    et = tph.normal_equations(port, _t(w))
    assert int(ej.num_valid) == int(et.num_valid)
    scale = np.abs(np.asarray(ej.JtWJ)).max()
    np.testing.assert_allclose(et.JtWJ.numpy(), np.asarray(ej.JtWJ), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(et.JtWr.numpy(), np.asarray(ej.JtWr), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ej.JtWr)).max())
    np.testing.assert_allclose(float(et.err), float(ej.err), rtol=1e-5)


@pytest.mark.parametrize("interp", ["floor", "bilinear"])
def test_solve_pose_matches_eager_reference(sequence, interp):
    """From the same start, the same per-level LM iteration counts and poses
    within 1e-4 (the normal equations' float32 sum order moves the 6x6
    system by ulps, and the solve by that times its condition number)."""
    poses, _, pyrs, dpyr = sequence
    cfg_j, cfg_t = _tracker(jc, interp), _tracker(tc, interp)
    for k in (1, 2):
        T0 = (np.linalg.inv(poses[k - 1]) @ poses[0]).astype(np.float32)
        with jax.disable_jit():
            rj = jt.solve_pose(tuple(map(jnp.asarray, pyrs[0])), tuple(map(jnp.asarray, dpyr)),
                               tuple(map(jnp.asarray, pyrs[k])), CAM_J, cfg_j, jnp.asarray(T0))
        rt = tt.solve_pose(tuple(map(_t, pyrs[0])), tuple(map(_t, dpyr)),
                           tuple(map(_t, pyrs[k])), CAM_T, cfg_t, _t(T0))
        assert bool(rj.ok) and bool(rt.ok)
        assert [int(s.iters) for s in rt.stats] == [int(s.iters) for s in rj.stats]
        Tj, Tt = np.asarray(rj.T), rt.T.numpy()
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-4)
        T_true = np.linalg.inv(poses[k]) @ poses[0]
        assert np.linalg.norm(Tt[:3, 3] - T_true[:3, 3]) < 0.05


@pytest.mark.parametrize("interp", ["floor", "bilinear"])
def test_refine_depth_matches_eager_reference(sequence, interp):
    """Dense per-pixel inverse-depth LM from a perturbed true depth: the same
    iteration count, cost within 1e-5 (relative), and the refined map within
    1e-6 (1/m) where both are finite."""
    _, frames, _, _ = sequence
    left, right, z = frames[0]
    rng = np.random.default_rng(1)
    inv0 = (1.0 / z * (1.0 + rng.normal(0, 0.02, z.shape))).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[4:-4, 4:-4] = rng.uniform(size=(H - 8, W - 8)) < 0.5
    cam_kw = dict(fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, baseline=0.537, height=H, width=W)
    dj = dataclasses.replace(jc.kitti_config().depth, interp=interp)
    dt = dataclasses.replace(tc.kitti_config().depth, interp=interp)
    args = (left, right, inv0, mask)
    with jax.disable_jit():
        rj = je.refine_depth(*map(jnp.asarray, args), jc.CameraConfig(**cam_kw), dj)
    rt = te.refine_depth(*map(_t, args), tc.CameraConfig(**cam_kw), dt)
    assert int(rt[2]) == int(rj[2]) > 1
    np.testing.assert_allclose(float(rt[3]), float(rj[3]), rtol=1e-5)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rt[1].numpy() == -1000.0, np.asarray(rj[1]) == -1000.0)
