"""Point tracker: port vs reference prepare_keyframe and solve_pose_points.

Both packages get the same keyframe pyramids, inverse-depth pyramid and
current-frame pyramids (built once by the reference, handed over as numpy),
so the tests hold the tracker alone.

With the smooth "bilinear" sampler the reference runs its LM loops under
``jax.disable_jit()``: op by op, as its source is written, where the port
must take the same number of iterations. Compiled, XLA:CPU fuses the warp
arithmetic into fused multiply-adds. The "mm" sampler's bf16 x-weight turns
such last-ulp differences into residual changes of up to ~0.4 grey level
(test_mm_residuals_match_eager_reference), so under "mm" the reference's own
compiled and op-by-op runs can differ by an iteration, and the port is held
to the compiled reference's pose within the sampler's tolerance.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.camera.pinhole import intrinsic_pyramid as j_intrinsic_pyramid
from odometry_tpu.config import fast_config
from odometry_tpu.image.pyramid import central_gradients as j_gradients
from odometry_tpu.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_tpu.kernels import points as jp
from odometry_tpu.tracking import tracker as jt
from odometry_torch.camera.pinhole import Pinhole as TPinhole
from odometry_torch.camera.pinhole import intrinsic_pyramid as t_intrinsic_pyramid
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render
from odometry_torch.image.pyramid import central_gradients as t_gradients
from odometry_torch.kernels import points as tp
from odometry_torch.tracking import tracker as tt

# The 144x320 camera of tests/test_pipeline.py:288-295.
HS, WS = 144, 320
FAST = fast_config().tracker
LEVELS = FAST.num_levels
CAM_J = JPinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
CAM_T = TPinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)


@pytest.fixture(scope="module")
def sequence():
    # Frames from the port's renderer (tests/test_torch_synthetic.py holds it
    # to the reference's).
    scene = make_scene(3, depth=14.0, device="cpu")
    poses = drive_trajectory(3, step=0.35, seed=4)
    frames = [render(scene, CAM_T, T, HS, WS) for T in poses]
    pyrs = [tuple(np.asarray(p) for p in gaussian_image_pyramid(jnp.asarray(left.numpy()),
                                                                LEVELS))
            for left, _ in frames]
    # The keyframe's exact inverse depth on every pixel: the depth frontend
    # has its own tests.
    inv_depth = jnp.asarray(1.0 / frames[0][1].numpy())
    dpyr = tuple(np.asarray(d) for d in depth_pyramid(inv_depth, LEVELS, smooth=False,
                                                      indexing=FAST.depth_decimation))
    kj = jt.prepare_keyframe(tuple(map(jnp.asarray, pyrs[0])), tuple(map(jnp.asarray, dpyr)),
                             FAST)
    kt = tt.prepare_keyframe(_torch(pyrs[0]), _torch(dpyr), FAST)
    return poses, pyrs, kj, kt


def _torch(tree):
    return tuple(torch.from_numpy(np.array(a)) for a in tree)


def test_prepare_keyframe_exact(sequence):
    _, _, kj, kt = sequence
    assert len(kj) == len(kt) == LEVELS
    # Extraction is integer bookkeeping on identical inputs: exact.
    for lj, lt in zip(kj, kt):
        assert int(lt.pts.num) > 0
        for a, b in zip(jax.tree_util.tree_leaves(lj), [*lt.pts, lt.intensity]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# Pose tolerance per sampler. "bilinear": 1e-4 (rotation entries) and
# 1e-4 m, and identical per-level iteration counts: float32 sums of a few
# thousand lanes in another order move the 6x6 system by ulps, and the solve
# by that times its condition number. "mm": 5e-4, counts not compared. Its
# bf16 x-weight turns any last-ulp change of a warped coordinate into a jump
# of up to ~0.4 grey level on the lanes whose rounding flips, so two float32
# implementations part at the first sum taken in another order (the normal
# equations), and a near-converged level-0 step can then sit on either side
# of the 1e-5 step tolerance: 4 iterations in the reference, 9 in the port,
# final poses 1.9e-4 apart (frame 1 here; ROADMAP C).
POSE_ATOL = {"bilinear": 1e-4, "mm": 5e-4}


@pytest.mark.parametrize("interp", ["mm", "bilinear"])
def test_solve_pose_points(sequence, interp):
    poses, pyrs, kj, kt = sequence
    cfg = dataclasses.replace(FAST, interp=interp)
    for k in range(1, len(poses)):
        # Start from the previous frame's true pose relative to the keyframe.
        T0 = (np.linalg.inv(poses[k - 1]) @ poses[0]).astype(np.float32)
        solve = lambda: jt.solve_pose_points(kj, tuple(map(jnp.asarray, pyrs[k])), CAM_J, cfg,
                                             jnp.asarray(T0))
        if interp == "bilinear":
            with jax.disable_jit():
                rj = solve()
        else:
            rj = solve()  # compiled, as the reference runs it
        rt = tt.solve_pose_points(kt, _torch(pyrs[k]), CAM_T, cfg, torch.from_numpy(T0))
        assert bool(rj.ok) and bool(rt.ok)
        if interp == "bilinear":
            assert [int(s.iters) for s in rj.stats] == [int(s.iters) for s in rt.stats]
        Tj, Tt = np.asarray(rj.T), rt.T.numpy()
        np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], rtol=0, atol=POSE_ATOL[interp])
        np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], rtol=0, atol=POSE_ATOL[interp])
        T_true = np.linalg.inv(poses[k]) @ poses[0]
        assert np.linalg.norm(Tt[:3, 3] - T_true[:3, 3]) < 0.02


def test_normal_equations_points_sum_order():
    """The first place the two packages part: from the same system, the
    normal equations agree to float32 summation order, not bit for bit."""
    rng = np.random.default_rng(0)
    n = 4096
    r = rng.normal(0, 10, n).astype(np.float32)
    J = rng.normal(0, 100, (n, 6)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    ej = jp.normal_equations_points(jp.PointSystem(*map(jnp.asarray, (r, J, valid))),
                                    jnp.asarray(w))
    et = tp.normal_equations_points(tp.PointSystem(*map(torch.from_numpy, (r, J, valid))),
                                    torch.from_numpy(w))
    assert int(ej.num_valid) == int(et.num_valid)
    scale = np.abs(np.asarray(ej.JtWJ)).max()
    np.testing.assert_allclose(et.JtWJ.numpy(), np.asarray(ej.JtWJ), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(et.JtWr.numpy(), np.asarray(ej.JtWr), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(ej.JtWr)).max())
    np.testing.assert_allclose(float(et.err), float(ej.err), rtol=1e-5)


@pytest.mark.parametrize("level", [0, 1])
def test_mm_residuals_match_eager_reference(sequence, level):
    """Pins where the compiled reference leaves the port (ROADMAP C).

    From the same pose, the port's "mm" residuals and Jacobians equal the
    reference's op-by-op values bit for bit. The compiled reference differs
    on about a fifth of the lanes by up to ~0.4 grey level: XLA:CPU contracts
    the projection ``fx * X / Z + cx`` into fused multiply-adds, and a
    last-ulp change of u can flip the bf16 rounding of the x-weight.
    """
    poses, pyrs, kj, kt = sequence
    T1 = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    img = pyrs[1][level]
    gj = j_gradients(jnp.asarray(img))
    with jax.disable_jit():
        ref = jp.residual_jacobian_points(
            kj[level].pts, jnp.asarray(img), j_intrinsic_pyramid(CAM_J, LEVELS)[level],
            jnp.asarray(T1), kf_intensity=kj[level].intensity, interp="mm", grads=gj,
            chan=jnp.stack([jnp.asarray(img), *gj]))
    it = torch.from_numpy(np.array(img))
    gt = t_gradients(it)
    port = tp.residual_jacobian_points(
        kt[level].pts, it, t_intrinsic_pyramid(CAM_T, LEVELS)[level], torch.from_numpy(T1),
        kf_intensity=kt[level].intensity, interp="mm", grads=gt, chan=torch.stack([it, *gt]))
    assert int(port.valid.sum()) > 100
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
