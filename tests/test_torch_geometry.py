"""SE(3)/SO(3) and pinhole: port vs reference on the same float32 inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu import geometry as jg
from odometry_tpu.camera import pinhole as jp
from odometry_torch import geometry as tg
from odometry_torch.camera import pinhole as tp

# float32 transcendental functions differ by an ulp or two between XLA's
# and PyTorch's CPU implementations; entries are O(1).
ATOL = 1e-5


def _twists(kind):
    rng = np.random.default_rng({"random": 0, "small": 1, "tiny": 2}[kind])
    xi = rng.normal(size=(16, 6)).astype(np.float32)
    if kind == "small":
        xi[:, 3:] *= 1e-3
    elif kind == "tiny":
        xi[:, 3:] *= 1e-7
    return xi


def _close(a_jax, b_torch, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a_jax), b_torch.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("kind", ["random", "small", "tiny"])
def test_exp_log_match(kind):
    xi = _twists(kind)
    _close(jg.se3_exp(jnp.asarray(xi)), tg.se3_exp(torch.from_numpy(xi)))
    _close(jg.so3_exp(jnp.asarray(xi[:, 3:])), tg.so3_exp(torch.from_numpy(xi[:, 3:])))
    T = np.array(jg.se3_exp(jnp.asarray(xi)))
    _close(jg.se3_log(jnp.asarray(T)), tg.se3_log(torch.from_numpy(T)))
    _close(jg.so3_log(jnp.asarray(T[:, :3, :3])), tg.so3_log(torch.from_numpy(T[:, :3, :3])))


def test_so3_log_near_pi():
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = (axis * (np.pi - 1e-4)).astype(np.float32)
    R = np.array(jg.so3_exp(jnp.asarray(w)))
    _close(jg.so3_log(jnp.asarray(R)), tg.so3_log(torch.from_numpy(R)), atol=1e-3)


@pytest.mark.parametrize("kind", ["random", "small"])
def test_compose_inverse_angles(kind):
    xi = _twists(kind)
    T = np.array(jg.se3_exp(jnp.asarray(xi)))
    A, B = T[:8], T[8:]
    _close(jg.se3_compose(jnp.asarray(A), jnp.asarray(B)),
           tg.se3_compose(torch.from_numpy(A), torch.from_numpy(B)))
    _close(jg.se3_inverse(jnp.asarray(T)), tg.se3_inverse(torch.from_numpy(T)))
    _close(jg.rotation_angles_xyz(jnp.asarray(T[:, :3, :3])),
           tg.rotation_angles_xyz(torch.from_numpy(T[:, :3, :3])))
    _close(jg.hat(jnp.asarray(xi[:, :3])), tg.hat(torch.from_numpy(xi[:, :3])))
    assert torch.equal(tg.vee(tg.hat(torch.from_numpy(xi[:, :3]))), torch.from_numpy(xi[:, :3]))
    assert torch.equal(tg.se3_identity((2,)), torch.eye(4).expand(2, 4, 4))


def test_pinhole_levels_and_projection():
    jcam = jp.Pinhole.create(718.856, 718.856, 607.1928, 185.2157)
    tcam = tp.Pinhole.create(718.856, 718.856, 607.1928, 185.2157)
    for jl, tl in zip(jp.intrinsic_pyramid(jcam, 4), tp.intrinsic_pyramid(tcam, 4)):
        # Same float32 recursion: the per-level intrinsics are bit-identical.
        assert [float(jl.fx), float(jl.fy), float(jl.cx), float(jl.cy)] == \
            [tl.fx, tl.fy, tl.cx, tl.cy]
    rng = np.random.default_rng(4)
    x, y = rng.uniform(0, 1241, 64).astype(np.float32), rng.uniform(0, 376, 64).astype(np.float32)
    z = rng.uniform(0.5, 30, 64).astype(np.float32)
    J = jp.backproject(jcam, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    Tt = tp.backproject(tcam, *(torch.from_numpy(a) for a in (x, y, z)))
    for a, b in zip(J, Tt):
        _close(a, b, atol=1e-4)
    _close(jp.project(jcam, *J)[0], tp.project(tcam, *Tt)[0], atol=1e-3)


@pytest.mark.parametrize("kind", ["random", "small"])
def test_adjoint_and_transform_points_match(kind):
    xi = _twists(kind)
    T = np.array(jg.se3_exp(jnp.asarray(xi)))
    _close(jg.se3_adjoint(jnp.asarray(T)), tg.se3_adjoint(torch.from_numpy(T)))
    pts = np.random.default_rng(3).normal(0, 5, (16, 40, 3)).astype(np.float32)
    # A 3-term float32 dot product per coordinate, values up to ~20.
    _close(jg.transform_points(jnp.asarray(T), jnp.asarray(pts)),
           tg.transform_points(torch.from_numpy(T), torch.from_numpy(pts)), atol=2e-5)


def test_warp_points_match():
    rng = np.random.default_rng(4)
    H, W = 48, 96
    cam_j, cam_t = jp.Pinhole.create(70.0, 70.0, 48.0, 24.0), tp.Pinhole.create(70.0, 70.0,
                                                                                 48.0, 24.0)
    xs = rng.uniform(0, W, 500).astype(np.float32)
    ys = rng.uniform(0, H, 500).astype(np.float32)
    z = rng.uniform(-1.0, 20.0, 500).astype(np.float32)
    T = np.array(jg.se3_exp(jnp.asarray(_twists("small")[0] * 0.3)))
    Pj = jp.backproject(cam_j, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(z))
    Pt = tp.backproject(cam_t, *(torch.from_numpy(a) for a in (xs, ys, z)))
    uj, vj, zj, okj = jp.warp_points(cam_j, jnp.asarray(T), *Pj, H, W)
    ut, vt, zt, okt = tp.warp_points(cam_t, torch.from_numpy(T), *Pt, H, W)
    # Projections of float32 points, pixel coordinates up to ~1e3.
    _close(uj, ut, atol=1e-3)
    _close(vj, vt, atol=1e-3)
    _close(zj, zt)
    assert 0 < int(okt.sum()) < 500
    # Validity may differ only where u or v sits within rounding of an edge.
    edge = np.minimum.reduce([np.abs(np.asarray(uj)), np.abs(np.asarray(uj) - W),
                              np.abs(np.asarray(vj)), np.abs(np.asarray(vj) - H)])
    differ = np.asarray(okj) != okt.numpy()
    assert (edge[differ] < 1e-3).all()
