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
