"""The ring all-gather: the port's plain schedule against the reference's
Pallas kernel (interpret mode on the 8-device virtual CPU mesh of
tests/conftest.py), bit for bit.

The CPU path of ``ring_gather`` is the plain version: the same hops as the
CUDA kernel's, on a list of per-rank comm tensors, so these tests hold the
hop-origin bookkeeping itself. The kernel is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from odometry_tpu.distributed import ring_exchange as jr
from odometry_torch.distributed import ring_exchange as tr
from odometry_torch.distributed.mesh import Mesh, sequence_mesh


def _cpu_mesh(n: int, axis: str = "map") -> Mesh:
    return Mesh(sequence_mesh(n, device="cpu").devices, (axis,))


@pytest.fixture(scope="module")
def jmesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    return JMesh(np.array(devs[:8]), ("map",))


@pytest.mark.parametrize("shape", [(8 * 4, 128), (8 * 3, 4, 4)])
def test_ring_matches_reference_bitwise(jmesh8, shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jr.ring_all_gather(a, jmesh8))(jnp.asarray(x)))
    outs = tr.ring_all_gather(torch.from_numpy(x), _cpu_mesh(8))
    assert len(outs) == 8
    for o in outs:
        assert o.shape == ref.shape
        np.testing.assert_array_equal(o.numpy(), ref)


def test_gather_keyframe_poses_matches_reference(jmesh8):
    x = np.random.default_rng(4).standard_normal((8 * 3, 4, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jr.gather_keyframe_poses(a, jmesh8))(jnp.asarray(x)))
    shards = list(torch.from_numpy(x).split(3))
    for o in tr.gather_keyframe_poses(shards, _cpu_mesh(8)):
        np.testing.assert_array_equal(o.numpy(), ref)


@pytest.mark.parametrize("num", [1, 3])
def test_ring_small_meshes(num):
    # Every rank gets every shard at its origin's place (torch.cat).
    shards = [torch.from_numpy(np.random.default_rng(r).standard_normal((5, 4, 4))
                               .astype(np.float32)) for r in range(num)]
    outs = tr.ring_all_gather(shards, _cpu_mesh(num, "seq"), axis="seq")
    assert len(outs) == num
    for o in outs:
        assert torch.equal(o, torch.cat(shards))


def test_ring_plain_schedule_moves_every_chunk_by_hops():
    # Shards that name their origin: rank r's output slot k holds origin k.
    num = 5
    shards = [torch.full((2, 3), float(r)) for r in range(num)]
    for o in tr.ring_gather_plain(shards):
        np.testing.assert_array_equal(o[:, 0].numpy(), np.repeat(np.arange(num), 2))


def test_ring_rejects_indivisible_and_mismatched():
    with pytest.raises(ValueError, match="not divisible"):
        tr.ring_all_gather(torch.zeros((9, 128)), _cpu_mesh(8))
    with pytest.raises(ValueError, match="shards for"):
        tr.ring_all_gather([torch.zeros((1, 4))] * 3, _cpu_mesh(8))
    with pytest.raises(ValueError, match="differ"):
        tr.ring_gather([torch.zeros((1, 4)), torch.zeros((2, 4))])


def test_ring_gather_on_cpu_is_the_plain_version():
    before = tr.LAUNCHES
    shards = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(4)]
    outs = tr.ring_gather(shards)
    for o, p in zip(outs, tr.ring_gather_plain(shards)):
        assert torch.equal(o, p)
    assert tr.LAUNCHES == before  # the kernel runs only on the card
