"""The pose graph: the port against the reference.

Graphs are made with numpy from a seed and handed to both packages: the
drifting chain with one loop edge of tests/test_mapping.py:78-122, a
consistent chain, and a K-padded graph shaped as ``close_loop`` builds it
(identity nodes past the occupied ones, zero-weight padding edges, the loop
edge in slot K - 1).

Tolerances. Both solve the same damped 6N x 6N system in float32, the
reference through XLA's solve, the port through LAPACK (``solve_ex``) on
the CPU. With the gauge prior of 1e9 on node 0 beside unit weights the
system is ill-conditioned for float32: on these graphs each float32 solve
ends up to 1.7e-4 from the same solve in float64 (the reference 4.7e-5 and
1.7e-4, the port 1.2e-4 and 1.7e-4), and the two float32 runs 1.1e-4 apart
after 15 iterations. Edges that share a node are also summed in another
order (one-hot products against XLA's scatter-add; on the card the
products' order is cuBLAS's). So poses are held to 3e-4 and costs to 1e-3
relative plus 1e-7 absolute (a cost near 0 is rounding).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.geometry import se3_exp as j_se3_exp
from odometry_tpu.mapping import pose_graph as jpg
from odometry_torch.mapping import pose_graph as tpg

POSE_ATOL = 3e-4
COST_RTOL, COST_ATOL = 1e-3, 1e-7


def _exp(xi) -> np.ndarray:
    return np.asarray(j_se3_exp(jnp.asarray(xi, jnp.float32)))


def _drifting_chain(N=8):
    """tests/test_mapping.py:78-97: unit steps along x, odometry corrupted by
    a constant bias; returns (ground truth, drifted chain)."""
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(N - 1):
        gt.append(gt[-1] @ _exp([1.0, 0, 0, 0, 0, 0]))
    gt = np.stack(gt)
    noise = _exp([0.05, 0.02, 0, 0, 0.004, 0])
    noisy = [gt[0]]
    for k in range(N - 1):
        noisy.append(noisy[-1] @ (np.linalg.inv(gt[k]) @ gt[k + 1]) @ noise)
    return gt, np.stack(noisy).astype(np.float32)


def _loop_graph():
    """The drifting chain's odometry edges plus a perfect loop edge 0 -> N-1
    of weight 20 (tests/test_mapping.py:99-109), as numpy arrays."""
    gt, noisy = _drifting_chain()
    N = len(gt)
    i, j, Z, w = (np.asarray(a) for a in jpg.odometry_edges(jnp.asarray(noisy)))
    i = np.concatenate([i, [0]]).astype(np.int32)
    j = np.concatenate([j, [N - 1]]).astype(np.int32)
    Z = np.concatenate([Z, (np.linalg.inv(gt[0]) @ gt[-1])[None]]).astype(np.float32)
    w = np.concatenate([w, [20.0]]).astype(np.float32)
    return gt, (noisy, i, j, Z, w)


def _padded_graph(K=12, n=7, seed=5):
    """A graph as close_loop builds it: n occupied nodes of a random walk,
    K - n identity nodes, odometry edges 0..n-2, zero-weight padding edges
    (0, 0) and the loop edge (1, n-1) in slot K - 1, measuring a slightly
    wrong relative pose (the drift to spread)."""
    rng = np.random.default_rng(seed)
    P = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(1, n):
        xi = np.concatenate([[0.1, 0.02, 0.5] + 0.05 * rng.standard_normal(3),
                             0.01 * rng.standard_normal(3)])
        P[k] = P[k - 1] @ _exp(xi)
    ei = np.zeros(K, np.int32)
    ej = np.zeros(K, np.int32)
    Z = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    w = np.zeros(K, np.float32)
    ei[: n - 1] = np.arange(n - 1)
    ej[: n - 1] = np.arange(1, n)
    Z[: n - 1] = np.linalg.inv(P[: n - 1]) @ P[1:n]
    w[: n - 1] = 1.0
    ei[K - 1], ej[K - 1] = 1, n - 1
    Z[K - 1] = (np.linalg.inv(P[1]) @ P[n - 1]) @ _exp([0.08, -0.03, 0.1, 0.004, 0.01, -0.006])
    w[K - 1] = 1.0
    return P, ei, ej, Z, w


def _graphs(arrays):
    jg = jpg.PoseGraph(*(jnp.asarray(a) for a in arrays))
    tg = tpg.PoseGraph(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    return jg, tg


def test_odometry_edges_match_reference():
    _, noisy = _drifting_chain()
    got = tpg.odometry_edges(torch.from_numpy(noisy), weight=0.5)
    want = jpg.odometry_edges(jnp.asarray(noisy), weight=0.5)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("which", ["loop", "padded"])
def test_pose_graph_cost_matches_reference(which):
    arrays = _loop_graph()[1] if which == "loop" else _padded_graph()
    jg, tg = _graphs(arrays)
    c_t, c_j = float(tpg.pose_graph_cost(tg)), float(jpg.pose_graph_cost(jg))
    assert c_j > 1e-3  # both graphs carry a real inconsistency
    np.testing.assert_allclose(c_t, c_j, rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("which,iters", [("loop", 15), ("padded", 10)])
def test_optimize_pose_graph_matches_reference(which, iters):
    arrays = _loop_graph()[1] if which == "loop" else _padded_graph()
    jg, tg = _graphs(arrays)
    rj = jpg.optimize_pose_graph(jg, iters=iters)
    rt = tpg.optimize_pose_graph(tg, iters=iters)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), rtol=0, atol=POSE_ATOL)
    for a, b in ((rt.cost_initial, rj.cost_initial), (rt.cost_final, rj.cost_final)):
        np.testing.assert_allclose(float(a), float(b), rtol=COST_RTOL, atol=COST_ATOL)
    assert float(rt.cost_final) < float(rt.cost_initial)
    if which == "padded":
        # Padding nodes hang on no weighted edge: they do not move.
        n = int((arrays[4] > 0).sum())
        np.testing.assert_array_equal(rt.poses[n:].numpy(), arrays[0][n:])


def test_loop_edge_spreads_the_drift_as_the_reference():
    """tests/test_mapping.py:78-122's claim, on the port: the loop edge pulls
    the chain's end within 0.3 of its drift."""
    gt, arrays = _loop_graph()
    res = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.from_numpy(a) for a in arrays)),
                                  iters=15)
    drift0 = np.linalg.norm(arrays[0][-1][:3, 3] - gt[-1][:3, 3])
    drift1 = np.linalg.norm(res.poses[-1, :3, 3].numpy() - gt[-1][:3, 3])
    assert drift0 > 0.1 and drift1 < 0.3 * drift0, (drift0, drift1)


def test_consistent_graph_stays_put():
    poses = np.stack([_exp([k * 1.0, 0, 0, 0, 0, 0]) for k in range(5)])
    P = torch.from_numpy(poses)
    res = tpg.optimize_pose_graph(tpg.PoseGraph(P, *tpg.odometry_edges(P)), iters=3)
    assert float(res.cost_final) < 1e-8
    np.testing.assert_allclose(res.poses.numpy(), poses, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="iters"):
        tpg.optimize_pose_graph(tpg.PoseGraph(P, *tpg.odometry_edges(P)), iters=0)
