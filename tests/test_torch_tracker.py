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
from odometry_tpu import config as jc
from odometry_tpu.image.pyramid import central_gradients as j_gradients
from odometry_tpu.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_tpu.kernels import points as jp
from odometry_tpu.tracking import tracker as jt
from odometry_torch.camera.pinhole import Pinhole as TPinhole
from odometry_torch import config as tc
from odometry_torch.camera.pinhole import intrinsic_pyramid as t_intrinsic_pyramid
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render
from odometry_torch.image.pyramid import central_gradients as t_gradients
from odometry_torch.kernels import points as tp
from odometry_torch.tracking import tracker as tt

# The 144x320 camera of tests/test_pipeline.py:288-295.
HS, WS = 144, 320
# Each package gets its own tracker configuration.
FAST_J, FAST_T = jc.fast_config().tracker, tc.fast_config().tracker
LEVELS = FAST_T.num_levels
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
                                                      indexing=FAST_J.depth_decimation))
    kj = jt.prepare_keyframe(tuple(map(jnp.asarray, pyrs[0])), tuple(map(jnp.asarray, dpyr)),
                             FAST_J)
    kt = tt.prepare_keyframe(_torch(pyrs[0]), _torch(dpyr), FAST_T)
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
    cfg_j = dataclasses.replace(FAST_J, interp=interp)
    cfg_t = dataclasses.replace(FAST_T, interp=interp)
    for k in range(1, len(poses)):
        # Start from the previous frame's true pose relative to the keyframe.
        T0 = (np.linalg.inv(poses[k - 1]) @ poses[0]).astype(np.float32)
        solve = lambda: jt.solve_pose_points(kj, tuple(map(jnp.asarray, pyrs[k])), CAM_J, cfg_j,
                                             jnp.asarray(T0))
        if interp == "bilinear":
            with jax.disable_jit():
                rj = solve()
        else:
            rj = solve()  # compiled, as the reference runs it
        rt = tt.solve_pose_points(kt, _torch(pyrs[k]), CAM_T, cfg_t, torch.from_numpy(T0))
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


# --------------------------------------------------------------------------- the LM iteration

from torch_tracker_inputs import TRACK_CFGS, leaves, solve, tracker_batch  # noqa: E402


def _loop_before_the_split(system, T_init, max_iters, cfg, step_tol=None):
    """The LM loop as it was written before its iteration became
    ``_lm_step``: `system(T)` closes over the level's tensors."""
    if step_tol is None:
        step_tol = cfg.step_tol
    dev = T_init.device
    B = T_init.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, **f32)
    inc = current = last = T_init
    err_last = torch.full((B,), 1e10, **f32)
    err_first = torch.zeros((B,), **f32)
    err_final = torch.zeros((B,), **f32)
    lam = torch.full((B,), cfg.lambda_init, **f32)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    it = 0
    going = True
    while going and it < max_iters:
        pose = lambda new, old: torch.where(active[:, None, None], new, old)
        eqs = system(inc)
        no_residuals = eqs.num_valid == 0
        err_now = eqs.err
        bad = err_now > err_last
        lam_up = lam * cfg.lambda_up
        lam_down = torch.clamp(lam / cfg.lambda_down, min=cfg.lambda_min)
        lam_n = torch.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current_n = torch.where(bad[:, None, None], last, inc)
        break_good = (~bad) & (err_now / err_last > cfg.precision)
        act = ~(break_bad | break_good | no_residuals)
        JtWJ = eqs.JtWJ
        A = JtWJ + lam_n[:, None, None] * torch.diag_embed(torch.diagonal(JtWJ, dim1=-2,
                                                                           dim2=-1))
        A = A + 1e-12 * eye6
        delta = tt.solve_spd6(A, -eqs.JtWr)
        delta = torch.where(torch.all(torch.isfinite(delta), dim=-1, keepdim=True), delta,
                            torch.zeros_like(delta))
        inc_n = tt._compose(tt._exp(delta), current_n)
        if step_tol > 0:
            act = act & (torch.amax(torch.abs(delta), dim=-1) >= step_tol)
        if it == 0:
            err_first = err_now
        current = last = pose(current_n, current)
        inc = pose(inc_n, inc)
        lam = torch.where(active, lam_n, lam)
        err_final = torch.where(active & ~bad, err_now, err_final)
        err_last = torch.where(active & ~bad, err_now, err_last)
        failed = failed | (active & no_residuals)
        iters = iters + active.to(torch.int32)
        active = active & act
        it += 1
        going = bool(active.any())
    return current, failed, tt.LevelStats(iters, err_first, err_final)


def _cached() -> int:
    """The graphs the tracker's cache holds, over every card."""
    return sum(len(cache) for cache in tt._GRAPHS.values())


# Every level of a 96x320 frame keeps pixels inside the border.
HS2, WS2 = 96, 320


@pytest.fixture(scope="module")
def small_batches():
    """Three lanes at 96x320 for each configuration of TRACK_CFGS."""
    return {name: tracker_batch(3, HS2, WS2, make(), "cpu", seed=2)
            for name, make in TRACK_CFGS.items()}


@pytest.mark.parametrize("name", list(TRACK_CFGS))
def test_lm_step_gives_the_loop_it_replaced(small_batches, monkeypatch, name):
    """On the CPU the loop over ``_lm_step`` gives the loop it was split
    from, bit for bit, and dispatches every iteration: LM_ITERS counts each,
    GRAPH_ITERS and GRAPH_CAPTURES none."""
    cfg = TRACK_CFGS[name]()
    batch = small_batches[name]
    before = (tt.LM_ITERS, tt.GRAPH_ITERS, tt.GRAPH_CAPTURES, _cached())
    got = solve(batch, cfg)
    assert bool(got.ok.all())
    assert tt.LM_ITERS - before[0] == sum(int(st.iters.max()) for st in got.stats) > 0
    assert (tt.GRAPH_ITERS, tt.GRAPH_CAPTURES, _cached()) == before[1:]
    monkeypatch.setattr(
        tt, "_lm_loop", lambda system, inputs, cam_l, T, max_iters, cfg_, tol=None:
        _loop_before_the_split(lambda T_: system(T_, inputs, cam_l, cfg_), T, max_iters, cfg_,
                               tol))
    want = solve(batch, cfg)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def test_lm_step_after_every_lane_stopped_changes_nothing(small_batches):
    cfg = TRACK_CFGS["mm"]()
    batch = small_batches["mm"]
    l = cfg.num_levels - 1
    img = batch["pyr_cur"][l]
    grads = t_gradients(img)
    inputs = (batch["kf_levels"][l], img, None, torch.stack([img, *grads], dim=-3))
    cam_l = t_intrinsic_pyramid(batch["cam"], cfg.num_levels)[l]
    step = lambda c: tt._lm_step(tt._points_system, inputs, cam_l, c, cfg, cfg.coarse_step_tol)
    carry = tt._lm_start(batch["T0"], cfg)
    for _ in range(cfg.max_iterations[l]):
        carry = step(carry)
    assert not bool(carry.active.any())
    for a, b in zip(step(carry), carry):
        assert torch.equal(a, b)


def test_lm_graph_gate():
    """Only a card's iterations replay a graph, and not the t-distribution's,
    whatever the preset (a stand-in pose says "on a card")."""
    card_pose = type("CardPose", (), {"is_cuda": True})()
    for name, make in TRACK_CFGS.items():
        cfg = make()
        assert not tt._graphed(torch.eye(4)[None], cfg)
        assert tt._graphed(card_pose, cfg) == (name != "tdist")


def _key_inputs(B=3, cap=64, H=12, W=40, chan=False, value=0.0):
    f = lambda *s: torch.full(s, value)
    pts = tp.PointSet(f(B, cap), f(B, cap), f(B, cap), torch.ones(B, cap, dtype=torch.bool),
                      torch.full((B,), cap, dtype=torch.int32))
    img = f(B, H, W)
    return (tt.KeyframeLevel(pts, f(B, cap)), img, (img, img), f(B, 3, H, W) if chan else None)


def test_lm_graph_key():
    """The key of a level solve's graph changes with the batch size, the point
    capacity, the level's shape, the sampler and the intrinsics, and not with
    the values of the tensors."""
    cfg = TRACK_CFGS["floor"]()
    cam = TPinhole.create(90.0, 90.0, 20.0, 6.0)
    T = lambda B=3: torch.eye(4).expand(B, 4, 4)
    key = lambda inputs, T_=None, cfg_=cfg, cam_=cam: tt._graph_key(
        tt._points_system, inputs, cam_, T() if T_ is None else T_, cfg_, 0.0)
    base = key(_key_inputs())
    assert key(_key_inputs(value=1.0)) == base
    variants = [key(_key_inputs(B=2), T(2)), key(_key_inputs(cap=32)),
                key(_key_inputs(H=24, W=80)),
                key(_key_inputs(chan=True), cfg_=dataclasses.replace(cfg, interp="mm")),
                key(_key_inputs(), cfg_=dataclasses.replace(cfg, interp="bilinear")),
                key(_key_inputs(), cam_=TPinhole.create(91.0, 90.0, 20.0, 6.0)),
                tt._graph_key(tt._dense_system, _key_inputs(), cam, T(), cfg, 0.0),
                tt._graph_key(tt._points_system, _key_inputs(), cam, T(), cfg, 1e-5)]
    assert len({base, *variants}) == 1 + len(variants)


class _StandInGraph:
    """A graph that records its capture (by step_tol) and its loads."""

    made, loads = [], []

    def __init__(self, system, inputs, cam_l, T_init, cfg, step_tol):
        self.made.append((T_init.device, step_tol))

    def load(self, inputs, T_init, cfg):
        self.loads.append(self)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """An empty cache of stand-in graphs, and `get(tol, card)`: the cached
    graph of a level solve keyed by `tol` on card `card` (a stand-in pose
    carries the card)."""
    monkeypatch.setattr(tt, "_LMGraph", _StandInGraph)
    monkeypatch.setattr(tt, "_GRAPHS", {})
    monkeypatch.setattr(_StandInGraph, "made", [])
    monkeypatch.setattr(_StandInGraph, "loads", [])
    cfg, inputs = TRACK_CFGS["floor"](), _key_inputs()

    def get(tol, card=0):
        pose = type("CardPose", (), {"device": torch.device("cuda", card)})()
        return tt._lm_graph(tt._points_system, inputs, CAM_T, pose, cfg, tol)

    return get, _StandInGraph


def test_lm_graph_cache_is_bounded(stand_in_graphs):
    """The cache keeps a card's GRAPH_CACHE_SIZE most recently used graphs
    and loads the solve's inputs into the one it returns: a hit keeps its
    graph, a miss past the size drops the least recently used."""
    get, graph = stand_in_graphs
    made = lambda: [tol for _, tol in graph.made]
    n = tt.GRAPH_CACHE_SIZE
    first = get(0.0)
    for k in range(1, n):
        get(float(k))
    assert get(0.0) is first and len(made()) == n
    assert len(graph.loads) == n + 1 and graph.loads[-1] is first
    get(float(n))
    assert _cached() == n and made() == [float(k) for k in range(n + 1)]
    assert get(0.0) is first and len(made()) == n + 1
    get(1.0)
    assert len(made()) == n + 2 and _cached() == n


@pytest.mark.parametrize("cards", [1, 4])
def test_lm_graph_cache_keeps_every_cards_levels(stand_in_graphs, monkeypatch, cards):
    """A mesh steps its cards in turn, each through every level: the levels
    of each card stay cached, so after the first step no solve captures
    again, even where a card's cache holds just one card's levels."""
    get, graph = stand_in_graphs
    levels = TRACK_CFGS["mm"]().num_levels
    monkeypatch.setattr(tt, "GRAPH_CACHE_SIZE", levels)
    keys = [(float(l), k) for k in range(cards) for l in range(levels)]
    firsts = [get(*key) for key in keys]
    for _ in range(3):
        assert [get(*key) for key in keys] == firsts
    assert sorted(graph.made, key=str) == sorted(
        ((torch.device("cuda", k), tol) for tol, k in keys), key=str)
    assert _cached() == cards * levels and len(tt._GRAPHS) == cards
