"""The distributed layer: the port's mesh, sweep, sharded BA, multi-process
init and state interop against the reference on the 8-device virtual CPU
mesh of tests/conftest.py; the port's ranks are CPU ranks here.

Also the device defaults of the port's entry points: the card unless the
caller asks for the CPU, and no fallback when there is none.

Run as ``python tests/test_torch_distributed.py <rank> <port> <healthy>``
this file is the worker of the slow two-process test (see ``__main__``).
"""

import dataclasses
import inspect
import sys

import numpy as np
import pytest
import torch


def _configs(C, H=64, W=96):
    """tests/test_distributed.py's 64x96 configuration from config module `C`."""
    return C.PipelineConfig(
        camera=C.CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=C.TrackerConfig(num_levels=2, max_iterations=(6, 6), interp="bilinear",
                                depth_decimation="even"),
        depth=C.DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=6,
                            interp="bilinear"),
        keyframe=C.KeyframeConfig(),
    )


if __name__ == "__main__":
    # Worker of test_two_process_sweep_health: one CPU rank per process on the
    # global mesh, one sequence each, health reduced over a gloo group.
    # Imports no JAX.
    from odometry_torch import config as tc
    from odometry_torch.camera.pinhole import Pinhole
    from odometry_torch.data.synthetic import make_scene, render_stereo
    from odometry_torch.distributed import sweep
    from odometry_torch.distributed.mesh import sequence_mesh
    from odometry_torch.distributed.scaling import (
        initialize_multihost,
        shutdown_multihost,
        stack_local_frames,
    )

    rank, port, healthy = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
    assert initialize_multihost(f"localhost:{port}", 2, rank, device="cpu")
    cfg = _configs(tc)
    c = cfg.camera
    scene = make_scene(rank, depth=14.0, device="cpu")
    left, right, _ = render_stereo(scene, Pinhole.create(c.fx, c.fy, c.cx, c.cy), c.baseline,
                                   torch.eye(4), c.height, c.width)
    mesh = sequence_mesh(device="cpu")  # the global mesh: one rank per process
    assert mesh.shape == {"seq": 2} and mesh.local_ranks() == [rank]
    lefts, rights = stack_local_frames([(left, right)], mesh)
    states = sweep.batched_init(lefts, rights, cfg, mesh)
    if not healthy:  # a flat frame: no depth survivors, depth_ok False
        lefts, rights = [torch.zeros_like(lefts[0])], [torch.zeros_like(rights[0])]
    _, outs, global_ok = sweep.batched_step(states, lefts, rights, cfg, mesh)
    print(f"WORKER rank={rank} local_ok={bool(outs[0].depth_ok)} global_ok={bool(global_ok)}",
          flush=True)
    shutdown_multihost()
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from odometry_tpu import config as jc  # noqa: E402
from odometry_tpu.camera import Pinhole as JPinhole  # noqa: E402
from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render_stereo  # noqa: E402
from odometry_tpu.distributed import ba_dist as jbd  # noqa: E402
from odometry_tpu.distributed import sweep as jsw  # noqa: E402
from odometry_tpu.mapping.ba import BAConfig as JBAConfig  # noqa: E402
from odometry_torch import config as tc  # noqa: E402
from odometry_torch import interop  # noqa: E402
from odometry_torch.camera.pinhole import Pinhole  # noqa: E402
from odometry_torch.distributed import ba_dist as tbd  # noqa: E402
from odometry_torch.distributed import sweep as tsw  # noqa: E402
from odometry_torch.distributed.mesh import Mesh, grid_mesh, sequence_mesh  # noqa: E402
from odometry_torch.distributed.scaling import (  # noqa: E402
    initialize_multihost,
    stack_local_frames,
)
from odometry_torch.mapping import ba as tba  # noqa: E402
from odometry_torch.mapping.keyframe import create_store  # noqa: E402
from odometry_torch.pipeline.odometry import init  # noqa: E402
from odometry_torch.pipeline.runner import run_sequence  # noqa: E402
from odometry_torch.pipeline.slam import run_slam  # noqa: E402
from test_ba import CAM as JCAM, K, _make_problem  # noqa: E402

NUM_SEQS, NUM_FRAMES = 4, 3
CFG_J, CFG_T = _configs(jc), _configs(tc)
# C1's tolerance for poses of two float32 trackers (tests/test_torch_tracker.py).
POSE_ATOL = 5e-4


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


def _frame_stack(sequences, i, k):
    return np.stack([seq[i][k] for seq in sequences])


@pytest.fixture(scope="module")
def reference_sweep(sequences):
    """The reference's batched init and steps on a 4-device seq mesh: the
    initial batched state (numpy leaves) and per step (poses, depth_ok,
    global_ok)."""
    mesh = JMesh(np.array(jax.devices()[:NUM_SEQS]), ("seq",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("seq")))
    states = jsw.batched_init(put(_frame_stack(sequences, 0, 0)),
                              put(_frame_stack(sequences, 0, 1)), CFG_J, mesh)
    init_tree = jax.tree_util.tree_map(np.asarray, states)
    steps = []
    for i in range(1, NUM_FRAMES):
        states, outs, ok = jsw.batched_step(states, put(_frame_stack(sequences, i, 0)),
                                            put(_frame_stack(sequences, i, 1)), CFG_J, mesh)
        steps.append((np.asarray(outs.cur_pose), np.asarray(outs.depth_ok), bool(ok)))
    return init_tree, steps


def _leaves(state) -> list:
    """The leaves of an OdometryState (tensors or numpy), nested tuples
    flattened in field order."""
    out = []

    def collect(v):
        if isinstance(v, tuple):
            for u in v:
                collect(u)
        else:
            out.append(v)

    for f in dataclasses.fields(state):
        collect(getattr(state, f.name))
    return out


def test_sweep_matches_reference(sequences, reference_sweep):
    _, ref_steps = reference_sweep
    mesh = sequence_mesh(NUM_SEQS, device="cpu")
    states = tsw.batched_init(_frame_stack(sequences, 0, 0), _frame_stack(sequences, 0, 1),
                              CFG_T, mesh)
    for i, (ref_pose, ref_ok, ref_global) in enumerate(ref_steps, start=1):
        states, outs, global_ok = tsw.batched_step(states, _frame_stack(sequences, i, 0),
                                                   _frame_stack(sequences, i, 1), CFG_T, mesh)
        pose = torch.cat([o.cur_pose for o in outs]).numpy()
        np.testing.assert_allclose(pose, ref_pose, rtol=0, atol=POSE_ATOL)
        np.testing.assert_array_equal(torch.cat([o.depth_ok for o in outs]).numpy(), ref_ok)
        assert bool(global_ok) == ref_global
        assert global_ok.dtype == torch.bool and global_ok.dim() == 0
    # One batched state per rank, every tensor on its rank's device.
    assert len(states) == NUM_SEQS
    for state, dev in zip(states, mesh.axis_devices("seq")):
        assert all(t.device == dev and t.shape[0] == 1 for t in _leaves(state))


def test_sweep_health_counts_every_sequence(sequences):
    """One sequence whose step frame is flat (no depth survivors) makes
    global_ok False; two sequences per rank on a 2-rank mesh, each rank's
    two stepped as one batch."""
    mesh = sequence_mesh(2, device="cpu")
    states = tsw.batched_init(_frame_stack(sequences, 0, 0), _frame_stack(sequences, 0, 1),
                              CFG_T, mesh)
    lefts, rights = _frame_stack(sequences, 1, 0), _frame_stack(sequences, 1, 1)
    _, outs, ok = tsw.batched_step(states, lefts, rights, CFG_T, mesh)
    assert [o.depth_ok.shape for o in outs] == [(2,), (2,)]
    assert bool(ok) and all(bool(o.depth_ok.all()) for o in outs)
    lefts[3] = rights[3] = 0.0
    _, outs, ok = tsw.batched_step(states, lefts, rights, CFG_T, mesh)
    assert torch.cat([o.depth_ok for o in outs]).tolist() == [True, True, True, False]
    assert not bool(ok)
    with pytest.raises(ValueError, match="not divisible"):
        tsw.batched_init(lefts[:3], rights[:3], CFG_T, mesh)


def test_run_sweep_equals_run_sequence(sequences):
    """A sequence stepped inside run_sweep, one per rank in turn, equals
    run_sequence on it alone, bit for bit (the same ops on the same device)."""
    calls = []
    poses = tsw.run_sweep(sequences, CFG_T, sequence_mesh(NUM_SEQS, device="cpu"),
                          progress=lambda i, states, outs, ok: calls.append((i, bool(ok))))
    assert poses.shape == (NUM_SEQS, NUM_FRAMES, 4, 4) and poses.dtype == np.float32
    assert calls == [(i, True) for i in range(NUM_FRAMES)]
    for s, frames in enumerate(sequences):
        np.testing.assert_array_equal(poses[s], run_sequence(frames, CFG_T, device="cpu").poses)


def test_batched_state_interop(sequences, reference_sweep):
    """The reference's batched state carried to one batched port state per
    rank: it round-trips, and one port step from it follows the reference's
    step."""
    init_tree, ref_steps = reference_sweep
    mesh = sequence_mesh(2, device="cpu")
    states = interop.states_from_batched_numpy(init_tree, mesh)
    assert len(states) == 2 and all(int(s.frame_id.shape[0]) == 2 for s in states)
    back = interop.states_to_batched_numpy(states)
    for a, b in zip(jax.tree_util.tree_leaves(init_tree), _leaves(back)):
        np.testing.assert_array_equal(a, b)
    _, outs, ok = tsw.batched_step(states, _frame_stack(sequences, 1, 0),
                                   _frame_stack(sequences, 1, 1), CFG_T, mesh)
    np.testing.assert_allclose(torch.cat([o.cur_pose for o in outs]).numpy(), ref_steps[0][0],
                               rtol=0, atol=POSE_ATOL)
    assert bool(ok) == ref_steps[0][2]


def test_mesh_layout():
    m = grid_mesh(2, 3, device="cpu")
    assert m.shape == {"seq": 2, "model": 3} and m.size == 6
    assert m.axis_devices("model") == [torch.device("cpu")] * 3
    devs = [torch.device("cpu")] * 4
    assert sequence_mesh(device=devs).shape == {"seq": 4}
    with pytest.raises(ValueError):
        sequence_mesh(5, device=devs)
    with pytest.raises(ValueError):
        Mesh(np.empty((2, 2), dtype=object), ("seq",))


def test_stack_local_frames_places_each_sequence(sequences):
    mesh = sequence_mesh(NUM_SEQS, device="cpu")
    lefts, rights = stack_local_frames([seq[0] for seq in sequences], mesh)
    for s, (left, right) in enumerate(zip(lefts, rights)):
        assert left.device == mesh.devices[s] and left.dtype == torch.float32
        np.testing.assert_array_equal(left.numpy(), sequences[s][0][0])
        np.testing.assert_array_equal(right.numpy(), sequences[s][0][1])


def test_initialize_multihost_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(num_processes=2)


# ---------------------------------------------------------------- sharded BA


@pytest.fixture(scope="module")
def ba_problem():
    jp, _, _ = _make_problem(pose_noise=0.02)
    return jp, interop.ba_problem_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("fix_depths", [False, True])
def test_sharded_ba_matches_single_and_reference(ba_problem, fix_depths):
    """Poses within 2e-4 and inverse depths within 1e-4
    (tests/test_distributed.py:81-87) of the port's ba_solve and of the
    reference's ba_solve_sharded on 4 devices; equal residual counts."""
    jp, tp = ba_problem
    cam = Pinhole.create(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy)
    cfg_t = tba.BAConfig(window=K, iters=3, fix_depths=fix_depths)
    cfg_j = JBAConfig(window=K, iters=3, fix_depths=fix_depths)
    sharded = tbd.ba_solve_sharded(tp, cam, grid_mesh(1, 4, device="cpu"), cfg_t)
    single = tba.ba_solve(tp, cam, cfg_t)
    ref = jbd.ba_solve_sharded(jp, JCAM, JMesh(np.array(jax.devices()[:4]), ("model",)), cfg_j)
    assert sharded.inv_depth.shape == tp.inv_depth.shape
    for other in (single, ref):
        np.testing.assert_allclose(sharded.pose.numpy(), np.asarray(other.pose), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(sharded.inv_depth.numpy(), np.asarray(other.inv_depth),
                                   rtol=0, atol=1e-4)
        assert int(sharded.num_residuals) == int(other.num_residuals)
        np.testing.assert_allclose(float(sharded.cost_final), float(other.cost_final), rtol=1e-4)
    assert float(sharded.cost_final) <= float(sharded.cost_initial)


def test_sharded_ba_rejects_indivisible_lanes(ba_problem):
    _, tp = ba_problem
    cam = Pinhole.create(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy)
    with pytest.raises(ValueError, match="not divisible"):
        tbd.ba_solve_sharded(tp, cam, grid_mesh(1, 3, device="cpu"), tba.BAConfig(window=K))


# ---------------------------------------------------------------- devices


ENTRY_POINTS = [
    ("odometry_torch.pipeline.odometry", "init"),
    ("odometry_torch.pipeline.runner", "run_sequence"),
    ("odometry_torch.distributed.mesh", "sequence_mesh"),
    ("odometry_torch.distributed.mesh", "grid_mesh"),
    ("odometry_torch.distributed.sweep", "run_sweep"),
    ("odometry_torch.mapping.keyframe", "create_store"),
    ("odometry_torch.pipeline.slam", "run_slam"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(module, name):
    import importlib

    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card(sequences, monkeypatch):
    """With no card, each default raises; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right = sequences[0][0]
    calls = [
        lambda: init(left, right, CFG_T),
        lambda: run_sequence(sequences[0], CFG_T),
        lambda: sequence_mesh(2),
        lambda: sequence_mesh(),
        lambda: grid_mesh(1, 2),
        lambda: tsw.run_sweep(sequences[:1], CFG_T),
        lambda: create_store(2, 8),
        lambda: run_slam(sequences[0], CFG_T),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------- processes


@pytest.mark.slow
def test_two_process_sweep_health():
    """Two OS processes, one CPU rank each, join a gloo group through
    initialize_multihost and take one batched_step: global_ok is the
    all_reduce of both processes' health. Rank 1 steps a flat frame (depth
    fails), so both must report global_ok False while rank 0's own depth is
    healthy; as tests/test_distributed.py:163-205 for the reference."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(port),
                               "1" if rank == 0 else "0"],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    assert "WORKER rank=0 local_ok=True global_ok=False" in outs[0], outs[0]
    assert "WORKER rank=1 local_ok=False global_ok=False" in outs[1], outs[1]


@pytest.mark.slow
def test_free_depth_window_parts_single_and_sharded_in_both(capsys):
    """ROADMAP C9. A BA window of real keyframes (fast_config at 144x320, a
    25-frame drive, three keyframes) holds lanes whose depth Hessian is
    near zero. With free depths their steps bd / Hdd are decided by float32
    rounding, so a solve whose sums run in another order (the sharded one)
    parts from the single solve, in the reference as in the port; motion-only
    (run_slam's mode) the two agree within 2e-4 / 1e-4 in both packages.
    Prints each package's gaps."""
    from odometry_torch.data.synthetic import drive_trajectory as t_drive, make_scene as t_scene
    from odometry_torch.data.synthetic import render_stereo as t_render
    from odometry_torch.mapping.keyframe import insert_keyframe, window_slots
    from odometry_torch.pipeline.odometry import step

    cfg = dataclasses.replace(tc.fast_config(), camera=tc.CameraConfig(
        fx=180.0, fy=180.0, cx=160.0, cy=72.0, baseline=0.537, height=144, width=320))
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = t_scene(3, depth=14.0, device="cpu")
    frames = [t_render(scene, cam, c.baseline, T, c.height, c.width)[:2]
              for T in t_drive(25, step=0.35, seed=4)]
    state, _ = init(*frames[0], cfg, device="cpu")

    def insert(store, state, i):
        kf = state.kf_track[0]
        return insert_keyframe(store, kf.pts, kf.intensity, state.kf_pose, i,
                               image=state.kf_pyr[0])

    store = insert(create_store(8, cfg.tracker.point_capacity, c.height, c.width,
                                device="cpu"), state, 0)
    for i, (left, right) in enumerate(frames[1:], start=1):
        state, out = step(state, left, right, cfg)
        if bool(out.promoted):
            store = insert(store, state, i)
    W = int(store.count)
    assert W >= 3
    sl = window_slots(store, W)
    tp = tba.BAProblem(images=store.image[sl], xs=store.xs[sl], ys=store.ys[sl],
                       inv_depth=store.inv_depth[sl], intensity=store.intensity[sl],
                       point_valid=store.point_valid[sl], pose=store.pose[sl],
                       kf_valid=store.occupied[sl])
    from odometry_tpu.mapping.ba import BAProblem as JBAProblem, ba_solve as j_ba_solve

    jp = JBAProblem(*(jnp.asarray(a.numpy()) for a in tp))
    jcam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("model",))
    gaps = {}
    for fix in (True, False):
        cfg_t, cfg_j = tba.BAConfig(iters=4, fix_depths=fix, window=W), JBAConfig(
            iters=4, fix_depths=fix, window=W)
        pairs = {
            "port": (tba.ba_solve(tp, cam, cfg_t),
                     tbd.ba_solve_sharded(tp, cam, grid_mesh(1, 8, device="cpu"), cfg_t)),
            "reference": (j_ba_solve(jp, jcam, cfg_j),
                          jbd.ba_solve_sharded(jp, jcam, jmesh, cfg_j)),
        }
        for name, (single, sharded) in pairs.items():
            dpose = np.abs(np.asarray(sharded.pose) - np.asarray(single.pose)).max()
            dinv = np.abs(np.asarray(sharded.inv_depth) - np.asarray(single.inv_depth))
            gaps[name, fix] = (dpose, dinv.max(), int((dinv > 1e-4).sum()))
    with capsys.disabled():
        for (name, fix), (dpose, dinv, lanes) in gaps.items():
            print(f"\n{name} fix_depths={fix}: sharded vs single max|dpose|={dpose:.3e} "
                  f"max|dinv|={dinv:.3e}, {lanes} lanes > 1e-4")
    for name in ("port", "reference"):
        assert gaps[name, True][0] <= 2e-4 and gaps[name, True][1] <= 1e-4
        assert gaps[name, False][2] > 0
