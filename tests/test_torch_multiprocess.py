"""The port across processes on the CPU: two worker processes join a gloo
group through ``initialize_multihost`` and run the reference's
multi-process path (``tests/multihost_worker.py`` for the reference) on the
global mesh: its rank order, the sweep, B3's plain ring with gloo hops,
``ba_solve_sharded`` reduced across the processes, the health reduction and
the refusals. The module's fixture spawns the two workers once (a
``file://`` store in a temporary directory, so no port is raced for); each
writes its results, and the cases below hold them against one process of
the port and against the reference (the 8-device virtual CPU mesh of
``tests/conftest.py``), with the tolerances stated.

Run as ``python tests/test_torch_multiprocess.py <rank> <dir>`` this file is
that worker (see ``__main__``); it imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

H, W = 64, 96
NUM_SEQS, NUM_FRAMES = 4, 2  # two sequences per process, init and one step
# B3's cases across 2 processes x 2 ranks: (name, shard shape, dtype, storage offset).
RING_CASES = [("f32", (4, 128), "float32", 0), ("f32-poses", (3, 4, 4), "float32", 0),
              ("f16", (3, 5), "float16", 0), ("i8", (5, 7), "int8", 0),
              ("f32-offset", (6, 33), "float32", 1)]
WORKER_TIMEOUT_S = 240
BOARD_STEPS, BOARD_FAIL_AT = 50, 30


def _configs(C):
    """tests/test_distributed.py's 64x96 configuration from config module `C`."""
    return C.PipelineConfig(
        camera=C.CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=C.TrackerConfig(num_levels=2, max_iterations=(6, 6), interp="bilinear",
                                depth_decimation="even"),
        depth=C.DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=6,
                            interp="bilinear"),
        keyframe=C.KeyframeConfig(),
    )


def _offset_view(a: np.ndarray, offset: int) -> torch.Tensor:
    """`a` as a tensor `offset` elements into its storage."""
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a.reshape(-1)]))
    return flat[offset:].view(a.shape)


def _worker(rank: int, tmp: str):
    """One process: group A (one CPU rank each), then group B (two each)."""
    import dataclasses

    from odometry_torch import config as tc
    from odometry_torch.camera.pinhole import Pinhole
    from odometry_torch.distributed import mesh as tmesh
    from odometry_torch.distributed import ring_exchange, sweep
    from odometry_torch.distributed.ba_dist import ba_solve_sharded
    from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh
    from odometry_torch.distributed.scaling import (
        initialize_multihost,
        shutdown_multihost,
        sweep_scaling_report,
    )
    from odometry_torch.mapping.ba import BAConfig, BAProblem

    torch.set_num_threads(1)
    inputs = np.load(os.path.join(tmp, "inputs.npz"))
    out, notes = {}, {}

    def refused(key, call):
        try:
            call()
        except ValueError as e:
            notes[key] = str(e)
        else:
            notes[key] = None

    # Group A: one CPU rank per process.
    assert initialize_multihost(f"file://{tmp}/store_a", 2, rank, device="cpu")
    cfg = _configs(tc)
    mesh = sequence_mesh(device="cpu")
    out["a_processes"] = mesh.processes
    out["a_local"] = np.array(mesh.local_ranks())
    notes["a_devices"] = [str(d) for d in mesh.devices]
    mine = slice(2 * rank, 2 * rank + 2)
    frames = inputs["frames"][mine]  # (2, F, 2, H, W)
    seqs = [[(f[0], f[1]) for f in seq] for seq in frames]
    health = []
    out["sweep_poses"] = sweep.run_sweep(seqs, cfg, mesh,
                                         progress=lambda i, s, o, ok: health.append(bool(ok)))
    out["sweep_health"] = np.array(health)
    # Health: process 1 steps flat frames (no depth survivors).
    states = sweep.batched_init(frames[:, 0, 0], frames[:, 0, 1], cfg, mesh)
    left, right = frames[:, 1, 0], frames[:, 1, 1]
    if rank == 1:
        left, right = np.zeros_like(left), np.zeros_like(right)
    _, outs, ok = sweep.batched_step(states, left, right, cfg, mesh)
    out["flat_local_ok"] = torch.cat([o.depth_ok for o in outs]).numpy()
    out["flat_global_ok"] = np.array(bool(ok))
    before = sweep.COLLECTIVE_BYTES
    _, _, ok = sweep.batched_step(states, frames[:, 1, 0], frames[:, 1, 1], cfg, mesh)
    out["healthy_global_ok"] = np.array(bool(ok))
    out["step_bytes"] = np.array(sweep.COLLECTIVE_BYTES - before)
    row = sweep_scaling_report(cfg, [2], timed=False, device="cpu")[0]
    out["report_bytes"] = np.array(row["collective_bytes"])
    out["report_ops"] = np.array(row["ops_by_rank"])
    problem = BAProblem(*(torch.from_numpy(inputs[f"ba_{k}"]) for k in BAProblem._fields))
    cam = Pinhole.create(*inputs["ba_camera"])
    for fix in (False, True):
        r = ba_solve_sharded(problem, cam, grid_mesh(1, 2, "cpu"),
                             BAConfig(window=problem.xs.shape[0], iters=3, fix_depths=fix))
        for k in ("pose", "inv_depth", "cost_initial", "cost_final", "num_residuals"):
            out[f"ba{int(fix)}_{k}"] = getattr(r, k).numpy()
    elsewhere = dataclasses.replace(tmesh.world(), hosts=("here", "elsewhere"))
    real, tmesh._WORLD = tmesh._WORLD, elsewhere
    refused("host", lambda: ring_exchange.ring_all_gather([torch.zeros(2, 4)], mesh, "seq"))
    tmesh._WORLD = real
    shutdown_multihost()

    # Group B: two CPU ranks per process.
    assert initialize_multihost(f"file://{tmp}/store_b", 2, rank, device=["cpu", "cpu"])
    mesh = sequence_mesh(device="cpu")
    out["b_processes"] = mesh.processes
    out["b_local"] = np.array(mesh.local_ranks())
    for name, _, _, offset in RING_CASES:
        shards = [_offset_view(a, offset) for a in inputs[f"ring_{name}"][2 * rank:2 * rank + 2]]
        gathered = ring_exchange.ring_all_gather(shards, mesh, "seq")
        out[f"ring_{name}"] = np.stack([g.numpy() for g in gathered])
        out[f"ring_{name}_offset"] = np.array([s.storage_offset() for s in shards])
    refused("differ", lambda: ring_exchange.ring_all_gather(
        [torch.zeros(2 + rank, 4)] * 2, mesh, "seq"))
    # The board of the host steps of B3 across processes on the cards.
    board = ring_exchange.Board(tmesh.world())
    offers, others = [], []
    for k in range(BOARD_STEPS):
        offers.append(np.stack(board.exchange(np.array([rank, k, 7 * k + rank], np.int64))))
        others.append(board.barrier(failed=rank == 1 and k == BOARD_FAIL_AT))
    board.close()
    out["board_offers"], out["board_others"] = np.stack(offers), np.array(others)
    shutdown_multihost()
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    with open(os.path.join(tmp, f"notes{rank}.json"), "w") as f:
        json.dump(notes, f)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from odometry_tpu import config as jc  # noqa: E402
from odometry_tpu.distributed import ba_dist as jbd  # noqa: E402
from odometry_tpu.distributed import ring_exchange as jr  # noqa: E402
from odometry_tpu.distributed import sweep as jsw  # noqa: E402
from odometry_tpu.mapping.ba import BAConfig as JBAConfig, BAProblem as JBAProblem  # noqa: E402
from odometry_torch import config as tc  # noqa: E402
from odometry_torch import interop  # noqa: E402
from odometry_torch.camera.pinhole import Pinhole  # noqa: E402
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo  # noqa: E402
from odometry_torch.distributed import ring_exchange as tr  # noqa: E402
from odometry_torch.distributed import sweep as tsw  # noqa: E402
from odometry_torch.distributed.ba_dist import ba_solve_sharded  # noqa: E402
from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh  # noqa: E402
from odometry_torch.mapping.ba import BAConfig  # noqa: E402
from test_ba import CAM as JCAM, K, _make_problem  # noqa: E402
from tests.torch_tools_reference import one_torch_thread  # noqa: E402,F401 (autouse)

# C1's tolerance for poses of two float32 trackers (tests/test_torch_tracker.py),
# and tests/test_distributed.py:81-87's for the sharded BA.
POSE_ATOL, BA_POSE_ATOL, BA_INV_DEPTH_ATOL = 5e-4, 2e-4, 1e-4
CFG_J, CFG_T = _configs(jc), _configs(tc)


def _inputs() -> dict:
    """The workers' inputs, numpy: NUM_SEQS sequences of NUM_FRAMES (left,
    right) pairs rendered by the port (scene s along drive_trajectory(seed=s)),
    the BA problem of tests/test_ba.py, and 4 ranks' shards of each ring case."""
    c = CFG_T.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    frames = np.stack([np.stack([np.stack([a.numpy() for a in render_stereo(
        make_scene(s, depth=14.0, device="cpu"), cam, c.baseline, torch.as_tensor(T), c.height,
        c.width)[:2]]) for T in drive_trajectory(NUM_FRAMES, step=0.35, seed=s)])
        for s in range(NUM_SEQS)])
    jp, _, _ = _make_problem(pose_noise=0.02)
    inputs = {"frames": frames.astype(np.float32),
              "ba_camera": np.array([JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy], np.float64)}
    inputs.update({f"ba_{k}": np.asarray(v) for k, v in zip(jp._fields, jp)})
    rng = np.random.default_rng(14)
    for name, shape, dtype, _ in RING_CASES:
        a = rng.standard_normal((4,) + shape) * (50 if dtype == "int8" else 1)
        inputs[f"ring_{name}"] = a.astype(dtype)
    return inputs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both workers' results ({rank: (arrays, notes)}) and the inputs; the
    reference's counterparts are computed while the workers run."""
    tmp = str(tmp_path_factory.mktemp("multiprocess"))
    inputs = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), tmp],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    try:
        reference = _reference(inputs)
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{log}"
    results = {}
    for rank in (0, 1):
        with np.load(os.path.join(tmp, f"out{rank}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, f"notes{rank}.json")) as f:
            results[rank] = (arrays, json.load(f))
    return {"workers": results, "inputs": inputs, "reference": reference, "logs": logs}


def _reference(inputs) -> dict:
    """The reference's batched step on a 2-device mesh (2 sequences per
    device), its sharded BA on 2 devices, its ring on 4 devices."""
    frames = inputs["frames"]
    mesh2 = JMesh(np.array(jax.devices()[:2]), ("seq",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh2, P("seq")))
    states = jsw.batched_init(put(frames[:, 0, 0]), put(frames[:, 0, 1]), CFG_J, mesh2)
    _, outs, ok = jsw.batched_step(states, put(frames[:, 1, 0]), put(frames[:, 1, 1]), CFG_J,
                                   mesh2)
    ref = {"poses": np.asarray(outs.cur_pose), "ok": bool(ok)}
    problem = JBAProblem(*(jnp.asarray(inputs[f"ba_{k}"]) for k in JBAProblem._fields))
    model = JMesh(np.array(jax.devices()[:2]), ("model",))
    for fix in (False, True):
        r = jbd.ba_solve_sharded(problem, JCAM, model, JBAConfig(window=K, iters=3,
                                                                 fix_depths=fix))
        ref[f"ba{int(fix)}"] = {k: np.asarray(getattr(r, k)) for k in (
            "pose", "inv_depth", "cost_final", "num_residuals")}
    mesh4 = JMesh(np.array(jax.devices()[:4]), ("map",))
    for name, shape, _, _ in RING_CASES:
        x = inputs[f"ring_{name}"].reshape((4 * shape[0],) + shape[1:])
        ref[f"ring_{name}"] = np.asarray(jax.jit(lambda a: jr.ring_all_gather(a, mesh4))(
            jnp.asarray(x)))
    return ref


@pytest.mark.parametrize("group,per", [("a", 1), ("b", 2)])
def test_global_mesh_is_process_major(run, group, per):
    """sequence_mesh() after initialize_multihost: one rank per declared
    device of every process, process 0's first, as a multi-process
    ``jax.devices()`` lists them (process p's devices hold ids p*per ..
    (p+1)*per - 1); each process owns its own."""
    for rank, (out, notes) in run["workers"].items():
        assert out[f"{group}_processes"].tolist() == [k // per for k in range(2 * per)]
        assert out[f"{group}_local"].tolist() == list(range(rank * per, (rank + 1) * per))
    assert run["workers"][0][1]["a_devices"] == ["cpu", "cpu"]


def test_sweep_across_processes_equals_one_process(run):
    """Each process's lanes equal one process's run_sweep of all four
    sequences on sequence_mesh(2, "cpu") (rank k's batch: process k's two),
    bit for bit, and global_ok holds on every frame."""
    frames = run["inputs"]["frames"]
    seqs = [[(f[0], f[1]) for f in seq] for seq in frames]
    one = tsw.run_sweep(seqs, CFG_T, sequence_mesh(2, device="cpu"), device="cpu")
    for rank, (out, _) in run["workers"].items():
        np.testing.assert_array_equal(out["sweep_poses"], one[2 * rank:2 * rank + 2])
        assert out["sweep_health"].tolist() == [True] * NUM_FRAMES


def test_sweep_across_processes_follows_the_reference(run):
    """Within C1's 5e-4 of the reference's batched_step on a 2-device mesh."""
    ref = run["reference"]
    got = np.concatenate([run["workers"][r][0]["sweep_poses"][:, 1] for r in (0, 1)])
    np.testing.assert_allclose(got, ref["poses"], rtol=0, atol=POSE_ATOL)
    assert ref["ok"]


@pytest.mark.parametrize("name", [c[0] for c in RING_CASES])
def test_ring_across_processes_matches_the_reference(run, name):
    """B3's plain ring across 2 processes x 2 ranks, hops between the
    processes over gloo: every rank's gather equals the reference's
    ring_all_gather on 4 devices, bit for bit, for float32, float16, int8
    and shards at a storage offset."""
    ref = run["reference"][f"ring_{name}"]
    offset = next(c[3] for c in RING_CASES if c[0] == name)
    for out, _ in run["workers"].values():
        assert out[f"ring_{name}"].shape == (2,) + ref.shape
        assert out[f"ring_{name}_offset"].tolist() == [offset] * 2
        for g in out[f"ring_{name}"]:
            np.testing.assert_array_equal(g, ref)


def _problem():
    jp, _, _ = _make_problem(pose_noise=0.02)
    return interop.ba_problem_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("fix_depths", [False, True])
def test_sharded_ba_across_processes_equals_one_process(run, fix_depths):
    """ba_solve_sharded over grid_mesh(1, 2) across the two processes: the
    partials all-gathered by B3 and summed in rank order give one process's
    grid_mesh(1, 2, "cpu") solve bit for bit (poses, inverse depths, costs,
    residuals) in both processes."""
    cam = Pinhole.create(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy)
    one = ba_solve_sharded(_problem(), cam, grid_mesh(1, 2, device="cpu"),
                           BAConfig(window=K, iters=3, fix_depths=fix_depths))
    for out, _ in run["workers"].values():
        for k in ("pose", "inv_depth", "cost_initial", "cost_final", "num_residuals"):
            np.testing.assert_array_equal(out[f"ba{int(fix_depths)}_{k}"],
                                          getattr(one, k).numpy())


@pytest.mark.parametrize("fix_depths", [False, True])
def test_sharded_ba_across_processes_follows_the_reference(run, fix_depths):
    """Within 2e-4 (poses) and 1e-4 (inverse depths) of the reference's
    ba_solve_sharded on 2 devices (tests/test_distributed.py:81-87), equal
    residual counts."""
    ref = run["reference"][f"ba{int(fix_depths)}"]
    for out, _ in run["workers"].values():
        np.testing.assert_allclose(out[f"ba{int(fix_depths)}_pose"], ref["pose"], rtol=0,
                                   atol=BA_POSE_ATOL)
        np.testing.assert_allclose(out[f"ba{int(fix_depths)}_inv_depth"], ref["inv_depth"],
                                   rtol=0, atol=BA_INV_DEPTH_ATOL)
        assert int(out[f"ba{int(fix_depths)}_num_residuals"]) == int(ref["num_residuals"])
        np.testing.assert_allclose(float(out[f"ba{int(fix_depths)}_cost_final"]),
                                   float(ref["cost_final"]), rtol=1e-4)


def test_health_is_reduced_over_the_processes(run):
    """Process 1 steps flat frames: its own depth fails, process 0's holds,
    and global_ok is False in both; on healthy frames True in both. A step
    moves 8 B of the pair and 8 B of the other process's pair."""
    w = run["workers"]
    assert w[0][0]["flat_local_ok"].tolist() == [True, True]
    assert w[1][0]["flat_local_ok"].tolist() == [False, False]
    for out, _ in w.values():
        assert not bool(out["flat_global_ok"]) and bool(out["healthy_global_ok"])
        assert int(out["step_bytes"]) == 16


def test_scaling_report_counts_the_reduction_across_processes(run):
    """sweep_scaling_report on the global mesh of 2 processes: both ranks'
    work, and the cross-process pair in the collective bytes (8 + 8)."""
    for out, _ in run["workers"].values():
        assert int(out["report_bytes"]) == 16
        assert len(out["report_ops"]) == 2 and min(out["report_ops"]) > 0


@pytest.mark.parametrize("case,match", [("host", "not on this host"),
                                        ("differ", "shards differ across processes")])
def test_refusals_raise_in_every_process(run, case, match):
    """A rank on another host (B3 reaches other processes through CUDA IPC,
    one host only) and shards that differ between the processes raise, in
    both processes alike, before any hop."""
    for _, notes in run["workers"].values():
        assert notes[case] is not None and match in notes[case], notes[case]


def test_board_exchanges_and_barriers(run):
    """The shared-memory board of B3's host steps across the two processes:
    each of 50 exchanges returns both processes' offers of that round, and
    each barrier reports the other process's failure only in the round it
    failed."""
    want = np.array([[[p, k, 7 * k + p] for p in (0, 1)] for k in range(BOARD_STEPS)])
    for rank, (out, _) in run["workers"].items():
        np.testing.assert_array_equal(out["board_offers"], want)
        fails = [int(rank == 0 and k == BOARD_FAIL_AT) for k in range(BOARD_STEPS)]
        assert out["board_others"].tolist() == fails


def test_offers_round_trip():
    """The words a process offers for a gather across processes on the
    cards: error, shape, dtype and each rank's handle, offset, allocation
    and event handles read back as they were packed."""
    slots = [(bytes(range(64)), 512, 2**47 + 4096, 2**21, 7, b"r" * 64, b"d" * 64),
             (bytes(64), 0, 2**40, 2**20, 2**63 + 5, b"R" * 64, b"D" * 64)]
    words = tr.pack_offer(0, (7, 16384), torch.float32, slots, max_ranks=3)
    assert words.dtype == np.int64 and words.size == tr._HEAD + 3 * tr._SLOT
    got = tr.read_offer(words, 2)
    assert got == {"error": 0, "meta": ((7, 16384), torch.float32), "slots": slots}
    assert tr.read_offer(tr.pack_offer(-3, (2,), torch.complex64, [], 1), 0)["meta"] == (
        (2,), "other")


@pytest.mark.parametrize("code,kind,match", [
    (tr._NOT_IPC_CAPABLE, RuntimeError, "unset expandable_segments:True in PYTORCH_CUDA_ALLOC_CONF"),
    (tr._NO_DRIVER, RuntimeError, "cuPointerGetAttributes was not found"),
    (tr._LOCAL_MISMATCH, ValueError, "its own shards differ"),
    (201, RuntimeError, "exporting an output failed: cuda error 201")])
def test_a_process_that_cannot_offer_fails_the_gather_in_every_process(code, kind, match):
    """Memory that legacy IPC cannot export (expandable segments), a driver
    without the entry point, a process whose own shards differ or a failed
    export: the process offers its error code instead of its outputs, and
    every process raises on reading it, naming the process and the cause;
    nothing falls back."""
    slots = [(bytes(range(64)), 512, 2**47, 2**21, 7, b"r" * 64, b"d" * 64)]
    offers = [tr.read_offer(tr.pack_offer(0, (7, 16384), torch.float32, slots, 1), 1),
              tr.read_offer(tr.pack_offer(code, (7, 16384), torch.float32, [], 1), 1)]
    assert offers[0]["error"] == 0 and offers[1]["error"] == code
    with pytest.raises(kind, match=match):
        tr._raise_offer_errors(offers)
