"""The port on several cards of one host (counterpart of
``__graft_entry__.py:dryrun_multichip`` and of the reference's
``MULTICHIP_r0*.json`` runs, at full width).

Run on a host with 2 cards or more::

    python -m odometry_torch.tools.multichip

It exits 1, printing the count it saw, with fewer than 2 visible cards. It
prints each card's line (nvidia-smi's name and power limit) and the number
of cards, then runs, each part raising where a gate fails:

(a) one process, n = 1, 2, 4 cards (as many as there are): ``run_sweep`` of
    fast_config on ``sequence_mesh`` over the first n cards, 5 sequences per
    card, the driving family (``make_driving_scene(s, side_x=20, wall_z=26)``
    along ``drive_trajectory(49, step=0.25, seed=s)``, s = 0..5n-1) at
    376x1241. Gates: ``global_ok`` on every frame, every sequence's mte <
    0.15, and each card's lanes equal to the same 5 sequences run as one
    batch on the first card, bit for bit (poses and keyframes). Reported:
    sequence-frames/s (init and steps, host clock, every card synchronised)
    and peak memory per card;
(b) one process per card, the same n and sequences: process k owns card k
    (every card stays visible to every process, as CUDA IPC needs), joins
    the group through ``initialize_multihost`` (NCCL for the health
    reduction, each process owning its card), renders its own sequences
    from their seeds and runs ``run_sweep`` on the global
    ``sequence_mesh()``, one rank per process. Gates: every process exits
    0, ``global_ok`` (reduced over every process) on every frame, poses
    equal to (a)'s, bit for bit; at n >= 2 the ring cases of (d) across the
    processes. Reported: wall sequence-frames/s, all sequence-frames over
    the slowest process's time between two barriers. Then the KITTI sweep's
    22 sequences (49 frames) on 2 cards, 11 each;
(c) a keyframe store per card, filled from (a)'s batches as ``run_slam``
    fills one: the ring across the cards on their BA windows' poses and point
    blocks (bit for bit against ``ring_gather_plain`` and ``torch.cat``, one
    launch per card), and ``ba_solve_sharded`` over ``grid_mesh(1, 4)`` on the
    cards against ``ba_solve`` on the first card: motion-only within 2e-4
    (poses) and 1e-4 (inverse depths) with equal residual counts, the
    free-depth gap reported (ROADMAP C9);
(d) B3 across cards: chip_smoke phase 9's ring cases on 2 and 4 cards (8
    ranks on 4 cards is 2 per card, which mixes the two routes), on both
    routes, bit for bit; 200 back-to-back gathers with no host read,
    compared on the cards; times at 4 x (7, 16384) and 4 x (7, 131072)
    float32 against the bound and ``torch.cuda.comm.gather`` to every card;
(e) ``sweep_scaling_report(fast_config(), [1, 2, 4], device=<the cards>)``:
    analytic efficiency >= 80%, 0 < collective bytes < 4096;
(c) and (d) across processes, one process per card (``run_job``): the ring
    across the processes on the first stores' window poses and point blocks
    (one per process), ``ba_solve_sharded`` over ``grid_mesh(1, 4)`` across
    them, bit for bit against one process's over 4 ranks of the cards
    (motion-only and free depths), every ring case of 4 ranks or more across
    the processes bit for bit (one launch per process), 200 back-to-back
    gathers with ``torch.cuda.empty_cache()`` between some, and the host
    time per gather at 4 x (7, 16384) and 4 x (7, 131072) float32 beside
    the bound and NCCL's ``all_gather_into_tensor``.

``--rehearse`` runs the same code where only one card is visible, on
virtual ranks of it (the per-process layout only for n = 1, where each
process has a card of its own; the four processes across which (c) and (d)
run share the card), to find faults before a run on several cards; its
numbers are not the cards'. :func:`dryrun_multichip` is the
reference's function, on n cards or n virtual CPU ranks.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import (
    CameraConfig,
    DepthConfig,
    KeyframeConfig,
    PipelineConfig,
    TrackerConfig,
    fast_config,
)
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_torch.device import card_line, resolve_device
from odometry_torch.distributed import ring_exchange, sweep
from odometry_torch.distributed.ba_dist import ba_solve_sharded
from odometry_torch.distributed.mesh import Mesh, grid_mesh, sequence_mesh, spread
from odometry_torch.distributed.mesh import world as mesh_world
from odometry_torch.distributed.scaling import (
    format_scaling_table,
    initialize_multihost,
    shutdown_multihost,
    sweep_scaling_report,
)
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.kernels import disparity_band
from odometry_torch.mapping.ba import BAConfig, BAProblem, ba_solve
from odometry_torch.mapping.keyframe import create_store, insert_keyframe, window_slots
from odometry_torch.tools.accuracy_sweep import render_frames
from odometry_torch.tools.roofline import NVLINK_BYTES_PER_S, PEAK_BYTES_PER_S
from odometry_torch.utils.profiling import device_ms

PER_CARD = 5
NUM_FRAMES = 49
SIZES = (1, 2, 4)
KITTI_SWEEP = (22, 2)  # the KITTI benchmark's sequences, on this many cards
MTE_GATE = 0.15
POSE_ATOL, INV_DEPTH_ATOL = 2e-4, 1e-4  # motion-only sharded BA (chip_smoke phase 11)
# (ranks, shard shape, dtype, storage offset in elements) of the ring cases.
# The float32 ones copy in 16-byte vectors, the last of them the full width,
# a 7-keyframe BA window of fast_config point blocks per rank (xs, ys,
# inv_depth and intensity x 4096 lanes); a 30-byte float16 shard, a 35-byte
# int8 shard and a float32 shard 4 bytes into its storage take the kernel's
# byte and 4-byte paths.
RING_CASES = ((1, (4, 128), torch.float32, 0), (2, (3, 4, 4), torch.float32, 0),
              (3, (5, 4, 4), torch.float32, 0), (8, (4, 128), torch.float32, 0),
              (8, (3, 4, 4), torch.float32, 0), (3, (3, 5), torch.float16, 0),
              (8, (5, 7), torch.int8, 0), (4, (6, 33), torch.float32, 1),
              (8, (7, 16384), torch.float32, 0))
RING_REPEATS = 200
RING_TIMING = ((7, 16384), (7, 131072))  # one shard per card; the second above the L2


def _log(line: str):
    print(line, flush=True)


def _cards(devices) -> list:
    """The distinct cards among `devices`, in order."""
    return [d for d in dict.fromkeys(devices) if d.type == "cuda"]


def _sync(devices):
    for d in _cards(devices):
        torch.cuda.synchronize(d)


def ring_bound_ms(devices: list, nbytes: int) -> float:
    """Least time of an all-gather of one `nbytes` shard per rank, rank r on
    devices[r]: for each card, the bytes of its memory (its shards read once,
    every byte of its ranks' outputs written once) at 3.35 TB/s, and the
    bytes that must cross NVLink into it (its k outputs' shards from the
    other num - k ranks) and out of it (as many) at 450 GB/s each way; the
    largest over the cards. On one card it is the memory term alone."""
    num = len(devices)
    worst = 0.0
    for k in collections.Counter(devices).values():
        memory = (k + k * num) * nbytes / PEAK_BYTES_PER_S
        link = k * (num - k) * nbytes / NVLINK_BYTES_PER_S
        worst = max(worst, memory, link)
    return 1e3 * worst


# ------------------------------------------------------------ the dry run


def dryrun_config() -> PipelineConfig:
    """The reference's dry-run configuration (``__graft_entry__.py:76-86``)."""
    H, W = 64, 96
    return PipelineConfig(
        camera=CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=TrackerConfig(num_levels=2, max_iterations=(4, 4), interp="bilinear",
                              depth_decimation="even"),
        depth=DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=4,
                          interp="bilinear"),
        keyframe=KeyframeConfig(),
    )


def dryrun_multichip(n_devices: int, device="cuda", log=_log) -> dict:
    """The reference's ``dryrun_multichip(n)``: ONE sharded multi-sequence
    odometry step at 64x96 over `n_devices` ranks (the first n cards for
    "cuda", n virtual ranks for "cpu"), one sequence each (``make_scene(s,
    depth=14.0)`` at the identity pose), the health reduced over the ranks;
    then the weak-scaling report at 1, 2, 4, ... n. Prints the reference's
    lines; returns {"poses", "global_ok", "rows", "flat"}."""
    cfg = dryrun_config()
    c = cfg.camera
    mesh = sequence_mesh(n_devices, device)
    devs = mesh.axis_devices("seq")
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    frames = [render_stereo(make_scene(s, depth=14.0, device=d), cam, c.baseline, torch.eye(4),
                            c.height, c.width)[:2] for s, d in enumerate(devs)]
    lefts, rights = [f[0] for f in frames], [f[1] for f in frames]
    states = sweep.batched_init(lefts, rights, cfg, mesh)
    new_states, _, global_ok = sweep.batched_step(states, lefts, rights, cfg, mesh)
    poses = torch.cat([s.cur_pose.cpu() for s in new_states])
    assert tuple(poses.shape) == (n_devices, 4, 4)
    ok = bool(global_ok)
    log(f"dryrun_multichip({n_devices}): step executed; poses {tuple(poses.shape)}, "
        f"global_ok={ok}")
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_devices]
    if sizes[-1] != n_devices:
        sizes.append(n_devices)
    rows = sweep_scaling_report(cfg, sizes, device=device)
    log(format_scaling_table(rows))
    flat = all(r["analytic_efficiency_pct"] >= 80.0 for r in rows)
    log(f"dryrun_multichip({n_devices}): analytic weak-scaling >=80%: {flat}")
    return {"poses": poses.numpy(), "global_ok": ok, "rows": rows, "flat": flat}


# ----------------------------------------------------- (a) one process


def driving_runs(seeds, num_frames: int, cfg: PipelineConfig, device) -> list:
    """[(ground-truth poses, [(left, right)] on `device`)] of the driving
    family for each seed."""
    return [render_frames("driving", s, cfg, num_frames, device) for s in seeds]


def keyframe_ids(promoted: np.ndarray) -> list:
    """Frame 0 and every frame whose step promoted; `promoted` (steps,)."""
    return [0] + [i + 1 for i in np.nonzero(promoted)[0].tolist()]


def _store_of(cfg, state, store=None, frame=0):
    """`store` (a new one on the state's device when None) with `state`'s
    keyframe inserted, as ``run_slam`` inserts it."""
    c = cfg.camera
    if store is None:
        store = create_store(32, cfg.tracker.point_capacity, c.height, c.width,
                             device=state.kf_pose.device)
    kf = state.kf_track[0]
    return insert_keyframe(store, kf.pts, kf.intensity, state.kf_pose, frame,
                           image=state.kf_pyr[0])


def sweep_run(frames_per_seq, cfg: PipelineConfig, mesh: Mesh, *, store_lane0=False) -> dict:
    """``run_sweep`` of `frames_per_seq` on `mesh`, every card synchronised
    before and after: poses, per-frame global_ok, each sequence's keyframes,
    seconds (init and steps), peak memory per card above what it held
    before, and with `store_lane0` a keyframe store of the first sequence
    (host reads of its promotion flag each step; not for timed runs)."""
    devs = mesh.axis_devices("seq")
    cards = _cards(devs)
    health, promoted, store = [], [], [None]

    def progress(i, states, outs, global_ok):
        health.append(global_ok)
        if outs is not None:
            promoted.append([o.promoted for o in outs])
        if store_lane0 and (outs is None or bool(outs[0].promoted[0])):
            store[0] = _store_of(cfg, sweep.sequence_view(states, 0), store[0], i)

    _sync(devs)
    held = {d: torch.cuda.memory_allocated(d) for d in cards}
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    poses = sweep.run_sweep(frames_per_seq, cfg, mesh, progress=progress)
    _sync(devs)
    seconds = time.perf_counter() - t0
    prom = np.stack([np.concatenate([p.cpu().numpy() for p in step]) for step in promoted])
    return dict(poses=poses, health=[bool(h) for h in health], seconds=seconds,
                keyframes=[keyframe_ids(prom[:, s]) for s in range(prom.shape[1])],
                peak_gib={str(d): (torch.cuda.max_memory_allocated(d) - held[d]) / 2**30
                          for d in cards},
                store=store[0])


def _gate_run(name: str, r: dict, truths: list):
    mtes = [mean_translation_error(t, p) for t, p in zip(truths, r["poses"])]
    r["mtes"] = mtes
    if not all(r["health"]):
        raise RuntimeError(f"{name}: global_ok False on {r['health'].count(False)} frames")
    if not max(mtes) < MTE_GATE:
        raise RuntimeError(f"{name}: mte {max(mtes)} fails the gate {MTE_GATE} ({mtes})")


def one_process(cards: list, runs: list, cfg: PipelineConfig, per_card: int, log=_log):
    """(a): the references (each card's sequences as one batch on cards[0],
    a keyframe store of each one's first sequence), then ``run_sweep`` on
    1, 2, 4 cards. Returns (timed runs by n, stores)."""
    truths = [t for t, _ in runs]
    frames = [f for _, f in runs]
    first = sequence_mesh(None, cards[:1])
    refs, stores = [], []
    for k in range(len(cards)):
        lanes = slice(k * per_card, (k + 1) * per_card)
        r = sweep_run(frames[lanes], cfg, first, store_lane0=True)
        _gate_run(f"(a) reference batch {k}", r, truths[lanes])
        refs.append(r)
        stores.append(_move_store(r.pop("store"), cards[k]))
        log(f"(a) reference: sequences {lanes.start}..{lanes.stop - 1} as one batch on "
            f"{cards[0]}: {r['seconds']:.3f} s, keyframes {[len(kf) for kf in r['keyframes']]}, "
            f"mte max {max(r['mtes']):.6f}")
    # Each sequence's frames on the card of its rank, for every n.
    placed = [[(left.to(cards[s // per_card]), right.to(cards[s // per_card]))
               for left, right in f] for s, f in enumerate(frames)]
    timed = {}
    for n in (n for n in SIZES if n <= len(cards)):
        S = n * per_card
        mesh = sequence_mesh(None, cards[:n])
        r = sweep_run(placed[:S], cfg, mesh)
        _gate_run(f"(a) {n} card(s)", r, truths[:S])
        for s in range(S):
            ref = refs[s // per_card]
            lane = s % per_card
            if not (np.array_equal(r["poses"][s], ref["poses"][lane])
                    and r["keyframes"][s] == ref["keyframes"][lane]):
                gap = float(np.abs(r["poses"][s] - ref["poses"][lane]).max())
                raise RuntimeError(f"(a) {n} card(s): sequence {s} on {cards[s // per_card]} "
                                   f"differs from its batch on {cards[0]} (max |dpose| {gap}, "
                                   f"keyframes {r['keyframes'][s]} / {ref['keyframes'][lane]})")
        r["rate"] = S * (len(frames[0]) - 1) / r["seconds"]
        timed[n] = r
        log(f"(a) one process, {n} card(s) x {per_card} sequences x {len(frames[0])} frames: "
            f"{r['rate']:.3f} sequence-frames/s ({r['seconds']:.3f} s, init and steps), "
            f"{r['rate'] / timed[1]['rate']:.3f}x one card; peak GiB per card "
            f"{ {d: round(g, 3) for d, g in r['peak_gib'].items()} }; global_ok "
            f"{sum(r['health'])}/{len(r['health'])}; mte max {max(r['mtes']):.6f}; each card's "
            f"lanes equal their batch on {cards[0]}, bit for bit")
    return timed, stores


def _move_store(store, dev):
    return dataclasses.replace(store, **{f.name: getattr(store, f.name).to(dev)
                                         for f in dataclasses.fields(store)})


# ------------------------------------------------- (b) one process per card

CONFIGS = {"fast": fast_config, "dryrun": dryrun_config}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def per_process(seed_groups: list, num_frames: int, *, device="cuda", config="fast",
                timeout: float = 900.0, cards: list | None = None, job: dict | None = None) -> list:
    """One process per group of seeds, joined in one process group through
    ``initialize_multihost``, each running :func:`worker`: process k on card
    ``cards[k]`` (default k; every card stays visible to every process, as
    CUDA IPC between them needs, so a card may hold several processes) for
    ``device`` "cuda", or one CPU rank (one torch thread) each. An empty
    group runs no sweep; `job` holds the parts across processes
    (:func:`run_job`). Returns each process's record: with seeds, poses
    (S_k, F, 4, 4), promoted (F - 1, S_k), health (F,), seconds between its
    barriers, peak memory above what it held before (GiB, 0 on the CPU);
    the job's results; and the B1 and B3 launches it made."""
    n = len(seed_groups)
    root = Path(__file__).resolve().parents[2]
    port = _free_port()
    cuda = resolve_device(device).type == "cuda"
    cards = list(range(n)) if cards is None else cards
    with tempfile.TemporaryDirectory(prefix="multichip_") as tmp:
        job_path = os.path.join(tmp, "job.pt")
        torch.save(job or {}, job_path)
        procs = []
        for rank, seeds in enumerate(seed_groups):
            args = [sys.executable, "-m", "odometry_torch.tools.multichip", "--worker",
                    str(rank), str(n), str(port), os.path.join(tmp, f"rank{rank}.npz"),
                    "--seeds", ",".join(map(str, seeds)), "--frames", str(num_frames),
                    "--config", config, "--device", "cuda" if cuda else "cpu",
                    "--card", str(cards[rank]), "--job", job_path]
            procs.append(subprocess.Popen(args, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"per-process rank {rank} exited {p.returncode}:\n{out}")
        records = []
        for rank in range(n):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                records.append({k: z[k] for k in z.files})
    return records


def _barrier(dev):
    """Every process here, and this process's card idle."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def worker(rank: int, world: int, port: int, out: str, seeds: list, num_frames: int, *,
           config="fast", device="cuda", card: int = 0, job: dict | None = None) -> int:
    """One process of :func:`per_process`: joins the group with its card
    (or one CPU rank), then on the global ``sequence_mesh()`` (one rank per
    process) renders its sequences on its device, warms up on their first 3
    frames and runs ``run_sweep`` between two barriers; then `job`'s parts
    (:func:`run_job`). Saves its record to `out`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", card)
    initialize_multihost(f"localhost:{port}", world, rank, device=dev)
    try:
        disparity_band.LAUNCHES = ring_exchange.LAUNCHES = 0
        mesh = sequence_mesh(device=dev.type)
        record = {}
        if seeds:
            cfg = CONFIGS[config]()
            frames = [f for _, f in driving_runs(seeds, num_frames, cfg, dev)]
            sweep.run_sweep([f[:3] for f in frames], cfg, mesh)
            health, promoted = [], []

            def progress(i, states, outs, global_ok):
                health.append(global_ok)
                if outs is not None:
                    promoted.append(outs[0].promoted)

            _barrier(dev)
            if dev.type == "cuda":
                held = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            band = disparity_band.LAUNCHES
            t0 = time.perf_counter()
            poses = sweep.run_sweep(frames, cfg, mesh, progress=progress)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            peak = ((torch.cuda.max_memory_allocated(dev) - held) / 2**30
                    if dev.type == "cuda" else 0.0)
            _barrier(dev)
            record.update(poses=poses, health=np.array([bool(h) for h in health]),
                          promoted=torch.stack(promoted).cpu().numpy(), seconds=seconds,
                          peak_gib=peak, sweep_band=disparity_band.LAUNCHES - band)
        record.update(run_job(job or {}, dev))
        record.update(band_launches=disparity_band.LAUNCHES, ring_launches=ring_exchange.LAUNCHES)
        np.savez(out, **record)
    finally:
        shutdown_multihost()
    return 0


# ------------------------------------------- (c), (d) across the processes


def _seeded_shards(num: int, shape, dtype, offset: int, seed: int, dev) -> list:
    """`num` shards of `shape` on `dev`, `offset` elements into their
    storage, made on the CPU from `seed` (every process makes the same)."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    base = [torch.randn(n + offset, generator=g).to(dtype) if dtype.is_floating_point else
            torch.randint(-128, 128, (n + offset,), generator=g).to(dtype) for _ in range(num)]
    return [b.to(dev)[offset:].view(shape) for b in base]


def _check_across(everyone: list, mesh: Mesh, dev) -> tuple:
    """One ``ring_all_gather`` across the processes of this process's shards
    of `everyone` (every rank's shards, on `dev`) over `mesh`, against the
    plain ring of all of them and ``torch.cat``, bit for bit. Returns (ok,
    max |kernel - plain|, launches)."""
    before = ring_exchange.LAUNCHES
    outs = ring_exchange.ring_all_gather([everyone[r] for r in mesh.local_ranks()], mesh,
                                         axis="seq")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = ring_exchange.LAUNCHES - before
    plain = ring_exchange.ring_gather_plain(everyone)[0]
    full = torch.cat(everyone)
    ok = all(torch.equal(o, plain) and torch.equal(o, full) for o in outs)
    err = max(float((o.double() - plain.double()).abs().max()) if o.numel() else 0.0
              for o in outs)
    return ok, err, launches


def _wall_ms(fn, reps: int, dev) -> float:
    """Host time of one of `reps` back-to-back calls of `fn`, every process
    starting together after a warm call and this card synchronised at the
    end."""
    fn()
    _barrier(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / reps
    _barrier(dev)
    return ms


def run_job(job: dict, dev) -> dict:
    """The parts across processes, in every process of the group alike;
    returns this process's results (numpy values), with the B3 launches of
    the windows and BA (the path's work) as "path_ring_launches".

    - "windows": {"poses", "blocks"}, every rank's (W, ...) window shards
      (one rank per process): the ring across the processes on them;
    - "ba": {"problem" (BAProblem fields), "camera" (fx, fy, cx, cy),
      "iters"}: ``ba_solve_sharded`` over ``grid_mesh(1, processes)``,
      motion-only and with free depths;
    - "ring_cases": [(ranks, shape, dtype, offset)], ranks at least the
      processes, spread over them in order: the ring across processes, bit
      for bit against the plain ring and ``torch.cat``;
    - "ring_repeats": (count, every, shape): `count` gathers of one shard per
      process back to back, ``torch.cuda.empty_cache()`` after every
      `every`-th, each compared on the device;
    - "ring_timing": [(shape, reps)]: host time per gather of one float32
      shard per process, and of NCCL's ``all_gather_into_tensor`` where the
      group's device collectives run over NCCL; on cards also the gather's
      two host steps alone on its board, and one gloo barrier.
    """
    w = mesh_world()
    res = {}
    mesh = sequence_mesh(device=dev.type)
    before = ring_exchange.LAUNCHES
    if "windows" in job:
        for name in ("poses", "blocks"):
            ok, err, launches = _check_across([t.to(dev) for t in job["windows"][name]], mesh,
                                              dev)
            res.update({f"windows_{name}_ok": ok, f"windows_{name}_err": err,
                        f"windows_{name}_launches": launches})
    if "ba" in job:
        b = job["ba"]
        problem = BAProblem(*(t.to(dev) for t in b["problem"]))
        cam = Pinhole.create(*b["camera"])
        for fix in (True, False):
            r = ba_solve_sharded(problem, cam, grid_mesh(1, w.size, dev.type),
                                 BAConfig(iters=b["iters"], fix_depths=fix,
                                          window=problem.xs.shape[0]))
            for k in ("pose", "inv_depth", "cost_initial", "cost_final", "num_residuals"):
                res[f"ba_{int(fix)}_{k}"] = getattr(r, k).cpu().numpy()
    res["path_ring_launches"] = ring_exchange.LAUNCHES - before  # the windows' and BA's
    for i, (num, shape, dtype, offset) in enumerate(job.get("ring_cases", ())):
        everyone = _seeded_shards(num, shape, dtype, offset, 100 + i, dev)
        ok, err, launches = _check_across(everyone, sequence_mesh(num, dev.type), dev)
        res.update({f"case{i}_ok": ok, f"case{i}_err": err, f"case{i}_launches": launches})
    if "ring_repeats" in job:
        count, every, shape = job["ring_repeats"]
        everyone = _seeded_shards(w.size, shape, torch.float32, 0, 99, dev)
        full = torch.cat(everyone)
        mine = [everyone[r] for r in mesh.local_ranks()]
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(count):
            for o in ring_exchange.ring_all_gather(mine, mesh, axis="seq"):
                bad = bad + (o != full).any()
            if every and k % every == every - 1:
                torch.cuda.empty_cache()
        res["repeats_bad"] = int(bad)
    for shape, reps in job.get("ring_timing", ()):
        mine = [torch.randn(shape, device=dev) for _ in mesh.local_ranks()]
        label = "x".join(map(str, shape))
        res[f"time_{label}_ms"] = _wall_ms(
            lambda: ring_exchange.ring_all_gather(mine, mesh, axis="seq"), reps, dev)
        if w.backend == "nccl":
            out = torch.empty((w.size * shape[0],) + tuple(shape[1:]), device=dev)
            res[f"time_{label}_nccl_ms"] = _wall_ms(
                lambda: dist.all_gather_into_tensor(out, mine[0], group=w.device_group), reps, dev)
    if job.get("ring_timing") and dev.type == "cuda":
        # The gather's two host steps alone, on its board, beside one gloo barrier.
        board = w.peers.board_of(w)
        offer = np.zeros(ring_exchange._HEAD + ring_exchange._SLOT, dtype=np.int64)
        res["time_board_ms"] = _wall_ms(lambda: (board.exchange(offer), board.barrier(False)),
                                        200, dev)
        res["time_gloo_barrier_ms"] = _wall_ms(dist.barrier, 200, dev)
    return res


def cross_process_job(stores: list, cfg: PipelineConfig, processes: int) -> dict:
    """(c) and (d)'s parts across `processes` processes: the windows of the
    first `processes` stores (one per process) and BA on the first, every
    ring case of at least that many ranks, the repeats and the times."""
    c = cfg.camera
    W = min(5, min(int(st.count) for st in stores))
    slots = [window_slots(st, W) for st in stores[:processes]]
    stores = stores[:processes]
    st, sl = stores[0], slots[0]
    problem = BAProblem(images=st.image[sl], xs=st.xs[sl], ys=st.ys[sl],
                        inv_depth=st.inv_depth[sl], intensity=st.intensity[sl],
                        point_valid=st.point_valid[sl], pose=st.pose[sl],
                        kf_valid=st.occupied[sl])
    return {
        "windows": {"poses": [s.pose[sl].cpu() for s, sl in zip(stores, slots)],
                    "blocks": [torch.cat([s.xs[sl], s.ys[sl], s.inv_depth[sl], s.intensity[sl]],
                                         dim=1).cpu() for s, sl in zip(stores, slots)]},
        "ba": {"problem": tuple(t.cpu() for t in problem), "camera": (c.fx, c.fy, c.cx, c.cy),
               "iters": 4},
        "ring_cases": [case for case in RING_CASES if case[0] >= processes],
        "ring_repeats": (RING_REPEATS, 7, RING_TIMING[0]),
        "ring_timing": [(shape, reps) for shape, reps in zip(RING_TIMING, (50, 20))],
    }


def path_gathers(job: dict) -> int:
    """The gathers across processes of `job`'s path work in each process:
    the windows' two, and six partial sums per BA iteration and the inverse
    depths for each of BA's two solves."""
    return 2 * ("windows" in job) + (2 * (6 * job["ba"]["iters"] + 1) if "ba" in job else 0)


def job_gathers(job: dict) -> int:
    """All the gathers across processes that each process makes for `job`:
    :func:`path_gathers`, one per ring case and repeat, and each timing's
    calls with its warm one."""
    n = path_gathers(job) + len(job.get("ring_cases", ()))
    n += job["ring_repeats"][0] if "ring_repeats" in job else 0
    return n + sum(reps + 1 for _, reps in job.get("ring_timing", ()))


def check_job(recs: list, job: dict, ba_one: dict | None, label: str, log=_log,
              launches: int = 1) -> dict:
    """Gates the job's results of every process: the windows and ring cases
    bit for bit with `launches` launches per process and gather (one on a
    card, none on the CPU), no repeat differing, and BA across the
    processes equal to `ba_one` ({fix: BAResult of one process's
    ``ba_solve_sharded`` over as many ranks}) bit for bit. Returns the
    largest time per gather over the processes by key."""
    n = len(recs)
    bad = []
    for name in ("poses", "blocks") if "windows" in job else ():
        ok = all(bool(r[f"windows_{name}_ok"]) and int(r[f"windows_{name}_launches"]) ==
                 launches for r in recs)
        log(f"{'PASS' if ok else 'FAIL'}  {label}: ring across {n} processes on the window "
            f"{name} ({tuple(job['windows'][name][0].shape)} per rank), bitwise vs plain and "
            f"torch.cat, launches {[int(r[f'windows_{name}_launches']) for r in recs]}")
        bad += [] if ok else [f"windows {name}"]
    for i, (num, shape, dtype, offset) in enumerate(job.get("ring_cases", ())):
        ok = all(bool(r[f"case{i}_ok"]) and int(r[f"case{i}_launches"]) == launches
                 for r in recs)
        log(f"{'PASS' if ok else 'FAIL'}  {label}: ring {num} ranks across {n} processes shard="
            f"{shape} {dtype} offset={offset}: bitwise vs plain and torch.cat, max|diff|="
            f"{max(float(r[f'case{i}_err']) for r in recs)}, launches "
            f"{[int(r[f'case{i}_launches']) for r in recs]} (want {launches} per process)")
        bad += [] if ok else [f"case {i}"]
    if "ring_repeats" in job:
        count = job["ring_repeats"][0]
        nbad = sum(int(r["repeats_bad"]) for r in recs)
        log(f"{label}: {count} back-to-back gathers across {n} processes of "
            f"{job['ring_repeats'][2]} per process, torch.cuda.empty_cache() after every "
            f"{job['ring_repeats'][1]}th: {nbad} outputs differ")
        bad += [f"{nbad} repeats"] if nbad else []
    if "ba" in job:
        for fix in (True, False):
            want = ba_one[fix]
            same = all(all(np.array_equal(r[f"ba_{int(fix)}_{k}"], getattr(want, k).cpu().numpy())
                           for k in ("pose", "inv_depth", "cost_initial", "cost_final",
                                     "num_residuals")) for r in recs)
            log(f"{'PASS' if same else 'FAIL'}  {label}: ba_solve_sharded over grid_mesh(1, {n}) "
                f"across {n} processes, fix_depths={fix}: poses, inverse depths, costs and "
                f"residuals equal one process's ba_solve_sharded over {n} ranks, bit for bit "
                f"(cost {float(want.cost_initial):.6f} -> {float(want.cost_final):.6f})")
            bad += [] if same else [f"BA fix_depths={fix}"]
    got, want = [int(r["ring_launches"]) for r in recs], launches * job_gathers(job)
    path = [int(r["path_ring_launches"]) for r in recs]
    want_path = launches * path_gathers(job)
    log(f"{label}: B3 launches per process {got}, {path} of them on the windows and BA (want "
        f"{want} and {want_path}: {launches} per gather)")
    bad += [] if got == [want] * n and path == [want_path] * n else ["B3 launches"]
    if bad:
        raise RuntimeError(f"{label}: {bad} fail")
    return {k: max(float(r[k]) for r in recs) for k in recs[0] if k.startswith("time_")}


def per_process_layout(timed: dict, per_card: int, num_frames: int, log=_log) -> dict:
    """(b): one process per card at each n of (a) (only n = 1 when
    rehearsing on one card), on the global mesh, held to (a)'s poses, with
    the ring cases across the processes at n >= 2; then the KITTI sweep's
    22 sequences on 2 cards. Returns {n: wall sequence-frames/s}."""
    physical = torch.cuda.device_count()
    rates = {}
    for n in timed:
        if n > physical:
            log(f"(b) {n} processes: not run, {physical} card(s) visible")
            continue
        groups = [list(range(k * per_card, (k + 1) * per_card)) for k in range(n)]
        job = {"ring_cases": [c for c in RING_CASES if c[0] >= n]} if n > 1 else {}
        recs = per_process(groups, num_frames, job=job)
        if job:
            check_job(recs, job, None, f"(d) {n} processes", log)
        poses = np.concatenate([r["poses"] for r in recs])
        if not all(bool(r["health"].all()) for r in recs):
            raise RuntimeError(f"(b) {n} processes: global_ok False on a frame")
        if not np.array_equal(poses, timed[n]["poses"]):
            gap = float(np.abs(poses - timed[n]["poses"]).max())
            raise RuntimeError(f"(b) {n} processes: poses differ from one process's (max "
                               f"|dpose| {gap})")
        kfs = [keyframe_ids(r["promoted"][:, s]) for r in recs for s in range(per_card)]
        if kfs != timed[n]["keyframes"]:
            raise RuntimeError(f"(b) {n} processes: keyframes differ from one process's")
        wall = max(float(r["seconds"]) for r in recs)
        rates[n] = n * per_card * (num_frames - 1) / wall
        log(f"(b) one process per card on the global sequence_mesh(), {n} process(es) x "
            f"{per_card} sequences x {num_frames} frames: {rates[n]:.3f} wall sequence-frames/s "
            f"(slowest process {wall:.3f} s; each {[round(float(r['seconds']), 3) for r in recs]} "
            f"s), {rates[n] / rates[1]:.3f}x one card; peak GiB per process "
            f"{[round(float(r['peak_gib']), 3) for r in recs]}; against one process on {n} "
            f"card(s) {timed[n]['rate']:.3f}; poses and keyframes equal one process's, bit for "
            f"bit; every process exited 0")
    seqs, n = KITTI_SWEEP
    if n > physical:
        log(f"(b) KITTI sweep, {seqs} sequences on {n} cards: not run, {physical} card(s) "
            "visible")
        return rates
    per = seqs // n
    recs = per_process([list(range(k * per, (k + 1) * per)) for k in range(n)], num_frames)
    poses = np.concatenate([r["poses"] for r in recs])
    truths = [drive_trajectory(num_frames, step=0.25, seed=s) for s in range(seqs)]
    mtes = [mean_translation_error(t, p) for t, p in zip(truths, poses)]
    wall = max(float(r["seconds"]) for r in recs)
    ok = all(bool(r["health"].all()) for r in recs)
    log(f"(b) KITTI sweep: {seqs} sequences x {num_frames} frames on {n} cards, {per} per "
        f"process: {seqs * (num_frames - 1) / wall:.3f} wall sequence-frames/s (slowest "
        f"process {wall:.3f} s), median mte {float(np.median(mtes)):.6f}, max "
        f"{max(mtes):.6f}, global_ok on every frame: {ok}")
    if not ok or not float(np.median(mtes)) < MTE_GATE:
        raise RuntimeError(f"(b) KITTI sweep: global_ok {ok}, median mte {np.median(mtes)}")
    return rates


def across_processes(cards: list, stores: list, cfg: PipelineConfig, card: str,
                     log=_log) -> dict:
    """(c) and (d) across processes: one process per card of `cards` (a
    card may repeat: its processes share it), the windows' ring and
    ``ba_solve_sharded`` over ``grid_mesh(1, processes)``, held bit for bit
    to this process's ``ba_solve_sharded`` over as many ranks on `cards`,
    the ring cases, the repeats and the times. Returns the times, the
    processes' B3 launches (all, and those of the windows and BA) and
    their B1 launches."""
    n = len(cards)
    job = cross_process_job(stores, cfg, n)
    b = job["ba"]
    problem = BAProblem(*(t.to(cards[0]) for t in b["problem"]))
    cam = Pinhole.create(*b["camera"])
    ba_one = {fix: ba_solve_sharded(problem, cam, grid_mesh(1, n, list(cards)),
                                    BAConfig(iters=b["iters"], fix_depths=fix,
                                             window=problem.xs.shape[0]))
              for fix in (True, False)}
    recs = per_process([[] for _ in range(n)], 0, cards=[d.index for d in cards], job=job)
    times = check_job(recs, job, ba_one, f"(c)/(d) {n} processes", log)
    for shape in RING_TIMING:
        label = "x".join(map(str, shape))
        nbytes = int(np.prod(shape)) * 4
        bound = ring_bound_ms(list(cards), nbytes)
        nccl = times.get(f"time_{label}_nccl_ms")
        log(f"timing ring across {n} processes on {[str(d) for d in cards]}, one shard {shape} "
            f"float32 each: {times[f'time_{label}_ms']:.4f} ms per gather (host time of "
            f"back-to-back gathers, the slowest process), bound {bound:.4f} ms, NCCL "
            f"all_gather_into_tensor " + (f"{nccl:.4f} ms" if nccl is not None else
                                          "not run (processes share a card: gloo)") + f" [{card}]")
    log(f"(c)/(d) {n} processes: the two host steps of a gather alone on its board "
        f"{times['time_board_ms']:.4f} ms, one gloo barrier {times['time_gloo_barrier_ms']:.4f} ms "
        f"(host time of 200 back-to-back, the slowest process) [{card}]")
    return {"times": times, "ring_launches": sum(int(r["ring_launches"]) for r in recs),
            "path_ring_launches": sum(int(r["path_ring_launches"]) for r in recs),
            "band_launches": sum(int(r["band_launches"]) for r in recs)}


# -------------------------------------------- (c) the windows and sharded BA


def windows_and_ba(cards: list, stores: list, cfg: PipelineConfig, log=_log) -> tuple:
    """(c): the ring across the cards on the stores' window poses and point
    blocks, then BA on the first store, single on its card and sharded over
    ``grid_mesh(1, 4)`` of the cards. Returns (the ring's launches,
    {fix_depths: the sharded result})."""
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    W = min(5, min(int(st.count) for st in stores))
    if W < 2:
        raise RuntimeError(f"(c) stores hold too few keyframes for a BA window ({W})")
    slots = [window_slots(st, W) for st in stores]
    mesh = sequence_mesh(None, cards)
    poses = [st.pose[sl] for st, sl in zip(stores, slots)]
    blocks = [torch.cat([st.xs[sl], st.ys[sl], st.inv_depth[sl], st.intensity[sl]], dim=1)
              for st, sl in zip(stores, slots)]
    before = ring_exchange.LAUNCHES
    got = (ring_exchange.gather_keyframe_poses(poses, mesh, axis="seq"),
           ring_exchange.ring_all_gather(blocks, mesh, axis="seq"))
    _sync(cards)
    launches = ring_exchange.LAUNCHES - before
    want = 2 * len(_cards(cards))
    for name, outs, shards in (("poses", got[0], poses), ("point blocks", got[1], blocks)):
        plain = ring_exchange.ring_gather_plain(shards)
        ok = all(o.device == d and torch.equal(o, p) and torch.equal(
            o, torch.cat([s.to(d) for s in shards])) for o, p, d in zip(outs, plain, cards))
        log(f"{'PASS' if ok else 'FAIL'}  (c) ring across {len(_cards(cards))} card(s) on the "
            f"window {name}: {len(shards)} ranks of {tuple(shards[0].shape)}, bitwise vs plain "
            "and torch.cat")
        if not ok:
            raise RuntimeError(f"(c) ring on the window {name} differs from its plain version")
    if launches != want:
        raise RuntimeError(f"(c) ring launches on the windows: {launches}, expected {want}")

    st, sl = stores[0], slots[0]
    problem = BAProblem(images=st.image[sl], xs=st.xs[sl], ys=st.ys[sl],
                        inv_depth=st.inv_depth[sl], intensity=st.intensity[sl],
                        point_valid=st.point_valid[sl], pose=st.pose[sl],
                        kf_valid=st.occupied[sl])
    model = grid_mesh(1, 4, spread(cards, 4))
    sharded_by_fix = {}
    for fix in (True, False):
        bacfg = BAConfig(iters=4, fix_depths=fix, window=W)
        single = ba_solve(problem, cam, bacfg)
        sharded = sharded_by_fix[fix] = ba_solve_sharded(problem, cam, model, bacfg)
        _sync(cards)
        dpose = float((sharded.pose - single.pose).abs().max())
        dinv = (sharded.inv_depth - single.inv_depth).abs()
        n1, n2 = int(single.num_residuals), int(sharded.num_residuals)
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (single.pose, single.inv_depth, sharded.pose, sharded.inv_depth))
        ok = finite and float(single.cost_final) <= float(single.cost_initial)
        if fix:
            ok = ok and dpose <= POSE_ATOL and float(dinv.max()) <= INV_DEPTH_ATOL and n1 == n2
            gates = f"gated: dpose <= {POSE_ATOL}, dinv <= {INV_DEPTH_ATOL}, equal residuals"
        else:
            gates = (f"free depths, not gated against ba_solve (ROADMAP C9): "
                     f"{int((dinv > INV_DEPTH_ATOL).sum())} lanes differ by > {INV_DEPTH_ATOL}")
        log(f"{'PASS' if ok else 'FAIL'}  (c) BA W={W} P={problem.xs.shape[1]} fix_depths={fix}: "
            f"ba_solve on {cards[0]} vs ba_solve_sharded over grid_mesh(1, 4) on "
            f"{[str(d) for d in model.axis_devices('model')]}: cost "
            f"{float(single.cost_initial):.6f} -> {float(single.cost_final):.6f} (sharded "
            f"{float(sharded.cost_final):.6f}), residuals {n1}/{n2}, max|dpose|={dpose:.3e}, "
            f"max|dinv|={float(dinv.max()):.3e} ({gates})")
        if not ok:
            raise RuntimeError(f"(c) BA (fix_depths={fix}) fails its gates")
    return launches, sharded_by_fix


# ------------------------------------------------------- (d) B3 across cards


def ring_shards(devices: list, shape, dtype, offset: int, g: torch.Generator) -> list:
    """One shard per rank, rank r's on devices[r], `offset` elements into its
    storage; made on the first device from `g`, then moved."""
    n = int(np.prod(shape))
    dev0 = devices[0]
    if dtype.is_floating_point:
        base = [torch.randn(n + offset, generator=g, device=dev0).to(dtype) for _ in devices]
    else:
        base = [torch.randint(-128, 128, (n + offset,), generator=g, device=dev0).to(dtype)
                for _ in devices]
    return [b.to(d)[offset:].view(shape) for b, d in zip(base, devices)]


def check_ring(shards: list, force_route=None) -> tuple:
    """One ``ring_gather`` of `shards` on `force_route`, against the plain
    version and ``torch.cat`` on each rank's device, bit for bit. Returns
    (ok, max |kernel - plain|, launches)."""
    before = ring_exchange.LAUNCHES
    outs = ring_exchange.ring_gather(shards, force_route=force_route)
    launches = ring_exchange.LAUNCHES - before
    _sync([s.device for s in shards])
    plain = ring_exchange.ring_gather_plain(shards)
    ok = all(o.device == s.device and torch.equal(o, p)
             and torch.equal(o, torch.cat([t.to(s.device) for t in shards]))
             for o, p, s in zip(outs, plain, shards))
    err = max(float((o.double() - p.double()).abs().max()) if o.numel() else 0.0
              for o, p in zip(outs, plain))
    return ok, err, launches


def ring_timing(shards: list, reps: int, label: str, card: str, log=_log) -> dict:
    """Kernel, plain-version and ``torch.cuda.comm.gather`` (to every rank's
    device) times of one all-gather of `shards`, beside the bound."""
    from torch.cuda import comm

    devs = [s.device for s in shards]
    nbytes = shards[0].numel() * shards[0].element_size()
    ms = device_ms(lambda: ring_exchange.ring_gather(shards), reps, devs)
    plain_ms = device_ms(lambda: ring_exchange.ring_gather_plain(shards), 5, devs)
    library_ms = device_ms(lambda: [comm.gather(shards, 0, destination=d)
                                   for d in devs], reps, devs)
    bound = ring_bound_ms(devs, nbytes)
    log(f"timing ring {label}: {len(shards)} ranks on {len(_cards(devs))} card(s), shard "
        f"{tuple(shards[0].shape)} {shards[0].dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.cuda.comm.gather x{len(shards)} {library_ms:.4f} ms, bound {bound:.4f} ms "
        f"({100 * bound / ms:.1f}% of it) (device time of back-to-back calls: CUDA events on "
        f"{devs[0]}, every other card's stream waiting on its start, it on theirs at the end) "
        f"[{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=library_ms)


def ring_across_cards(cards: list, card: str, log=_log) -> dict:
    """(d): the ring cases on 2 and 4 cards on both routes, the repeats and
    the times. Returns {"errs": [...], "timing": [entry per RING_TIMING]}."""
    g = torch.Generator(device=cards[0]).manual_seed(13)
    errs = []
    for c in (c for c in (2, 4) if c <= len(cards)):
        for num, shape, dtype, offset in RING_CASES:
            devs = spread(cards[:c], num)
            shards = ring_shards(devs, shape, dtype, offset, g)
            for route in ring_exchange.ROUTES:
                ok, err, launches = check_ring(shards, route)
                want = len(ring_exchange.launch_plan(devs, route))
                errs.append(err)
                label = (f"ring {num} ranks on {c} cards ({len(_cards(devs))} distinct) shard="
                         f"{shape} {dtype} offset={offset} route={route or 'default'}")
                log(f"{'PASS' if ok and launches == want else 'FAIL'}  {label}: bitwise vs "
                    f"plain and torch.cat, max|diff|={err}, launches {launches} (want {want})")
                if not ok or launches != want:
                    raise RuntimeError(f"(d) {label} fails")

    devs = spread(cards, 4)
    shards = ring_shards(devs, RING_TIMING[0], torch.float32, 0, g)
    fulls = [torch.cat([s.to(d) for s in shards]) for d in devs]
    bad = {d: torch.zeros((), dtype=torch.int64, device=d) for d in _cards(devs)}
    for _ in range(RING_REPEATS):
        for o, full in zip(ring_exchange.ring_gather(shards), fulls):
            bad[o.device] = bad[o.device] + (o != full).any()
    nbad = sum(int(b) for b in bad.values())
    log(f"(d) ring: {RING_REPEATS} back-to-back gathers of 4 ranks x {RING_TIMING[0]} on "
        f"{[str(d) for d in devs]}, no host read between them: {nbad} outputs differ")
    if nbad:
        raise RuntimeError(f"(d) ring: {nbad} outputs of {RING_REPEATS} repeats differ")
    timing = [ring_timing(ring_shards(devs, shape, torch.float32, 0, g), reps, f"4 x {shape}",
                          card, log)
              for shape, reps in zip(RING_TIMING, (50, 20))]
    return {"errs": errs, "timing": timing}


# ---------------------------------------------------------------- the tool


def scaling(cards: list, card: str, log=_log) -> list:
    """(e): the weak-scaling report of fast_config over the first 1, 2, 4
    cards, gated as the reference's."""
    sizes = [n for n in SIZES if n <= len(cards)]
    rows = sweep_scaling_report(fast_config(), sizes, device=cards[:sizes[-1]])
    log(format_scaling_table(rows))
    log(f"(e) scaling over {[str(d) for d in cards[:sizes[-1]]]}: ops by rank "
        f"{[r['ops_by_rank'] for r in rows]} [{card}]")
    for r in rows:
        if not (r["analytic_efficiency_pct"] >= 80.0 and 0 < r["collective_bytes"] < 4096
                and r["steps_per_s"] > 0):
            raise RuntimeError(f"(e) scaling: row {r} fails its gates")
    return rows


def run(cards: list, *, per_card: int = PER_CARD, num_frames: int = NUM_FRAMES,
        log=_log) -> dict:
    """(a)-(e) on `cards` (four at most are used), then (b) and (c)/(d)
    across processes last: their processes need the cards to themselves.
    Returns a summary: rates by layout and n, B3 launches in (c), (d)'s
    errors and times, the times and launches across processes, the scaling
    rows; raises where a gate fails."""
    cards = list(cards)[:max(SIZES)]
    card = card_line(cards[0].index)
    cfg = fast_config()
    t0 = time.perf_counter()
    runs = driving_runs(range(per_card * len(cards)), num_frames, cfg, cards[0])
    _sync(cards)
    log(f"(a) rendered {len(runs)} sequences x {num_frames} frames at {cfg.camera.height}x"
        f"{cfg.camera.width} on {cards[0]} in {time.perf_counter() - t0:.3f} s")
    band0 = disparity_band.LAUNCHES
    timed, stores = one_process(cards, runs, cfg, per_card, log)
    if disparity_band.LAUNCHES == band0:
        raise RuntimeError("(a) the sweep launched no band kernel")
    del runs
    ring_c, _ = windows_and_ba(cards, stores, cfg, log)
    ring_d = ring_across_cards(cards, card, log)
    rows = scaling(cards, card, log)
    rates_b = per_process_layout(timed, per_card, num_frames, log)
    across = across_processes(cards, stores, cfg, card, log)
    summary = {
        "cards": [str(d) for d in cards], "card": card,
        "one_process_rate": {n: r["rate"] for n, r in timed.items()},
        "one_process_peak_gib": {n: r["peak_gib"] for n, r in timed.items()},
        "per_process_rate": rates_b, "ring_launches_c": ring_c,
        "ring_timing": ring_d["timing"], "ring_max_err": max(ring_d["errs"]),
        "across_processes": across,
        "scaling": [{k: r[k] for k in r if k != "ops_by_rank"} for r in rows],
        "seconds": time.perf_counter() - t0,
    }
    log(json.dumps({"multichip": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    ap.add_argument("--rehearse", action="store_true",
                    help="with one card visible, run on virtual ranks of it")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "OUT"),
                    help="(internal) one process of the per-process layout")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--config", default="fast", choices=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--card", type=int, default=0, help="(internal) the worker's card")
    ap.add_argument("--job", help="(internal) the worker's parts across processes (torch.save)")
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, port, out = args.worker
        job = torch.load(args.job, weights_only=False) if args.job else None
        return worker(int(rank), int(world), int(port), out,
                      [int(s) for s in args.seeds.split(",") if s], args.frames,
                      config=args.config, device=args.device, card=args.card, job=job)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2 and not (args.rehearse and count == 1):
        print(f"multichip: needs 2 CUDA cards or more, {count} visible", file=sys.stderr)
        return 1
    for k in range(count):
        print(f"card {k}: {card_line(k)}", flush=True)
    print(f"cards: {count}", flush=True)
    cards = ([torch.device("cuda", k) for k in range(count)] if count > 1
             else [torch.device("cuda", 0)] * max(SIZES))
    run(cards, num_frames=args.frames)
    print("MULTICHIP OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
