"""Multi-process initialization, per-rank inputs and the weak-scaling report
of the sweep (port of ``distributed/scaling.py``).

:func:`initialize_multihost` joins a ``torch.distributed`` process group, so
that the sweep's health count (``distributed/sweep.py``) is reduced across
processes; :func:`stack_local_frames` puts each of this process's sequences
on its rank's device.

:func:`sweep_scaling_report` measures the sweep step at mesh sizes 1..N in
two views, as the reference's does:

- **analytic**: the work of each rank and the bytes of the step's health
  reduction. The reference reads XLA's cost analysis (FLOPs) and the
  compiled HLO's collectives; nothing is compiled here, so the port counts
  what it dispatches: every device operation of a rank's steps (a
  ``TorchDispatchMode`` counter, plus the hand-written kernels' ``LAUNCHES``)
  and ``sweep.COLLECTIVE_BYTES``. Data parallelism over sequences must keep
  the busiest rank's work at the work of one rank alone, and the reduction
  at a few bytes whatever the frame size.
- **wall-clock**: sequence-steps/s at each mesh size and its efficiency
  against size 1. The virtual ranks of one card step in turn
  (``sweep.batched_step``), so on one card it reads about 100/n %; across
  ranks on separate cards it is the weak-scaling number itself.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from odometry_torch.config import PipelineConfig
from odometry_torch.device import resolve_device
from odometry_torch.distributed import ring_exchange, sweep
from odometry_torch.distributed.mesh import Mesh, sequence_mesh
from odometry_torch.distributed.sweep import sequence_devices
from odometry_torch.kernels import disparity_band, disparity_full


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None, *,
                         device="cuda") -> bool:
    """Initialize ``torch.distributed`` for a multi-process run.

    Arguments fall back to the standard environment variables:
    ``MASTER_ADDR``:``MASTER_PORT`` for `coordinator_address` ("host:port"),
    ``WORLD_SIZE`` and ``RANK``. The backend is ``nccl`` when `device` is a
    card and ``gloo`` on the CPU. Returns True when a process group was
    initialized, False for the single-process no-op (so every entry point can call
    it unconditionally).
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False  # one process: nothing to do
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: a multi-process run needs the coordinator "
                         "address, the number of processes and this process's id")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def stack_local_frames(frames: Sequence, mesh: Mesh) -> tuple[list, list]:
    """This process's (left, right) pair of each sequence -> (lefts, rights),
    lists of (H, W) float32 tensors, sequence s on the device of its rank of
    the "seq" axis (``sweep.sequence_devices``)."""
    devs = sequence_devices(len(frames), mesh)
    t = lambda a, d: torch.as_tensor(a, dtype=torch.float32).to(d)
    return ([t(left, d) for (left, _), d in zip(frames, devs)],
            [t(right, d) for (_, right), d in zip(frames, devs)])


class _OpCounter(TorchDispatchMode):
    """Counts the operators dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _launches() -> int:
    return disparity_band.LAUNCHES + disparity_full.LAUNCHES + ring_exchange.LAUNCHES


def _rank_work(states, lefts, rights, cfg: PipelineConfig, mesh: Mesh):
    """One sweep step as ``sweep.batched_step`` runs it (each sequence's
    ``step`` in turn, then the health reduction on rank 0), counted: returns
    ([device operations + kernel launches of each rank], bytes the health
    reduction moved)."""
    n_ranks = len(mesh.axis_devices("seq"))
    per_rank = len(states) // n_ranks
    work = [0] * n_ranks
    counter = _OpCounter()
    bytes0 = sweep.COLLECTIVE_BYTES
    with counter:
        outs = []
        for s, (state, left, right) in enumerate(zip(states, lefts, rights)):
            before = counter.ops + _launches()
            outs.append(sweep.step(state, left, right, cfg)[1])
            work[s // per_rank] += counter.ops + _launches() - before
        before = counter.ops + _launches()
        sweep._global_ok([o.depth_ok for o in outs], mesh)
        work[0] += counter.ops + _launches() - before
    return work, sweep.COLLECTIVE_BYTES - bytes0


def sweep_scaling_report(cfg: PipelineConfig, mesh_sizes: Sequence[int], *, reps: int = 3,
                         timed: bool | None = None, device="cuda") -> list[dict]:
    """Measure the sweep step at each mesh size on `device` (n virtual ranks
    of it; the card unless the caller asks for the CPU); one dict per size.

    At each n: scenes ``make_scene(s, depth=14.0)`` for s < n rendered at the
    identity pose, ``stack_local_frames``, ``batched_init``, one counted step
    (the analytic view), then one warm and `reps` timed ``batched_step`` s
    from the initial states.

    Keys: n, ops_by_rank (each rank's device operations and kernel launches
    in one step), ops_per_device (the busiest rank's), collective_bytes,
    analytic_efficiency_pct (100 x the work at n = 1 over ops_per_device),
    and when `timed` (default: on a card, not on the CPU, where ranks share
    the host's cores) steps_per_s (sequences advanced per second) and
    wall_efficiency_pct.
    """
    from odometry_torch.camera.pinhole import Pinhole
    from odometry_torch.data.synthetic import make_scene, render_stereo

    dev = resolve_device(device)
    if timed is None:
        timed = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    rows: list[dict] = []
    base_work = base_rate = None
    for n in mesh_sizes:
        mesh = sequence_mesh(n, dev)
        frames = [render_stereo(make_scene(s, depth=14.0, device=dev), cam, c.baseline,
                                torch.eye(4), c.height, c.width)[:2] for s in range(n)]
        lefts, rights = stack_local_frames(frames, mesh)
        states = sweep.batched_init(lefts, rights, cfg, mesh)
        work, cbytes = _rank_work(states, lefts, rights, cfg, mesh)
        if base_work is None:
            base_work = work[0]
        row = {
            "n": n,
            "ops_by_rank": work,
            "ops_per_device": max(work),
            "collective_bytes": cbytes,
            "analytic_efficiency_pct": round(100.0 * base_work / max(work), 1),
        }
        if timed:
            sweep.batched_step(states, lefts, rights, cfg, mesh)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                sweep.batched_step(states, lefts, rights, cfg, mesh)
            sync()
            dt = (time.perf_counter() - t0) / reps
            rate = n / dt  # sequences advanced per second
            if base_rate is None:
                base_rate = rate
            row["steps_per_s"] = round(rate, 2)
            row["wall_efficiency_pct"] = round(100.0 * rate / (base_rate * n), 1)
        rows.append(row)
    return rows


def format_scaling_table(rows: list[dict]) -> str:
    """The reference's table layout over the port's columns."""
    cols = ["n", "ops_per_device", "collective_bytes",
            "analytic_efficiency_pct", "steps_per_s", "wall_efficiency_pct"]
    present = [c for c in cols if any(c in r for r in rows)]
    lines = ["  ".join(f"{c:>24s}" for c in present)]
    for r in rows:
        lines.append("  ".join(f"{str(r.get(c, '-')):>24s}" for c in present))
    return "\n".join(lines)
