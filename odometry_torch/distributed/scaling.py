"""Multi-process initialization and per-rank inputs for the sweep (port of
part of ``distributed/scaling.py``).

:func:`initialize_multihost` joins a ``torch.distributed`` process group, so
that the sweep's health count (``distributed/sweep.py``) is reduced across
processes; :func:`stack_local_frames` puts each of this process's sequences
on its rank's device. The reference's ``sweep_scaling_report``,
``format_scaling_table`` and ``_collective_bytes`` read XLA's cost analysis
and compiled HLO, which have no counterpart here (ROADMAP A13).
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

from odometry_torch.device import resolve_device
from odometry_torch.distributed.mesh import Mesh
from odometry_torch.distributed.sweep import sequence_devices


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
