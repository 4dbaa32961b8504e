"""Multi-sequence odometry over a mesh (port of ``distributed/sweep.py``).

One or more sequences per rank along the mesh's "seq" axis: S sequences on n
ranks, sequences [k S/n, (k+1) S/n) on rank k, as ``shard_map`` splits the
reference's batch axis. A batch of states is a list of per-sequence
``OdometryState`` s, each on its rank's device. The port's ``step`` makes
host reads inside its LM loops, so it cannot be ``vmap``-ped: each rank steps
its own sequences in turn.

Health is reduced as the reference's ``psum``: ``global_ok`` is True iff
every sequence on every rank had a healthy depth frame. When a
``torch.distributed`` process group is initialized
(:func:`odometry_torch.distributed.scaling.initialize_multihost`), the
counts also go through an ``all_reduce`` (SUM) over the group, the
multi-process psum of a mesh that spans hosts.

The reference's ``step_fn_for_mesh`` (the jitted step, cached for the
scaling harness to compile) has no counterpart: nothing is compiled here.

``COLLECTIVE_BYTES`` counts the bytes the health reduction moves, where it
runs (``distributed/scaling.py:sweep_scaling_report`` reads it): 4 for
each sequence's ok count taken to rank 0 from another rank, 8 for the
reduced pair (the ok count and the number of sequences, as the reference's
two int32 ``psum`` s), and 8 more for the ``all_reduce`` of that pair when a
process group exists.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from odometry_torch.config import PipelineConfig
from odometry_torch.distributed.mesh import Mesh, sequence_mesh
from odometry_torch.pipeline.odometry import init, step


def sequence_devices(num_seqs: int, mesh: Mesh) -> list:
    """Device of each sequence: S sequences split in order over the "seq"
    ranks (S must be divisible by their number)."""
    devs = mesh.axis_devices("seq")
    if num_seqs % len(devs) != 0:
        raise ValueError(f"{num_seqs} sequences not divisible by the {len(devs)} ranks of "
                         "'seq'")
    per_rank = num_seqs // len(devs)
    return [devs[s // per_rank] for s in range(num_seqs)]


# Bytes moved by _global_ok since the last reset (see the module docstring).
COLLECTIVE_BYTES = 0


def _global_ok(ok: list, mesh: Mesh) -> torch.Tensor:
    """(sum of `ok` over sequences, in order, on rank 0's device) == number
    of sequences, over the process group too when one is initialized."""
    global COLLECTIVE_BYTES
    devs = sequence_devices(len(ok), mesh)
    per_rank = len(ok) // len(mesh.axis_devices("seq"))
    total_ok = ok[0].to(torch.int32)
    for o in ok[1:]:
        total_ok = total_ok + o.to(devs[0], torch.int32)
    counts = torch.stack([total_ok, torch.tensor(len(ok), dtype=torch.int32, device=devs[0])])
    COLLECTIVE_BYTES += 4 * (len(ok) - per_rank) + counts.numel() * counts.element_size()
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(counts, op=dist.ReduceOp.SUM)
        COLLECTIVE_BYTES += counts.numel() * counts.element_size()
    return counts[0] == counts[1]


def batched_init(left_b, right_b, cfg: PipelineConfig, mesh: Mesh) -> list:
    """Initialize a batch of sequences from their first frames (S, H, W) or
    lists of (H, W), sequence s on its rank's device; returns the states."""
    devs = sequence_devices(len(left_b), mesh)
    return [init(left, right, cfg, device=d)[0] for left, right, d in zip(left_b, right_b, devs)]


def batched_step(states: list, left_b, right_b, cfg: PipelineConfig, mesh: Mesh):
    """One odometry step of every sequence; returns (states, outs, global_ok).

    Each rank steps its own sequences in turn, their frames moved to its
    device. global_ok: True iff every sequence's depth frame is healthy.
    """
    devs = sequence_devices(len(states), mesh)
    to_dev = lambda a, d: torch.as_tensor(a, dtype=torch.float32).to(d)
    new_states, outs = [], []
    for state, left, right, d in zip(states, left_b, right_b, devs):
        s, out = step(state, to_dev(left, d), to_dev(right, d), cfg)
        new_states.append(s)
        outs.append(out)
    return new_states, outs, _global_ok([o.depth_ok for o in outs], mesh)


def run_sweep(frames_per_seq, cfg: PipelineConfig, mesh: Mesh | None = None, *,
              device="cuda",
              progress: Callable[[int, list, list | None, torch.Tensor], None] | None = None
              ) -> np.ndarray:
    """Run every sequence of `frames_per_seq` (lists of (left, right) pairs
    of equal length) over `mesh`, by default ``sequence_mesh(S, device)``:
    one sequence per rank, all on `device`.

    `progress(frame_id, states, outs, global_ok)` is called after init
    (frame 0, outs None, global_ok over the init depth) and after every
    step. Returns the poses (num_seqs, num_frames, 4, 4).
    """
    num_seqs = len(frames_per_seq)
    num_frames = len(frames_per_seq[0])
    if any(len(f) != num_frames for f in frames_per_seq):
        raise ValueError("run_sweep: sequences of different lengths")
    if mesh is None:
        mesh = sequence_mesh(num_seqs, device)
    frame = lambda i, k: [f[i][k] for f in frames_per_seq]
    states = batched_init(frame(0, 0), frame(0, 1), cfg, mesh)
    if progress is not None:
        progress(0, states, None, _global_ok([s.healthy for s in states], mesh))
    poses = [[s.cur_pose for s in states]]
    for i in range(1, num_frames):
        states, outs, global_ok = batched_step(states, frame(i, 0), frame(i, 1), cfg, mesh)
        poses.append([o.cur_pose for o in outs])
        if progress is not None:
            progress(i, states, outs, global_ok)
    return np.stack([[p.cpu().numpy() for p in per_frame] for per_frame in poses], axis=1)

