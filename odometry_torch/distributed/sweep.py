"""Multi-sequence odometry over a mesh (port of ``distributed/sweep.py``).

One or more sequences per rank along the mesh's "seq" axis: S sequences on n
ranks, sequences [k S/n, (k+1) S/n) on rank k, as ``shard_map`` splits the
reference's batch axis. Each rank holds its sequences as ONE batched
``OdometryState`` (every tensor leading with its S/n sequences, on its
device), as the reference's shard of its batched state, and steps them
together with ``pipeline.odometry.step_batch``, the counterpart of the
reference's ``jax.vmap(step)``: one stream of launches per rank and step,
one SSD kernel launch per batched depth run, one host read per LM iteration
for the whole batch. A batch of states is the list of the ranks' states;
:func:`sequence_view` gives one sequence's view of it.

Health is reduced as the reference's ``psum``: each rank counts its healthy
sequences, the counts are summed on the process's first rank, and
``global_ok`` is True iff every sequence on every rank had a healthy depth
frame. On a mesh that spans processes (built after
:func:`odometry_torch.distributed.scaling.initialize_multihost`) the pair is
then reduced once over the group (``all_reduce``, SUM), the multi-process
psum: over NCCL on the card where every process owns its own cards, over
gloo on the host otherwise.

Over such a mesh every process calls :func:`batched_init`,
:func:`batched_step` and :func:`run_sweep` with its own sequences, which
split over its own ranks of "seq" (:meth:`Mesh.local_ranks`), as the
reference's ``stack_local_frames`` gives each process its shard of the
global batch; each process gets its own sequences' states and poses back.

The reference's ``step_fn_for_mesh`` (the jitted step, cached for the
scaling harness to compile) has no counterpart: nothing is compiled here.

``COLLECTIVE_BYTES`` counts the bytes the health reduction moves, where it
runs (``distributed/scaling.py:sweep_scaling_report`` reads it): 4 for
each of this process's ranks' ok count taken to its first rank from
another rank, 8 for the reduced pair (the ok count and the number of
sequences, as the reference's two int32 ``psum`` s), and on a mesh across
P processes 8 (P - 1) more: the other processes' pairs that the
``all_reduce`` brings into this one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from odometry_torch.config import PipelineConfig
from odometry_torch.distributed.mesh import Mesh, sequence_mesh, world
from odometry_torch.pipeline.odometry import init_batch, step_batch
from odometry_torch.utils.batch import batch_size, lane


def sequence_devices(num_seqs: int, mesh: Mesh) -> list:
    """Device of each of this process's sequences: its `num_seqs`
    sequences split in order over its ranks of "seq" (every rank's on a
    mesh of this process; the number must split evenly)."""
    mesh.require_every_process("seq")
    devs = mesh.local_axis_devices("seq")
    if num_seqs % len(devs) != 0:
        raise ValueError(f"{num_seqs} sequences not divisible by the {len(devs)} ranks of "
                         "'seq'" + ("" if mesh.processes is None else " of this process"))
    per_rank = num_seqs // len(devs)
    return [devs[s // per_rank] for s in range(num_seqs)]


# Bytes moved by _global_ok since the last reset (see the module docstring).
COLLECTIVE_BYTES = 0


def _global_ok(ok: list, mesh: Mesh) -> torch.Tensor:
    """`ok`: each of this process's ranks' (b,) health flags, on its
    device. (Sum of each rank's count, in rank order, on the first rank's
    device, reduced over the group when the mesh spans processes) ==
    number of sequences."""
    global COLLECTIVE_BYTES
    dev0 = mesh.local_axis_devices("seq")[0]
    counts = [torch.sum(o, dtype=torch.int32) for o in ok]
    total_ok = counts[0]
    for c in counts[1:]:
        total_ok = total_ok + c.to(dev0)
    num = sum(o.numel() for o in ok)
    pair = torch.stack([total_ok, torch.tensor(num, dtype=torch.int32, device=dev0)])
    COLLECTIVE_BYTES += 4 * (len(ok) - 1) + pair.numel() * pair.element_size()
    w = world() if mesh.processes is not None else None
    if w is not None:
        if w.backend == "nccl":
            dist.all_reduce(pair, op=dist.ReduceOp.SUM, group=w.device_group)
        else:  # gloo reduces on the host
            host = pair.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            pair = host.to(dev0)
        COLLECTIVE_BYTES += pair.numel() * pair.element_size() * (w.size - 1)
    return pair[0] == pair[1]


def rank_frames(frames, mesh: Mesh) -> list:
    """Frames of this process's S sequences ((S, H, W), or S (H, W) arrays
    or tensors) -> one (S/n, H, W) float32 tensor per rank of its n ranks,
    on the rank's device."""
    devs = sequence_devices(len(frames), mesh)
    t = lambda a, d: torch.as_tensor(a, dtype=torch.float32).to(d)
    per = len(frames) // len(mesh.local_axis_devices("seq"))
    return [torch.stack([t(a, devs[k]) for a in frames[k:k + per]])
            for k in range(0, len(frames), per)]


def sequence_view(per_rank: list, s: int):
    """Sequence `s`'s unbatched view (tensors of lane s % b) of a sweep's
    per-rank batched states or step outputs, b sequences per rank."""
    per = batch_size(per_rank[0])
    return lane(per_rank[s // per], s % per)


def batched_init(left_b, right_b, cfg: PipelineConfig, mesh: Mesh) -> list:
    """Initialize a batch of sequences from their first frames (S, H, W) or
    lists of (H, W), this process's: one batched state per rank of this
    process, on its device, from one ``init_batch`` of its sequences."""
    return [init_batch(left, right, cfg, device=left.device)[0]
            for left, right in zip(rank_frames(left_b, mesh), rank_frames(right_b, mesh))]


def batched_step(states: list, left_b, right_b, cfg: PipelineConfig, mesh: Mesh):
    """One odometry step of every sequence; returns (states, outs,
    global_ok), states and outs one batched state and ``StepOutput`` per
    rank of this process.

    Each rank steps all of its sequences with one ``step_batch``, their
    frames moved to its device. global_ok: True iff every sequence's depth
    frame is healthy, on every rank of every process.
    """
    new_states, outs = [], []
    for state, left, right in zip(states, rank_frames(left_b, mesh),
                                  rank_frames(right_b, mesh)):
        s, out = step_batch(state, left, right, cfg)
        new_states.append(s)
        outs.append(out)
    return new_states, outs, _global_ok([o.depth_ok for o in outs], mesh)


def run_sweep(frames_per_seq, cfg: PipelineConfig, mesh: Mesh | None = None, *,
              device="cuda",
              progress: Callable[[int, list, list | None, torch.Tensor], None] | None = None
              ) -> np.ndarray:
    """Run every sequence of `frames_per_seq` (lists of (left, right) pairs
    of equal length) over `mesh`, by default ``sequence_mesh(None, device)``:
    one rank per device, so on one device all S sequences step as one batch,
    as the reference's ``vmap`` over its one device does.
    ``sequence_mesh(S, device)`` steps them in turn, one sequence per rank.

    Over a mesh that spans processes (after ``initialize_multihost``, the
    default for "cuda"), every process calls it with its own sequences,
    which its own ranks step, and gets its own sequences' poses back: the
    reference's global output is not addressable from one process either.

    `progress(frame_id, states, outs, global_ok)` is called after init
    (frame 0, outs None, global_ok over the init depth) and after every
    step, with the per-rank lists (:func:`sequence_view` takes one
    sequence's). Returns the poses (num_seqs, num_frames, 4, 4) of this
    process's sequences.
    """
    num_seqs = len(frames_per_seq)
    num_frames = len(frames_per_seq[0])
    if any(len(f) != num_frames for f in frames_per_seq):
        raise ValueError("run_sweep: sequences of different lengths")
    if mesh is None:
        mesh = sequence_mesh(None, device)
    frame = lambda i, k: [f[i][k] for f in frames_per_seq]
    states = batched_init(frame(0, 0), frame(0, 1), cfg, mesh)
    if progress is not None or mesh.processes is not None:  # a collective across processes
        ok = _global_ok([s.healthy for s in states], mesh)
        if progress is not None:
            progress(0, states, None, ok)
    poses = [[s.cur_pose for s in states]]
    for i in range(1, num_frames):
        states, outs, global_ok = batched_step(states, frame(i, 0), frame(i, 1), cfg, mesh)
        poses.append([o.cur_pose for o in outs])
        if progress is not None:
            progress(i, states, outs, global_ok)
    return np.stack([np.concatenate([p.cpu().numpy() for p in per_frame])
                     for per_frame in poses], axis=1)
