"""Carry states and problems across packages.

The reference's ``OdometryState`` and the port's have the same fields, and
their nested ``KeyframeLevel`` / ``PointSet`` tuples the same field order; so
do ``BAProblem`` and ``KeyframeStore``. A reference value pulled to numpy
leaves (``jax.tree_util.tree_map(np.asarray, x)``, done by the caller)
converts to the port's type on a device, and back to numpy leaves in the
port's own types. A batched reference state (the sweep's, with a leading
sequence axis) becomes one batched port state per rank of the mesh, its
sequences' lanes on its device, as ``shard_map`` shards the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odometry_torch.device import resolve_device
from odometry_torch.distributed.mesh import Mesh
from odometry_torch.kernels.points import PointSet
from odometry_torch.mapping.ba import BAProblem
from odometry_torch.mapping.keyframe import KeyframeStore
from odometry_torch.pipeline.odometry import OdometryState
from odometry_torch.tracking.tracker import KeyframeLevel
from odometry_torch.utils.batch import tree_map

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected state dtype {a.dtype}")
    # np.array, not np.ascontiguousarray: the latter turns 0-d scalars 1-d.
    return torch.as_tensor(np.array(a), dtype=_DTYPES[a.dtype], device=dev)


def state_from_numpy(tree, device) -> OdometryState:
    """Reference ``OdometryState`` with numpy leaves -> the port's state on
    `device` (a batched one stays batched)."""
    dev = resolve_device(device)
    t = lambda a: _to_tensor(a, dev)
    kf_track = tuple(
        KeyframeLevel(PointSet(*(t(a) for a in lvl.pts)), t(lvl.intensity))
        for lvl in tree.kf_track
    )
    fields = {f.name: getattr(tree, f.name) for f in dataclasses.fields(OdometryState)}
    fields = {k: (tuple(t(a) for a in v) if isinstance(v, (tuple, list)) else t(v))
              for k, v in fields.items() if k != "kf_track"}
    return OdometryState(kf_track=kf_track, **fields)


def state_to_numpy(state: OdometryState) -> OdometryState:
    """The port's state -> the same structure with numpy leaves."""
    n = lambda x: x.detach().cpu().numpy()
    kf_track = tuple(
        KeyframeLevel(PointSet(*(n(a) for a in lvl.pts)), n(lvl.intensity))
        for lvl in state.kf_track
    )
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(OdometryState)}
    fields = {k: (tuple(n(a) for a in v) if isinstance(v, tuple) else n(v))
              for k, v in fields.items() if k != "kf_track"}
    return OdometryState(kf_track=kf_track, **fields)


def states_from_batched_numpy(tree, mesh: Mesh) -> list:
    """Reference batched ``OdometryState`` (numpy leaves with a leading
    sequence axis) -> one batched port state per rank of `mesh`'s "seq"
    axis, sequences [k S/n, (k+1) S/n) on rank k's device."""
    state = state_from_numpy(tree, "cpu")
    devs = mesh.axis_devices("seq")
    num_seqs = int(state.frame_id.shape[0])
    if num_seqs % len(devs) != 0:
        raise ValueError(f"{num_seqs} sequences not divisible by the {len(devs)} ranks of "
                         "'seq'")
    per = num_seqs // len(devs)
    return [tree_map(lambda t: t[k * per:(k + 1) * per].to(d), state)
            for k, d in enumerate(devs)]


def states_to_batched_numpy(states: list) -> OdometryState:
    """The per-rank batched states of a sweep -> one state with numpy leaves
    on a leading sequence axis (the reference's batched layout)."""
    return tree_map(lambda *leaves: np.concatenate(leaves),
                    *(state_to_numpy(s) for s in states))


def ba_problem_from_numpy(tree, device) -> BAProblem:
    """Reference ``BAProblem`` with numpy leaves -> the port's on `device`."""
    dev = resolve_device(device)
    return BAProblem(*(_to_tensor(a, dev) for a in tree))


def store_from_numpy(tree, device) -> KeyframeStore:
    """Reference ``KeyframeStore`` with numpy leaves -> the port's on `device`."""
    dev = resolve_device(device)
    return KeyframeStore(**{f.name: _to_tensor(getattr(tree, f.name), dev)
                            for f in dataclasses.fields(KeyframeStore)})


def store_to_numpy(store: KeyframeStore) -> KeyframeStore:
    """The port's store -> the same structure with numpy leaves."""
    return KeyframeStore(**{f.name: getattr(store, f.name).detach().cpu().numpy()
                            for f in dataclasses.fields(KeyframeStore)})
