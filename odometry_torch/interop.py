"""Carry states and problems across packages.

The reference's ``OdometryState`` and the port's have the same fields, and
their nested ``KeyframeLevel`` / ``PointSet`` tuples the same field order; so
do ``BAProblem`` and ``KeyframeStore``. A reference value pulled to numpy
leaves (``jax.tree_util.tree_map(np.asarray, x)``, done by the caller)
converts to the port's type on a device, and back to numpy leaves in the
port's own types. A batched reference state (the sweep's, with a leading
sequence axis) becomes one port state per sequence, each on its rank's
device.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from odometry_torch.device import resolve_device
from odometry_torch.distributed.mesh import Mesh
from odometry_torch.distributed.sweep import sequence_devices
from odometry_torch.kernels.points import PointSet
from odometry_torch.mapping.ba import BAProblem
from odometry_torch.mapping.keyframe import KeyframeStore
from odometry_torch.pipeline.odometry import OdometryState
from odometry_torch.tracking.tracker import KeyframeLevel

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected state dtype {a.dtype}")
    # np.array, not np.ascontiguousarray: the latter turns 0-d scalars 1-d.
    return torch.as_tensor(np.array(a), dtype=_DTYPES[a.dtype], device=dev)


def state_from_numpy(tree, device) -> OdometryState:
    """Reference ``OdometryState`` with numpy leaves -> the port's state on `device`."""
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
    sequence axis) -> one port state per sequence, sequence s on its rank's
    device of `mesh`'s "seq" axis."""
    num_seqs = np.asarray(tree.frame_id).shape[0]
    out = []
    for s, dev in enumerate(sequence_devices(num_seqs, mesh)):
        one = {f.name: getattr(tree, f.name) for f in dataclasses.fields(OdometryState)}
        one = {k: (tuple(a[s] for a in v) if isinstance(v, (tuple, list)) else v[s])
               for k, v in one.items() if k != "kf_track"}
        one["kf_track"] = tuple(
            types.SimpleNamespace(pts=tuple(a[s] for a in lvl.pts), intensity=lvl.intensity[s])
            for lvl in tree.kf_track)
        out.append(state_from_numpy(types.SimpleNamespace(**one), dev))
    return out


def states_to_batched_numpy(states: list) -> OdometryState:
    """Port states of a sweep -> one state with numpy leaves stacked on a
    leading sequence axis (the reference's batched layout)."""
    per_seq = [state_to_numpy(s) for s in states]
    stack = lambda *leaves: np.stack(leaves)
    kf_track = tuple(
        KeyframeLevel(PointSet(*map(stack, *(lv.pts for lv in lvls))),
                      stack(*(lv.intensity for lv in lvls)))
        for lvls in zip(*(s.kf_track for s in per_seq)))
    fields = {}
    for f in dataclasses.fields(OdometryState):
        if f.name == "kf_track":
            continue
        vals = [getattr(s, f.name) for s in per_seq]
        fields[f.name] = (tuple(map(stack, *vals)) if isinstance(vals[0], tuple)
                          else stack(*vals))
    return OdometryState(kf_track=kf_track, **fields)


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
