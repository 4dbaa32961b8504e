"""Carry an odometry state across packages.

The reference's ``OdometryState`` and the port's have the same fields, and
their nested ``KeyframeLevel`` / ``PointSet`` tuples the same field order. A
reference state pulled to numpy leaves (``jax.tree_util.tree_map(np.asarray,
state)``, done by the caller) converts to the port's state on a device, and
back to numpy leaves in the port's own types.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odometry_torch.device import resolve_device
from odometry_torch.kernels.points import PointSet
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
