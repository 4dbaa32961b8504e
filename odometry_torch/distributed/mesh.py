"""Meshes of ranks for multi-sequence and sharded runs (port of
``distributed/mesh.py``).

A :class:`Mesh` is a numpy array of ``torch.device`` s shaped by its axis
names, ``("seq",)`` or ``("seq", "model")``: one entry per rank. The ranks
may be *virtual*: ``sequence_mesh(3)`` puts three ranks on one card, each
with its own tensors, as the reference's tests put eight virtual devices on
one CPU. Every rank's tensors live on its rank's device.

``torch.distributed.DeviceMesh`` is not used: it needs a process group per
rank, and one card runs one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odometry_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes: ``devices[i, j]`` is rank (i, j)'s device."""

    devices: np.ndarray  # object array of torch.device
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} do not match "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: number of ranks along it}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices of the ranks along `axis`, at index 0 of every other
        axis (the ranks that a collective over `axis` spans)."""
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return list(self.devices[idx])


def _device_list(device, n: int) -> list:
    """`n` rank devices: `device` repeated (virtual ranks on one device), or
    the first `n` of a list of devices."""
    if isinstance(device, (list, tuple)):
        if len(device) < n:
            raise ValueError(f"{n} ranks asked of {len(device)} devices")
        devs = [resolve_device(d) for d in device[:n]]
    else:
        devs = [resolve_device(device)] * n
    # "cuda" means the current card: name it, so that it compares equal to
    # the device of a tensor made there.
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def _array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def sequence_mesh(n: int | None = None, device="cuda") -> Mesh:
    """1-D mesh of `n` ranks along "seq" (one sequence per rank).

    `device` is one device, on which all `n` ranks live, or a list of
    devices, one per rank (`n` defaults to its length).
    """
    if n is None:
        if not isinstance(device, (list, tuple)):
            raise ValueError("sequence_mesh: give n, or a list of devices")
        n = len(device)
    return Mesh(_array(_device_list(device, n), (n,)), ("seq",))


def grid_mesh(seq: int, model: int, device="cuda") -> Mesh:
    """2-D mesh: `seq` sequence ranks x `model` ranks that split BA's point
    lanes. `device` as for :func:`sequence_mesh` (row-major over the grid)."""
    return Mesh(_array(_device_list(device, seq * model), (seq, model)), ("seq", "model"))
