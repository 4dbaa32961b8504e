"""Meshes of ranks for multi-sequence and sharded runs (port of
``distributed/mesh.py``).

A :class:`Mesh` is a numpy array of ``torch.device`` s shaped by its axis
names, ``("seq",)`` or ``("seq", "model")``: one entry per rank. Every
rank's tensors live on its rank's device.

``device="cuda"`` (no index) means every visible card, as the reference's
``jax.devices()``: ``sequence_mesh()`` has one rank per card, and
``sequence_mesh(n)`` / ``grid_mesh(seq, model)`` take the first n (seq *
model) cards. Ranks beyond the cards are *virtual*, spread in order: rank
k of n goes on card k * c // n of c, so on one card ``sequence_mesh(3)``
puts three ranks on it, each with its own tensors, as the reference's tests
put eight virtual devices on one CPU. One device with an index
(``"cuda:1"``) or the CPU holds every rank; a list names each rank's device.

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


def _device_list(device, n: int | None) -> list:
    """The rank devices of a mesh of `n` ranks (None: one per device meant):
    the first `n` of a list; every visible card for "cuda" without an index,
    spread in order when `n` exceeds them; else `device` repeated."""
    if isinstance(device, (list, tuple)):
        n = len(device) if n is None else n
        if len(device) < n:
            raise ValueError(f"{n} ranks asked of {len(device)} devices")
        # "cuda" in a list is the current card: name it, so that it compares
        # equal to the device of a tensor made there.
        return [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in map(resolve_device, device[:n])]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        return spread(cards, len(cards) if n is None else n)
    return [dev] * (1 if n is None else n)


def spread(devices: list, n: int) -> list:
    """The devices of `n` ranks over `devices` (c of them): the first n
    when n <= c, else rank k on devices[k * c // n], each device's ranks
    contiguous and in order."""
    c = len(devices)
    return [devices[k * c // n if n > c else k] for k in range(n)]


def _array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def sequence_mesh(n: int | None = None, device="cuda") -> Mesh:
    """1-D mesh of `n` ranks along "seq"; S sequences split over them in order.

    Without `n`, one rank per device meant, as the reference's
    ``sequence_mesh()`` takes every device: one per visible card for
    "cuda", one for a single device (which then steps all S sequences as
    one batch), ``len(device)`` for a list. See the module docstring for
    where the ranks go.
    """
    devs = _device_list(device, n)
    return Mesh(_array(devs, (len(devs),)), ("seq",))


def grid_mesh(seq: int, model: int, device="cuda") -> Mesh:
    """2-D mesh: `seq` sequence ranks x `model` ranks that split BA's point
    lanes, row-major over the devices of :func:`sequence_mesh`'s rule (the
    first seq * model cards for "cuda")."""
    return Mesh(_array(_device_list(device, seq * model), (seq, model)), ("seq", "model"))
