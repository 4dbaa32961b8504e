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

**Across processes.** After
:func:`odometry_torch.distributed.scaling.initialize_multihost` the
:class:`World` lists every process's rank devices, as ``jax.devices()``
becomes the global device list in the reference. ``"cuda"`` or ``"cpu"``
without an index then means the world's ranks of that type, process-major
(process 0's in its order, then process 1's, ...: the order of a
multi-process ``jax.devices()``), with the rule above for n: the first n,
spread past them in order. Each rank of such a mesh carries (process,
device) (``Mesh.processes``); the device of another process's rank is that
process's name for it. A device with an index or a list still gives a mesh
of this process only. Every process of the group builds the same mesh and
calls the same mesh-level functions (the sweep, ``ba_solve_sharded``, the
ring), each acting on its own ranks (:meth:`Mesh.local_ranks`).

``torch.distributed.DeviceMesh`` is not used: it needs a process group per
rank, and one card runs one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from odometry_torch.device import resolve_device

# Seconds a process of a group waits for the others: the group's collectives
# and B3's host steps across processes (ring_exchange.Board).
GROUP_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class World:
    """The processes of a group, as ``initialize_multihost`` learned them."""

    process: int  # this process's index in the group
    hosts: tuple  # each process's host name
    devices: tuple  # each process's rank devices (tuples of torch.device)
    uuids: tuple  # each process's ranks' card uuids (None for a CPU rank)
    backend: str  # of device collectives: "nccl", or "gloo" (the default group)
    device_group: object = None  # the NCCL group; None: the default (gloo) group
    peers: object = None  # ring_exchange.Peers: what B3 across processes opened

    @property
    def size(self) -> int:
        return len(self.hosts)

    def ranks(self) -> list:
        """[(process, device)] of every rank, process-major."""
        return [(p, d) for p, devs in enumerate(self.devices) for d in devs]


_WORLD: World | None = None


def world() -> World | None:
    """The group's :class:`World` while a group is initialized, else None."""
    if _WORLD is not None and dist.is_available() and dist.is_initialized():
        return _WORLD
    return None


def set_world(w: World | None):
    global _WORLD
    _WORLD = w


def this_process() -> int:
    w = world()
    return 0 if w is None else w.process


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes: ``devices[i, j]`` is rank (i, j)'s
    device, and ``processes[i, j]`` its process (None: every rank is this
    process's). Ranks are numbered row-major (``devices.flat``)."""

    devices: np.ndarray  # object array of torch.device
    axis_names: tuple
    processes: np.ndarray | None = None  # int array of the devices' shape

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} do not match "
                             f"axes {self.axis_names}")
        if self.processes is not None and self.processes.shape != self.devices.shape:
            raise ValueError(f"processes of shape {self.processes.shape} do not match the "
                             f"devices' {self.devices.shape}")

    @property
    def shape(self) -> dict:
        """{axis name: number of ranks along it}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, rank: int) -> bool:
        """Whether rank `rank` (row-major) is this process's."""
        return self.processes is None or int(self.processes.flat[rank]) == this_process()

    def local_ranks(self) -> list:
        """This process's ranks (row-major numbers), in order."""
        return [r for r in range(self.size) if self.is_local(r)]

    def axis_ranks(self, axis: str) -> list:
        """The ranks (row-major numbers) along `axis`, at index 0 of every
        other axis: the ranks that a collective over `axis` spans."""
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return np.arange(self.size).reshape(self.devices.shape)[idx].tolist()

    def axis_devices(self, axis: str) -> list:
        """The devices of the ranks along `axis` (see :meth:`axis_ranks`)."""
        return [self.devices.flat[r] for r in self.axis_ranks(axis)]

    def local_axis_devices(self, axis: str) -> list:
        """The devices of this process's ranks along `axis`, in order."""
        return [self.devices.flat[r] for r in self.axis_ranks(axis) if self.is_local(r)]

    def axis_mesh(self, axis: str) -> "Mesh":
        """The 1-D mesh of the ranks along `axis` (:meth:`axis_ranks`)."""
        ranks = self.axis_ranks(axis)
        procs = None if self.processes is None else np.array(
            [int(self.processes.flat[r]) for r in ranks])
        return Mesh(_array([self.devices.flat[r] for r in ranks], (len(ranks),)), (axis,),
                    procs)

    def require_every_process(self, axis: str):
        """Raises, in every process alike, unless every process of the group
        owns a rank along `axis`: mesh-level collectives are called by every
        process. A mesh of this process alone passes."""
        w = world()
        if self.processes is None or w is None:
            return
        owners = {int(self.processes.flat[r]) for r in self.axis_ranks(axis)}
        if owners != set(range(w.size)):
            raise ValueError(f"the ranks of {axis!r} lie in processes {sorted(owners)} of the "
                             f"group's {w.size}: every process must own one")


def _device_list(device, n: int | None) -> list:
    """The rank devices of a mesh of this process of `n` ranks (None: one
    per device meant): the first `n` of a list; every visible card for
    "cuda" without an index, spread in order when `n` exceeds them; else
    `device` repeated."""
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


def _rank_list(device, n: int | None) -> tuple:
    """(devices, processes) of a mesh of `n` ranks: the world's ranks of
    `device`'s type when a group is initialized and `device` names a type
    without an index, else this process's (:func:`_device_list`, processes
    None)."""
    w = world()
    if w is not None and not isinstance(device, (list, tuple)):
        dev = resolve_device(device)
        ranks = w.ranks()
        if dev.index is None and ranks and all(d.type == dev.type for _, d in ranks):
            ranks = ranks if n is None else spread(ranks, n)
            return [d for _, d in ranks], [p for p, _ in ranks]
    return _device_list(device, n), None


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


def _mesh(device, n, shape: tuple, axes: tuple) -> Mesh:
    devs, procs = _rank_list(device, n)
    shape = shape or (len(devs),)
    return Mesh(_array(devs, shape), axes,
                None if procs is None else np.array(procs, dtype=np.int64).reshape(shape))


def sequence_mesh(n: int | None = None, device="cuda") -> Mesh:
    """1-D mesh of `n` ranks along "seq"; S sequences split over them in order.

    Without `n`, one rank per device meant, as the reference's
    ``sequence_mesh()`` takes every device: one per visible card for
    "cuda" (of every process after ``initialize_multihost``), one for a
    single device (which then steps all S sequences as one batch),
    ``len(device)`` for a list. See the module docstring for where the
    ranks go.
    """
    return _mesh(device, n, (), ("seq",))


def grid_mesh(seq: int, model: int, device="cuda") -> Mesh:
    """2-D mesh: `seq` sequence ranks x `model` ranks that split BA's point
    lanes, row-major over the devices of :func:`sequence_mesh`'s rule (the
    first seq * model cards for "cuda")."""
    return _mesh(device, seq * model, (seq, model), ("seq", "model"))
