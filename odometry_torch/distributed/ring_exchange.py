"""All-gather of keyframe blocks (port of ``distributed/ring_exchange.py``).

Each rank of a mesh holds a shard of keyframe state (poses, point blocks);
the all-gather gives every rank every shard. The reference moves them round
a ring in num - 1 neighbour hops, with one comm slot per step
(``ring_exchange.py:10-21``), because a TPU's DMA reaches only its
neighbours.

:func:`ring_gather` launches ``csrc/ring_gather.cu``, the port of the TPU
kernel ``odometry_tpu/distributed/ring_exchange.py:_ring_kernel``. It has no
ring: each shard is read once and written to every rank's output, with no
comm slots and no flags. Shards that all lie on one card take one ordinary
launch. Shards on several cards of one host take one launch per card that
holds shards (:func:`launch_plan`): each pushes its card's shards into every
rank's output, those on other cards through peer access over NVLink
(:func:`enable_peer_access`), and CUDA events order the cards' current
streams around the launches. No shard is ever copied to another device.
:func:`ring_gather_plain` is the ring's schedule in plain PyTorch on a list
of per-rank comm tensors; CPU shards take it, and on the card it serves only
as the comparison (bit for bit: both only copy). Its cross-device slot
assignments are the cross-card copies.

:func:`ring_all_gather` and :func:`gather_keyframe_poses` are the mesh-level
entries. No TPU padding to (8, 128) tiles: the kernel moves byte slices of
any chunk, width and dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from odometry_torch.distributed.mesh import Mesh

# Kernel launches made by ring_gather(); tests and chip_smoke.py read it to
# show a run went through the kernel.
LAUNCHES = 0

_MAX_RANKS = 64  # csrc/ring_gather.cu:kMaxRanks


def ring_gather_plain(shards: list) -> list:
    """The ring's schedule as torch ops: every rank's comm slot 0 is its own
    shard; at step s rank r's slot s is copied to rank r + 1's slot s + 1,
    and each rank unpacks the chunk that arrived (it originated s + 1 ranks
    back) to its place. Returns one (num * chunk, ...) output per rank."""
    num = len(shards)
    chunk = shards[0].shape[0]
    comm = [s.new_empty((num,) + tuple(s.shape)) for s in shards]
    out = [s.new_empty((num * chunk,) + tuple(s.shape[1:])) for s in shards]
    for r, s in enumerate(shards):
        out[r][r * chunk:(r + 1) * chunk] = s
        comm[r][0] = s
    for step in range(num - 1):
        for r in range(num):
            comm[(r + 1) % num][step + 1] = comm[r][step]
        for r in range(num):
            src = (r - step - 1) % num
            out[r][src * chunk:(src + 1) * chunk] = comm[r][step + 1]
    return out


def _check_shards(shards: list):
    if not shards:
        raise ValueError("ring_gather: no shards")
    s0 = shards[0]
    for s in shards[1:]:
        if s.shape != s0.shape or s.dtype != s0.dtype:
            raise ValueError(f"ring_gather: shards differ: {tuple(s0.shape)} {s0.dtype} vs "
                             f"{tuple(s.shape)} {s.dtype}")
    if s0.dim() == 0:
        raise ValueError("ring_gather: shards need a leading (chunk) dimension")


ROUTES = (None, "per_shard")


def launch_plan(devices: list, force_route: str | None = None) -> list:
    """The kernel launches of an all-gather of shards on `devices` (one per
    rank, in rank order): [(card, ranks whose shards that launch pushes)],
    one per card that holds shards, in the order of each card's first rank.
    ``force_route="per_shard"`` makes one launch per shard, on its card: on
    the virtual ranks of one card it runs the host side of the multi-card
    route (its tables, offsets and events)."""
    if force_route not in ROUTES:
        raise ValueError(f"ring_gather: force_route {force_route!r}, one of {ROUTES}")
    if force_route == "per_shard":
        return [(d, (j,)) for j, d in enumerate(devices)]
    plan: dict = {}
    for j, d in enumerate(devices):
        plan.setdefault(d, []).append(j)
    return [(d, tuple(ranks)) for d, ranks in plan.items()]


_PEERS: set = set()  # ordered (card, peer) pairs whose access is enabled


def enable_peer_access(cards: list):
    """Lets kernels on each of `cards` write every other's memory
    (``cudaDeviceEnablePeerAccess``, once per ordered pair and process).
    Raises, naming the pair, where the cards cannot reach each other or the
    call fails."""
    fn = None
    for a in cards:
        for b in cards:
            if a == b or (a.index, b.index) in _PEERS:
                continue
            if fn is None:
                from odometry_torch.kernels import _build

                fn = _build.load("ring_gather").ring_gather_enable_peer
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int]
            rc = fn(a.index, b.index)
            if rc == -1:  # csrc/ring_gather.cu:kNoPeerAccess
                raise RuntimeError(f"ring_gather: {a} cannot access {b}'s memory (no peer "
                                   "access between the two cards)")
            if rc != 0:
                raise RuntimeError(f"ring_gather: enabling peer access from {a} to {b} "
                                   f"failed: cudaError {rc}")
            _PEERS.add((a.index, b.index))


def ring_gather(shards: list, force_route: str | None = None) -> list:
    """All-gather per-rank shards (chunk, ...) into one (num * chunk, ...)
    output per rank, in rank order, each on its shard's device.

    CPU shards run :func:`ring_gather_plain`. Shards on CUDA devices launch
    the kernel as :func:`launch_plan` says (one launch for shards on one
    card) on the current streams, with no synchronise, and raise if a launch
    is refused. Across cards the call returns once every card's current
    stream is ordered after every launch that writes its outputs; each source
    card's stream first waits for every other card's, so outputs and shards
    made on those streams are ready. Shards on the CPU and on a card raise;
    they are never copied to one device.
    """
    global LAUNCHES
    _check_shards(shards)
    devices = [s.device for s in shards]
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return ring_gather_plain(shards)
    if types != {"cuda"}:
        raise ValueError(f"ring_gather: shards on {sorted(map(str, set(devices)))}; the "
                         "kernel takes shards on cards only, the CPU takes the plain version")

    num = len(shards)
    if num > _MAX_RANKS:
        raise ValueError(f"ring_gather: {num} ranks, the kernel takes at most {_MAX_RANKS}")
    plan = launch_plan(devices, force_route)
    cards = list(dict.fromkeys(devices))
    if len(cards) > 1:
        enable_peer_access(cards)
    shards = [s.contiguous() for s in shards]
    s0 = shards[0]
    nbytes = s0.numel() * s0.element_size()
    shape = (num * s0.shape[0],) + tuple(s0.shape[1:])
    if len(plan) == 1:  # one card: one tensor, a view per rank
        out = list(s0.new_empty((num,) + shape))
    else:
        out = [torch.empty(shape, dtype=s0.dtype, device=d) for d in devices]
    if nbytes == 0:
        return out

    from odometry_torch.kernels import _build

    fn = _build.load("ring_gather").ring_gather_launch_ranks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64)] * 2 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    ptrs = lambda ts: (ctypes.c_uint64 * num)(*(t.data_ptr() for t in ts))
    local, outs = ptrs(shards), ptrs(out)
    streams = {d: torch.cuda.current_stream(d) for d in cards}
    # Several launches (several cards, or the per_shard route): each waits for
    # every card's current stream, where outputs and shards were made, and
    # every card's stream then waits for each launch, which may write its
    # outputs or read its shards.
    multi = len(plan) > 1
    ready = [streams[d].record_event() for d in cards] if multi else []
    done = []
    for d, ranks in plan:
        for ev in ready:
            streams[d].wait_event(ev)
        with torch.cuda.device(d):
            rc = fn(local, outs, num, (ctypes.c_int * len(ranks))(*ranks), len(ranks), nbytes,
                    streams[d].cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ring_gather kernel launch on {d} failed: cudaError {rc}")
        LAUNCHES += 1
        if multi:
            done.append(streams[d].record_event())
    for d in cards:
        for ev in done:
            streams[d].wait_event(ev)
    return out


def _shards_on_axis(x, mesh: Mesh, axis: str) -> tuple:
    """(per-rank shards, num): `x` is a list of per-rank shards, or one
    global tensor split on its leading dimension over the ranks of `axis`."""
    if mesh.size != mesh.shape[axis]:
        raise ValueError(f"ring over {axis!r} on a mesh of shape {mesh.shape}: other axes "
                         "must have one rank")
    devs = mesh.axis_devices(axis)
    num = len(devs)
    if isinstance(x, (list, tuple)):
        if len(x) != num:
            raise ValueError(f"{len(x)} shards for {num} ranks")
        for r, (s, d) in enumerate(zip(x, devs)):
            if s.device != d:
                raise ValueError(f"shard {r} lies on {s.device}, its rank on {d}")
        return list(x), num
    lead = x.shape[0]
    if lead % num != 0:
        raise ValueError(f"leading dim {lead} not divisible by mesh axis {num}")
    chunk = lead // num
    return [x[r * chunk:(r + 1) * chunk].to(devs[r]) for r in range(num)], num


def ring_all_gather(x, mesh: Mesh, axis: str = "map") -> list:
    """All-gather over the ranks of `axis` through the ring.

    `x`: the ranks' shards (chunk, ...) as a list in rank order, each on its
    rank's device, or one global (num * chunk, ...) tensor split over the
    ranks. Returns one (num * chunk, ...) gather per rank, in rank order,
    each equal to ``jax.lax.all_gather(..., tiled=True)``.
    """
    shards, num = _shards_on_axis(x, mesh, axis)
    inner = tuple(shards[0].shape[1:])
    flat = [s.reshape(s.shape[0], math.prod(inner)) for s in shards]
    return [o.reshape((num * shards[0].shape[0],) + inner) for o in ring_gather(flat)]


def gather_keyframe_poses(pose_shards, mesh: Mesh, axis: str = "map") -> list:
    """Every rank's keyframe pose block, on every rank: the neighbour-exchange
    primitive a sharded pose graph / BA window consumes.

    pose_shards: per-rank (K, 4, 4) blocks, or one (K_total, 4, 4) tensor
    split over `axis`.
    """
    return ring_all_gather(pose_shards, mesh, axis)
