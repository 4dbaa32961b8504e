"""Ring all-gather of keyframe blocks (port of ``distributed/ring_exchange.py``).

Each rank of a mesh holds a shard of keyframe state (poses, point blocks);
the ring moves every shard to every rank in num - 1 neighbour hops, with one
comm slot per step (``ring_exchange.py:10-21``: a slot is written once per
call and read only after its own signal, so no write-after-read hazard).

:func:`ring_gather` launches ``csrc/ring_gather.cu``, the port of the TPU
kernel ``odometry_tpu/distributed/ring_exchange.py:_ring_kernel``, for shards
that all lie on one card: the ranks are CTA groups of one cooperative grid,
the slots and flags real device memory that other CTAs write. Shards on
several devices raise (ROADMAP B3: a ring over peer pointers needs a machine
with two cards or more). :func:`ring_gather_plain` is the same schedule in
plain PyTorch on a list of per-rank comm tensors; CPU shards take it, and on
the card it serves only as the comparison.

:func:`ring_all_gather` and :func:`gather_keyframe_poses` are the mesh-level
entries. No TPU padding to (8, 128) tiles: the kernel moves byte slices of
any chunk and width.
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
_SLICE_BYTES = 8192  # bytes of a chunk per CTA per hop, at least


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


class _RingBuffers:
    """Flags (num ranks, num slots, CTAs per rank) int32 and the error word
    of one (device, stream, num, CTAs per rank), kept across calls with the
    epoch counter: each call passes a new epoch, so the flags are never
    reset."""

    def __init__(self, dev, num: int, per_rank: int):
        self.flags = torch.zeros((num, num, per_rank), dtype=torch.int32, device=dev)
        self.err = torch.zeros((), dtype=torch.int32, device=dev)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch = self.epoch % (2**31 - 2) + 1
        return self.epoch


_BUFFERS: dict = {}
_MAX_BLOCKS: dict = {}


def _max_blocks(lib, dev) -> int:
    """Blocks of the kernel that the card holds at once (occupancy x SMs)."""
    if dev not in _MAX_BLOCKS:
        fn = lib.ring_gather_max_blocks
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"ring_gather: occupancy query failed: cudaError {rc}")
        _MAX_BLOCKS[dev] = blocks.value
    return _MAX_BLOCKS[dev]


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


def ring_gather(shards: list, *, check: bool = True) -> list:
    """All-gather per-rank shards (chunk, ...) into one (num * chunk, ...)
    output per rank, in rank order.

    CPU shards run :func:`ring_gather_plain`. Shards on one CUDA device
    launch the kernel on the current stream; with `check` the wrapper then
    reads the kernel's error word (one host read) and raises if a rank
    waited past the timeout. `check=False` leaves the word for the next
    checked call (a timing loop). Shards on several devices raise
    ``NotImplementedError``; they are never copied to one device.
    """
    global LAUNCHES
    _check_shards(shards)
    devices = {s.device for s in shards}
    if len(devices) > 1:
        raise NotImplementedError(
            f"ring_gather: shards on {len(devices)} devices ({sorted(map(str, devices))}); "
            "a ring across cards is not ported yet (ROADMAP B3: needs a machine with two "
            "cards or more)")
    dev = devices.pop()
    if dev.type == "cpu":
        return ring_gather_plain(shards)
    if dev.type != "cuda":
        raise ValueError(f"ring_gather: unsupported device {dev}")

    from odometry_torch.kernels import _build

    num = len(shards)
    if num > _MAX_RANKS:
        raise ValueError(f"ring_gather: {num} ranks, the kernel takes at most {_MAX_RANKS}")
    lib = _build.load("ring_gather")
    shards = [s.contiguous() for s in shards]
    s0 = shards[0]
    nbytes = s0.numel() * s0.element_size()
    capacity = _max_blocks(lib, dev)
    if num > capacity:
        raise ValueError(f"ring_gather: {num} ranks need {num} co-resident blocks; the card "
                         f"holds {capacity}")
    per_rank = max(1, min(math.ceil(nbytes / _SLICE_BYTES), capacity // num))

    chunk = s0.shape[0]
    out = s0.new_empty((num, num * chunk) + tuple(s0.shape[1:]))
    comm = torch.empty((num, num * nbytes), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev, stream, num, per_rank)
        if key not in _BUFFERS:
            _BUFFERS[key] = _RingBuffers(dev, num, per_rank)
        buf = _BUFFERS[key]
        ptrs = lambda ts: (ctypes.c_uint64 * num)(*(t.data_ptr() for t in ts))
        fn = lib.ring_gather_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64)] * 4 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        rc = fn(ptrs(shards), ptrs(comm), ptrs(out), ptrs(buf.flags), buf.err.data_ptr(), num,
                per_rank, nbytes, buf.next_epoch(), stream)
    if rc != 0:
        raise RuntimeError(f"ring_gather kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    if check:
        raise_on_error(dev)
    return list(out)


def raise_on_error(dev):
    """Read the error words of the kernel's buffers on `dev` (one host read
    each) and raise if a launch timed out; a timed-out buffer is dropped."""
    for key, buf in list(_BUFFERS.items()):
        if key[0] == dev and int(buf.err) != 0:
            del _BUFFERS[key]
            raise RuntimeError("ring_gather: a rank waited past the kernel's timeout for its "
                               "neighbour's signal (not every rank's blocks were resident, or "
                               "a signal was lost)")


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
