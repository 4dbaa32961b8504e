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

**Across processes** (:func:`ring_gather_across`, taken by the mesh-level
entries when a mesh spans processes) the kernel is the same push: each
process launches once per card it holds and writes its shards into every
rank's output; the outputs of other processes' ranks are reached through
CUDA IPC (``cudaIpcGetMemHandle`` / ``cudaIpcOpenMemHandle``, the kernel
library's ``ring_gather_ipc_*`` entries), so only processes of one host can
take part. PyTorch's caching allocator sub-allocates, and an IPC handle
names a whole allocation, so each output travels as (handle of its
allocation, byte offset in it, the allocation's buffer id, which a process
never reuses). The handles are exchanged on every call through a
:class:`Board` of shared memory (a few hundred bytes per process); the
outputs are ordinary tensors of the caller, never a pool that a later call
would overwrite. Opening a handle costs far more than a gather, so a process
opens each peer allocation once per card (cached by process, buffer id and
card), closes a mapping when the peer hands out a new allocation over the
same addresses (the old one was freed) and closes the rest at
:meth:`Peers.close` (``scaling.shutdown_multihost``). Order: each process
records an interprocess event ("ready": its outputs allocated, its shards
complete) on each card's stream before the exchange; the exchange is the
host barrier that makes every record precede every peer's wait on it (a wait
on an interprocess event that its owner has not recorded yet returns at
once). Then each launch waits for every rank's "ready", and a second
interprocess event ("done") after it is waited on by every process's
streams behind a second barrier on the board, so no process frees or
reuses an output that a peer still writes. Across processes on the CPU,
:func:`ring_gather_plain` runs the ring's hops as they are, a hop between
two processes' ranks a gloo send and receive. Nothing here calls NCCL; allocations that legacy IPC cannot export
(``expandable_segments:True``) and ranks on another host raise.

:func:`ring_all_gather` and :func:`gather_keyframe_poses` are the mesh-level
entries. No TPU padding to (8, 128) tiles: the kernel moves byte slices of
any chunk, width and dtype.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import platform
import struct
import time

import numpy as np
import torch
import torch.distributed as dist

from odometry_torch.distributed.mesh import GROUP_TIMEOUT_S, Mesh, World, world

# Kernel launches made by ring_gather(); tests and chip_smoke.py read it to
# show a run went through the kernel.
LAUNCHES = 0

_MAX_RANKS = 64  # csrc/ring_gather.cu:kMaxRanks


def ring_gather_plain(shards: list, owners: list | None = None) -> list:
    """The ring's schedule as torch ops: every rank's comm slot 0 is its own
    shard; at step s rank r's slot s is copied to rank r + 1's slot s + 1,
    and each rank unpacks the chunk that arrived (it originated s + 1 ranks
    back) to its place. Returns one (num * chunk, ...) output per rank.

    `owners` (ranks across processes): rank r's process, for each of the
    num ranks of the ring; `shards` then holds this process's ranks' shards
    in rank order, a hop from one process's rank to another's is a send
    and a receive over the (gloo) group, and the outputs are this process's
    ranks'."""
    num = len(shards) if owners is None else len(owners)
    me = world().process if owners is not None else None
    local = list(range(num)) if owners is None else [r for r in range(num) if owners[r] == me]
    mine = dict(zip(local, shards))
    s0 = shards[0]
    chunk = s0.shape[0]
    comm = {r: s.new_empty((num,) + tuple(s.shape)) for r, s in mine.items()}
    out = {r: s.new_empty((num * chunk,) + tuple(s.shape[1:])) for r, s in mine.items()}
    as_bytes = lambda t: t.reshape(-1).view(torch.uint8)
    for r, s in mine.items():
        out[r][r * chunk:(r + 1) * chunk] = s
        comm[r][0] = s
    for step in range(num - 1):
        pending = []
        for r in range(num):
            nxt = (r + 1) % num
            if r in mine and nxt in mine:
                comm[nxt][step + 1] = comm[r][step]
            elif r in mine:
                pending.append(dist.isend(as_bytes(comm[r][step]), owners[nxt], tag=r))
            elif nxt in mine:
                pending.append(dist.irecv(as_bytes(comm[nxt][step + 1]), owners[r], tag=r))
        for work in pending:
            work.wait()
        for r in mine:
            src = (r - step - 1) % num
            out[r][src * chunk:(src + 1) * chunk] = comm[r][step + 1]
    return [out[r] for r in local]


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


# ------------------------------------------------------ across processes

_NO_DRIVER, _NOT_IPC_CAPABLE = -2, -3  # csrc/ring_gather.cu:kNoDriver, kNotIpcCapable
_EXPANDABLE = ("legacy CUDA IPC handles (cudaIpcGetMemHandle) cannot export memory of "
               "expandable segments: unset expandable_segments:True in "
               "PYTORCH_CUDA_ALLOC_CONF for a run whose B3 spans processes")
# Shard dtypes as the offers name them (an index; -1 for any other).
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int8,
           torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)
_MAX_DIMS = 8
# An offer, int64 words: [error, dtype index, ndim, dims x _MAX_DIMS], then one
# slot per rank of the process: its output allocation's IPC handle (8 words),
# the output's byte offset in it, the allocation's base address, size and
# buffer id, then the "ready" and "done" event handles of the rank's card
# (8 words each).
_HEAD, _SLOT = 3 + _MAX_DIMS, 28
_LOCAL_MISMATCH = 1  # offer error: this process's own shards differ


def _words(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype=np.int64)


def pack_offer(error: int, shape: tuple, dtype, slots: list, max_ranks: int) -> np.ndarray:
    """A process's offer for the exchange of one gather across processes:
    its error code (0: none), its shards' shape and dtype, and per rank
    (handle, offset, base, size, buffer id, ready handle, done handle)."""
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"ring_gather: shards of {len(shape)} dimensions, at most {_MAX_DIMS}")
    words = np.zeros(_HEAD + _SLOT * max_ranks, dtype=np.int64)
    words[0] = error
    words[1] = _DTYPES.index(dtype) if dtype in _DTYPES else -1
    words[2] = len(shape)
    words[3:3 + len(shape)] = shape
    if slots:
        raw = b"".join(handle + struct.pack("<4Q", offset, base, size, buffer_id) + ready + done
                       for handle, offset, base, size, buffer_id, ready, done in slots)
        words[_HEAD:_HEAD + _SLOT * len(slots)] = np.frombuffer(raw, dtype=np.int64)
    return words


def read_offer(words: np.ndarray, ranks: int) -> dict:
    """:func:`pack_offer`'s fields from its words, for a process of `ranks` ranks."""
    ndim = int(words[2])
    raw = words[_HEAD:_HEAD + _SLOT * ranks].tobytes()
    slots = []
    for j in range(ranks):
        at = 8 * _SLOT * j
        slots.append((raw[at:at + 64], *struct.unpack_from("<4Q", raw, at + 64),
                      raw[at + 96:at + 160], raw[at + 160:at + 224]))
    dtype = int(words[1])
    return {"error": int(words[0]), "meta": (tuple(int(d) for d in words[3:3 + ndim]),
                                             _DTYPES[dtype] if dtype >= 0 else "other"),
            "slots": slots}


def _agree(metas: list):
    """Raises alike in every process unless every process's shards have one
    shape and dtype; `metas[p]` is process p's (shape, dtype) or why its
    own shards do not make one gather."""
    for p, m in enumerate(metas):
        if isinstance(m, str):
            raise ValueError(f"ring_gather: process {p}: {m}")
    if len(set(metas)) > 1:
        raise ValueError("ring_gather: shards differ across processes: " + "; ".join(
            f"process {p} {shape} {dtype}" for p, (shape, dtype) in enumerate(metas)))


def _shard_meta(shards: list):
    try:
        _check_shards(shards)
    except ValueError as e:
        return str(e)
    return tuple(shards[0].shape), shards[0].dtype


_FNS: dict = {}  # name -> the kernel library's function, typed


def _fn(name: str, argtypes: list):
    if name not in _FNS:
        from odometry_torch.kernels import _build

        fn = getattr(_build.load("ring_gather"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[name] = fn
    return _FNS[name]


def _on(card):
    """`card` made current, unless it already is (a device switch is a
    host call of its own)."""
    return contextlib.nullcontext() if card.index == torch.cuda.current_device() else \
        torch.cuda.device(card)


class Board:
    """The host steps of a gather across processes of one host: a block of
    shared memory (``multiprocessing.shared_memory``) with one row per
    process, [step, failed, offer words...]. :meth:`exchange` publishes this
    process's offer and returns every process's once all have published
    theirs; :meth:`barrier` waits until every process has reached it. Each
    waits by polling the others' step words: on the H100 hosts of
    ``chip_smoke.py`` phase 18 and ``tools/multichip.py`` the two steps took
    0.010-0.014 ms where one gloo barrier took 0.35-0.86 ms. A row's words
    are written before its step word, and an x86-64 host keeps stores in
    order and loads in order, so a peer that reads the step reads the offer
    written before it; on any other host (an aarch64 Grace Hopper, say) the
    board raises. A process writes its next offer only after the barrier
    that follows an exchange, so no peer reads a row while it changes. Made
    by process 0 on the first gather of a group, its name shared over the
    group; closed with the group's :class:`Peers`."""

    WORDS = 2 + _HEAD + _SLOT * _MAX_RANKS  # a row

    def __init__(self, w: World):
        from multiprocessing import resource_tracker, shared_memory

        if platform.machine() not in ("x86_64", "AMD64"):
            raise RuntimeError(f"ring_gather across processes: the board's plain stores are "
                               f"ordered only on an x86-64 host, not on {platform.machine()}")

        size = 8 * self.WORDS * w.size
        shm = shared_memory.SharedMemory(create=True, size=size) if w.process == 0 else None
        names = [None] * w.size
        dist.all_gather_object(names, shm.name if shm is not None else None)
        if shm is None:
            shm = shared_memory.SharedMemory(name=names[0])
            # Process 0 owns the block; another process's exit must not unlink it.
            resource_tracker.unregister(shm._name, "shared_memory")
        dist.barrier()  # every process has it open before any uses it
        self.shm, self.owner, self.me = shm, w.process == 0, w.process
        self.rows = np.ndarray((w.size, self.WORDS), dtype=np.int64, buffer=shm.buf)
        self.step = 0

    def _wait(self, step: int):
        """Polls without a system call for the first millisecond (a sleep
        is a system call, far slower than a poll), then sleeps."""
        steps = self.rows[:, 0]
        t0 = time.perf_counter()
        polls = 0
        while steps.min() < step:
            polls += 1
            if polls % 64:
                continue
            waited = time.perf_counter() - t0
            if waited > GROUP_TIMEOUT_S:
                raise TimeoutError(f"ring_gather: processes {np.nonzero(steps < step)[0].tolist()} "
                                   f"did not reach step {step} in {GROUP_TIMEOUT_S} s")
            if waited > 1e-3:
                time.sleep(1e-4)

    def exchange(self, offer: np.ndarray) -> list:
        """Every process's `offer` (equal lengths), once all have given theirs."""
        self.step += 1
        row = self.rows[self.me]
        row[2:2 + offer.size] = offer
        row[0] = self.step
        self._wait(self.step)
        return [self.rows[p, 2:2 + offer.size].copy() for p in range(len(self.rows))]

    def barrier(self, failed: bool) -> int:
        """Waits for every process; returns how many others failed."""
        self.step += 1
        row = self.rows[self.me]
        row[1] = int(failed)
        row[0] = self.step
        self._wait(self.step)
        return int(self.rows[:, 1].sum()) - int(failed)

    def close(self):
        self.rows = None
        self.shm.close()
        if self.owner:
            self.shm.unlink()


class Peers:
    """What this process holds for B3 across the processes of one group: its
    own interprocess "ready" and "done" events of each card (with their IPC
    handles), the other processes' allocations and events it opened, the
    offers it read last, and the :class:`Board` of the host steps (made on
    the group's first gather across processes, a collective).
    ``initialize_multihost`` makes one per group (``World.peers``); its
    :meth:`close` (``shutdown_multihost``) closes what it opened."""

    def __init__(self):
        self.own: dict = {}  # card -> (ready, done, ready handle, done handle)
        self.memory: dict = {}  # (process, buffer id, card index) -> (pointer here, base, size)
        self.events: dict = {}  # (process, event handle, card index) -> torch.cuda.Event
        self.offers: dict = {}  # process -> (its last offer's words, read)
        self.board: Board | None = None

    def own_events(self, card) -> tuple:
        if card not in self.own:
            with torch.cuda.device(card):
                ready = torch.cuda.Event(interprocess=True)
                done = torch.cuda.Event(interprocess=True)
                self.own[card] = (ready, done, ready.ipc_handle(), done.ipc_handle())
        return self.own[card]

    def open_memory(self, process: int, slot: tuple, card) -> int:
        """This process's pointer (on `card`) to the allocation of `process`
        that `slot` offers, opened once per (process, buffer id, card). An
        allocation of `process` over addresses of one opened before means
        that one was freed: its mapping is closed."""
        handle, _, base, size, buffer_id = slot[:5]
        key = (process, buffer_id, card.index)
        if key not in self.memory:
            for k, (_, b, n) in list(self.memory.items()):
                if k[0] == process and k[2] == card.index and b < base + size and base < b + n:
                    self._close_memory(k)
            ptr = ctypes.c_uint64()
            with torch.cuda.device(card):
                rc = _fn("ring_gather_ipc_open", [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)])(
                    handle, ctypes.byref(ptr))
            if rc != 0:
                raise RuntimeError(f"ring_gather: opening process {process}'s output allocation "
                                   f"on {card} failed: cudaError {rc}")
            self.memory[key] = (ptr.value, base, size)
        return self.memory[key][0]

    def _close_memory(self, key):
        ptr = self.memory.pop(key)[0]
        with torch.cuda.device(key[2]):
            rc = _fn("ring_gather_ipc_close", [ctypes.c_uint64])(ptr)
        if rc != 0:
            raise RuntimeError(f"ring_gather: closing process {key[0]}'s allocation on "
                               f"cuda:{key[2]} failed: cudaError {rc}")

    def event(self, process: int, handle: bytes, card):
        key = (process, handle, card.index)
        if key not in self.events:
            self.events[key] = torch.cuda.Event.from_ipc_handle(card, handle)
        return self.events[key]

    def read(self, process: int, words: np.ndarray, ranks: int) -> dict:
        """:func:`read_offer`, skipped where a process offers what it offered
        last (the same outputs' allocations and events)."""
        raw = words.tobytes()
        seen = self.offers.get(process)
        if seen is None or seen[0] != raw:
            seen = self.offers[process] = (raw, read_offer(words, ranks))
        return seen[1]

    def board_of(self, w: World) -> Board:
        if self.board is None:
            self.board = Board(w)
        return self.board

    def close(self):
        """Close every allocation of other processes opened here (after this
        process's cards finish what they were doing) and the board."""
        for card in {k[2] for k in self.memory}:
            torch.cuda.synchronize(card)
        for key in list(self.memory):
            self._close_memory(key)
        self.events.clear()
        self.offers.clear()
        if self.board is not None:
            self.board.close()
            self.board = None


def _export(out) -> tuple:
    """(error, (handle, offset, base, size, buffer id)) of the allocation
    that holds `out`."""
    handle = ctypes.create_string_buffer(64)
    info = (ctypes.c_uint64 * 4)()
    with _on(out.device):
        rc = _fn("ring_gather_ipc_export", [ctypes.c_uint64, ctypes.c_char_p,
                                            ctypes.POINTER(ctypes.c_uint64)])(
            out.data_ptr(), handle, info)
    return rc, (handle.raw, *info)


def _export_error(process: int, rc: int) -> str:
    what = {_NOT_IPC_CAPABLE: _EXPANDABLE,
            _NO_DRIVER: "the CUDA driver's cuPointerGetAttributes was not found",
            _LOCAL_MISMATCH: "its own shards differ"}
    return (f"ring_gather across processes: process {process}: "
            + what.get(rc, f"exporting an output failed: cuda error {rc}"))


def _raise_offer_errors(offers: list):
    """Raises, in every process alike (each reads the same offers), where a
    process offered an error code instead of its outputs, or where the
    processes' shards differ."""
    for p, offer in enumerate(offers):
        if offer["error"]:
            raise (ValueError if offer["error"] == _LOCAL_MISMATCH else RuntimeError)(
                _export_error(p, offer["error"]))
    _agree([offer["meta"] for offer in offers])


def ring_gather_across(shards: list, owners: list) -> list:
    """All-gather over ranks that span processes of one host, called by
    every process of the group together. `owners[r]`: rank r's process, for
    the num ranks in rank order; `shards`: this process's ranks' (chunk,
    ...) shards in rank order. Returns this process's ranks' (num * chunk,
    ...) outputs, each on its shard's device (the module docstring says
    how). Raises, in every process alike, for a rank on another host,
    shards that differ, and memory that CUDA IPC cannot export; a refused
    launch raises."""
    w = world()
    if w is None:
        raise RuntimeError("ring_gather_across: no process group (initialize_multihost)")
    me = w.process
    local = [r for r, p in enumerate(owners) if p == me]
    if len(shards) != len(local):
        raise ValueError(f"ring_gather: {len(shards)} shards for this process's {len(local)} ranks")
    for r, p in enumerate(owners):
        if w.hosts[p] != w.hosts[me]:
            raise ValueError(f"ring_gather: rank {r} lies in process {p} on host {w.hosts[p]!r}, "
                             f"not on this host ({w.hosts[me]!r}): B3 reaches other processes' "
                             "outputs through CUDA IPC, which stays on one host")
    types = {s.device.type for s in shards}
    if types == {"cpu"}:
        metas = [None] * w.size
        dist.all_gather_object(metas, _shard_meta(shards))
        _agree(metas)
        return ring_gather_plain(shards, owners)
    if types != {"cuda"}:
        raise ValueError(f"ring_gather: shards on {sorted(map(str, types))}; across processes "
                         "they lie on cards, or all on the CPU")
    return _gather_ipc(shards, owners, local, w)


def _gather_ipc(shards: list, owners: list, local: list, w: World) -> list:
    num = len(owners)
    if num > _MAX_RANKS:
        raise ValueError(f"ring_gather: {num} ranks, the kernel takes at most {_MAX_RANKS}")
    me = w.process
    meta = _shard_meta(shards)
    error = _LOCAL_MISMATCH if isinstance(meta, str) else 0
    shards = [s.contiguous() for s in shards]
    s0 = shards[0]
    nbytes = s0.numel() * s0.element_size()
    shape = (num * s0.shape[0],) + tuple(s0.shape[1:])
    cards = list(dict.fromkeys(s.device for s in shards))
    if len(cards) > 1:
        enable_peer_access(cards)
    out = [torch.empty(shape, dtype=s0.dtype, device=s.device) for s in shards]
    streams = {d: torch.cuda.current_stream(d) for d in cards}
    peers = w.peers
    own = {d: peers.own_events(d) for d in cards}  # (ready, done, their handles)
    for d in cards:
        own[d][0].record(streams[d])  # outputs allocated, shards complete
    slots = []  # an empty output (no bytes, no allocation) offers nothing
    for o in out:
        rc, exported = (0, None) if error or nbytes == 0 else _export(o)
        error = error or rc
        slots.append((*exported, *own[o.device][2:]) if exported and not error else
                     (bytes(64), 0, 0, 0, 0, bytes(64), bytes(64)))
    ranks_of = [[r for r in range(num) if owners[r] == p] for p in range(w.size)]
    board = peers.board_of(w)
    # The exchange: every "ready" is recorded before it ends.
    got = board.exchange(pack_offer(error, tuple(s0.shape), s0.dtype, slots,
                                    max(map(len, ranks_of))))
    others = [p for p in range(w.size) if p != me]
    failure = None
    try:
        offers = [peers.read(p, g, len(ranks_of[p])) for p, g in enumerate(got)]
        _raise_offer_errors(offers)
        if nbytes:
            _launch_ipc(shards, out, owners, local, offers, ranks_of, own, streams, peers, others)
    except Exception as e:  # every process still takes part in the barrier below
        failure = e
    # The second barrier, taken on every path after the exchange: no process
    # writes its next offer while a peer still reads this one, and every
    # "done" is recorded before any wait on it; a failure in any process is
    # raised in every one.
    failed = board.barrier(failure is not None)
    if failure is not None:
        raise failure
    if failed:
        raise RuntimeError(f"ring_gather across processes: the gather failed in {failed} other "
                           "process(es)")
    if nbytes == 0:
        return out
    for d in cards:
        for x in cards:
            if x != d:
                streams[d].wait_event(own[x][1])
        for p in others:
            for handle in dict.fromkeys(slot[6] for slot in offers[p]["slots"]):
                streams[d].wait_event(peers.event(p, handle, d))
    return out


def _launch_ipc(shards, out, owners, local, offers, ranks_of, own, streams, peers, others):
    """The launches of :func:`_gather_ipc`, one per card of this process
    that holds shards, each recording the card's "done" after it."""
    global LAUNCHES
    num = len(owners)
    nbytes = shards[0].numel() * shards[0].element_size()
    cards = list(streams)
    fn = _fn("ring_gather_launch_ranks", [ctypes.POINTER(ctypes.c_uint64)] * 2 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p])
    src_ptrs = (ctypes.c_uint64 * num)()
    for j, r in enumerate(local):
        src_ptrs[r] = shards[j].data_ptr()
    for d, idx in launch_plan([s.device for s in shards]):
        outs = (ctypes.c_uint64 * num)()
        for j, r in enumerate(local):
            outs[r] = out[j].data_ptr()
        for p in others:
            for r, slot in zip(ranks_of[p], offers[p]["slots"]):
                outs[r] = peers.open_memory(p, slot, d) + slot[1]
        for x in cards:
            if x != d:
                streams[d].wait_event(own[x][0])
        for p in others:
            for handle in dict.fromkeys(slot[5] for slot in offers[p]["slots"]):
                streams[d].wait_event(peers.event(p, handle, d))
        src = (ctypes.c_int * len(idx))(*(local[j] for j in idx))
        with _on(d):
            rc = fn(src_ptrs, outs, num, src, len(idx), nbytes, streams[d].cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ring_gather kernel launch on {d} failed: cudaError {rc}")
        LAUNCHES += 1
        own[d][1].record(streams[d])


def _shards_on_axis(x, mesh: Mesh, axis: str) -> tuple:
    """(this process's ranks' shards, num): `x` is a list of those shards
    in rank order (every rank's on a mesh of this process), or one global
    tensor split on its leading dimension over the ranks of `axis`."""
    if mesh.size != mesh.shape[axis]:
        raise ValueError(f"ring over {axis!r} on a mesh of shape {mesh.shape}: other axes "
                         "must have one rank")
    mesh.require_every_process(axis)
    num = mesh.size
    ranks = mesh.local_ranks()
    devs = [mesh.devices.flat[r] for r in ranks]
    if isinstance(x, (list, tuple)):
        if len(x) != len(ranks):
            raise ValueError(f"{len(x)} shards for {len(ranks)} ranks"
                             + ("" if mesh.processes is None else " of this process"))
        for r, s, d in zip(ranks, x, devs):
            if s.device != d:
                raise ValueError(f"shard {r} lies on {s.device}, its rank on {d}")
        return list(x), num
    lead = x.shape[0]
    if lead % num != 0:
        raise ValueError(f"leading dim {lead} not divisible by mesh axis {num}")
    chunk = lead // num
    return [x[r * chunk:(r + 1) * chunk].to(d) for r, d in zip(ranks, devs)], num


def ring_all_gather(x, mesh: Mesh, axis: str = "map") -> list:
    """All-gather over the ranks of `axis` through the ring.

    `x`: the ranks' shards (chunk, ...) as a list in rank order, each on its
    rank's device, or one global (num * chunk, ...) tensor split over the
    ranks. Returns one (num * chunk, ...) gather per rank, in rank order,
    each equal to ``jax.lax.all_gather(..., tiled=True)``. On a mesh that
    spans processes every process calls it together, with (or for) its own
    ranks' shards, and gets its own ranks' gathers
    (:func:`ring_gather_across`).
    """
    shards, num = _shards_on_axis(x, mesh, axis)
    inner = tuple(shards[0].shape[1:])
    flat = [s.reshape(s.shape[0], math.prod(inner)) for s in shards]
    outs = (ring_gather(flat) if mesh.processes is None else
            ring_gather_across(flat, mesh.processes.reshape(-1).tolist()))
    return [o.reshape((num * shards[0].shape[0],) + inner) for o in outs]


def gather_keyframe_poses(pose_shards, mesh: Mesh, axis: str = "map") -> list:
    """Every rank's keyframe pose block, on every rank: the neighbour-exchange
    primitive a sharded pose graph / BA window consumes.

    pose_shards: per-rank (K, 4, 4) blocks, or one (K_total, 4, 4) tensor
    split over `axis`.
    """
    return ring_all_gather(pose_shards, mesh, axis)
