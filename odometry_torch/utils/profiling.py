"""Per-stage timing, spans, device traces and the card's timing primitives
(port of ``utils/profiling.py``, plus the timers of ``tools/microbench.py``).

:func:`span` marks a layer of the program (``sweep.batched_step``,
``tracker.solve``, ``read.lm_active``, ...) as one host event of an active
``torch.profiler`` session, on the clock of the card's kernel and copy
events; with no session it does nothing. :class:`StageTimer` accumulates
wall-clock spans per stage, as the reference's does, each also a
:func:`span`; :func:`device_trace` records a ``torch.profiler`` trace
(the reference's ``jax.profiler`` trace) and :func:`trace_summary` reads the
numbers PERF.md keeps from one: the traced window, the device's busy time
(the union of its kernel intervals) and idle share, its kernel launches and
the operations that took the most device time.

The timers of one call of a function on the card, each in ms:

* :func:`device_ms`: back-to-back calls behind a sleep kernel, so the host's
  enqueue does not show (on one card, or on several, timed on the first);
* :func:`graph_ms`: chained calls captured in one CUDA graph and replayed
  (the counterpart of the reference's in-dispatch ``fori_loop``,
  ``dev_time``): device time with no host dispatch at all;
* :func:`busy_ms`: the union of the card's kernel intervals under the
  profiler, for functions that read the host (neither of the two above
  holds their device time apart from the host's pace);
* :func:`wall_ms`: each call dispatched and synchronised (``wall_time``).

:func:`count_ops` counts the operators one call dispatches. The timers need
a card and raise without one: a host's time is never a device's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity
from torch.utils._python_dispatch import TorchDispatchMode

from odometry_torch.device import resolve_device


def _tensor_devices(tree, out: set) -> set:
    """Devices of every tensor in `tree` (tensors, and tuples, lists, dicts
    and dataclasses of them, nested)."""
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensor_devices(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensor_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensor_devices(getattr(tree, f.name), out)
    return out


def synchronize(result) -> None:
    """Wait until the devices of the tensors in `result` have finished their
    queued work (the counterpart of ``jax.block_until_ready``)."""
    for dev in _tensor_devices(result, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking its block as the span `name` in an active
    ``torch.profiler`` session: one host event, with the block's operators
    nested in it, on the profiler's clock (that of the card's kernels and
    copies). With no session active it is one shared context that does
    nothing: the cost is one read of torch's profiler-enabled flag.

    The span is recorded at the scope of an operator, not as a user
    annotation (``torch.profiler.record_function``): a user annotation is
    mirrored on the card's timeline as an event spanning the kernels
    launched inside it, which readers of the card's events would count as
    busy device time."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


class StageTimer:
    """Accumulates wall-clock spans per stage; under ``torch.profiler`` each
    stage is also a :func:`span` of the same name.

    On a CUDA device a span covers the device work only if it waits for it:
    pass the block's `result` to :meth:`stage`, or end the block in a host
    read (the runner's "sync" stage). Otherwise it measures the enqueue.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """Time the block; with `result` (tensors, or containers of them that
        the block fills in), synchronise on their devices before the span
        closes."""
        t0 = time.perf_counter()
        with span(name):
            yield
            if result is not None:
                synchronize(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in sorted(self.totals)
        }

    def __str__(self):
        lines = ["stage                     count   mean ms    total s"]
        for name, r in self.report().items():
            lines.append(f"{name:24s} {r['count']:6d} {r['mean_ms']:9.2f} {r['total_s']:9.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, *, device="cuda"):
    """Record a ``torch.profiler`` trace of the block: host operations, and
    on a card its kernels and copies. Yields the profiler (for
    :func:`trace_summary`); on exit waits for the card and writes a Chrome
    trace (``trace-<time>-<pid>.json``, open it in Perfetto or
    chrome://tracing) into `log_dir`.

    Raises when the card is asked for and CUDA activity cannot be traced,
    rather than tracing the host alone. The per-operator events are built
    only when read (``prof.events()``, :func:`trace_summary`), so a trace of
    many steps is written without that cost.
    """
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("device_trace: this torch build cannot trace CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def trace_summary(prof, top: int | None = 10) -> dict:
    """The numbers of a finished :func:`device_trace`:

    * ``window_ms``: first event's start to last event's end, host and device;
    * ``host_ops``: host operator calls (``aten::`` events);
    * ``device_busy_ms``: the union of the device's kernel and copy intervals;
    * ``idle_share``: 1 - busy / window (1.0 when nothing ran on a device);
    * ``device_launches``: device kernels (copies and memsets not counted);
    * ``device_copies``: device copies and memsets;
    * ``top_device_ops``: the `top` kernel names (all with None) by total
      device time, each ``{"name", "count", "total_ms"}``.
    """
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window_us = (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not _is_copy(e.name)]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in device)
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "window_ms": window_us / 1e3,
        "host_ops": sum(1 for e in events if e.device_type == DeviceType.CPU
                        and e.name.startswith("aten::")),
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / window_us if window_us > 0 else 1.0,
        "device_launches": len(kernels),
        "device_copies": len(device) - len(kernels),
        "top_device_ops": [{"name": n, "count": c, "total_ms": t / 1e3}
                           for n, (c, t) in ranked],
    }


class OpCounter(TorchDispatchMode):
    """Counts the operators dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn) -> int:
    """Operators one call of `fn` dispatches (on any device)."""
    with OpCounter() as counter:
        fn()
    return counter.ops


def _require_card(name: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs a CUDA card; a host's time is not a device's")


def device_ms(fn, reps: int, cards: list | None = None) -> float:
    """Device time of one call of `fn` when `reps` calls run back to back:
    a sleep kernel keeps the card busy while the host enqueues the calls,
    so the host's launch overhead does not show (CUDA events around the
    calls, after the sleep). Where the calls' launches overflow the
    CUDA launch queue the host paces the rest, so read a function of
    many launches beside :func:`graph_ms`.

    `cards`: the cards a function runs on, when several (their current
    streams; default the current card). CUDA events of two cards cannot be
    subtracted, so both are on the first: behind its sleep it records the
    start, every other card's stream waits for that start, the calls run,
    and the first card's stream waits for every other card's finish before
    it records the end."""
    _require_card("device_ms")
    cards = list(dict.fromkeys(torch.device(c) for c in cards or
                               [torch.device("cuda", torch.cuda.current_device())]))
    sync = lambda: [torch.cuda.synchronize(c) for c in cards]
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    host_ms = 1e3 * (time.perf_counter() - t0)
    streams = [torch.cuda.current_stream(c) for c in cards]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(cards[0]):
        # Cycles at up to 2 GHz: at a lower clock the sleep only lasts longer.
        torch.cuda._sleep(int(2e6 * (2.0 * reps * host_ms + 5.0)))
    a.record(streams[0])
    for s in streams[1:]:
        s.wait_event(a)
    for _ in range(reps):
        fn()
    for s in streams[1:]:
        streams[0].wait_event(s.record_event())
    b.record(streams[0])
    sync()
    return a.elapsed_time(b) / reps


def capture(fn, reps: int = 1):
    """`reps` chained calls of `fn` captured in one ``torch.cuda.CUDAGraph``
    after a warm-up on a side stream of the current card, which the capture
    runs on too (``torch.cuda.graph``'s own stream is made once, on the
    first card that captures). Returns (graph, the last call's result); each
    replay rewrites that result in place. `fn` must neither read the host
    nor copy from it: the capture then raises."""
    _require_card("capture")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            out = fn()
    return graph, out


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn`: `reps` chained calls captured in one
    CUDA graph (:func:`capture`), replayed `replays` times between CUDA
    events, per call. No host dispatch is left in it."""
    graph, _ = capture(fn, reps)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * reps)


def busy_ms(fn, reps: int) -> float:
    """Device busy time of one call of `fn`: the union of the card's kernel
    and copy intervals over `reps` calls under the profiler, per call. It
    holds for a function that reads the host, where the card idles between
    its launches. Reads the profiler's raw device events (building its
    per-operator events would take minutes for a step's ~15,000 operators)."""
    _require_card("busy_ms")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return _union_us(spans) / 1e6 / reps


def wall_ms(fn, reps: int) -> float:
    """Wall time of one call of `fn` dispatched and synchronised, the mean
    over `reps` calls after one warm-up call."""
    _require_card("wall_ms")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps
