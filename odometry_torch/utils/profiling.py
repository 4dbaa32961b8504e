"""Per-stage timing and device traces (port of ``utils/profiling.py``).

:class:`StageTimer` accumulates wall-clock spans per stage, as the
reference's does; :func:`device_trace` records a ``torch.profiler`` trace
(the reference's ``jax.profiler`` trace) and :func:`trace_summary` reads the
numbers PERF.md keeps from one: the traced window, the device's busy time
(the union of its kernel intervals) and idle share, its kernel launches and
the operations that took the most device time.
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
from torch.profiler import ProfilerActivity

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


class StageTimer:
    """Accumulates wall-clock spans per stage.

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
    rather than tracing the host alone.
    """
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("device_trace: this torch build cannot trace CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, acc_events=True)
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
