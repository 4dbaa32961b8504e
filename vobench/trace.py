"""The traced steps of a ``--trace 1`` run, summarised in memory.

``torch.profiler`` records host operations and the card's kernels, copies and
memsets over a few steps; :meth:`Tracer.summary` reads its raw events once
(no Chrome trace is written) into the numbers the per-layer readers take:

* the traced window: the first event's start to the last event's end, host
  and device (``utils/profiling.trace_summary``'s arithmetic, copied);
* the device's busy time: the union of its kernel, copy and memset intervals;
* kernels, device-to-host copies, the SSD kernels' launches with their grids;
* the breakdown: the device operations that took most time, and the longest
  idle gaps of the device, each named by the host operation running at its
  middle.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

_SSD_KERNELS = ("band_kernel", "full_kernel")
_GRID = re.compile(r'"grid"\s*:\s*\[\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\]')


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clean(name: str, width: int = 64) -> str:
    """A kernel or host operation's name as a breakdown entry."""
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:width]


def _grid(event) -> tuple | None:
    try:
        m = _GRID.search(event.metadata_json())
    except (AttributeError, RuntimeError):
        return None
    return tuple(int(g) for g in m.groups()) if m else None


@dataclasses.dataclass
class TraceSummary:
    steps: int  # steps traced
    window_s: float
    busy_s: float
    kernels: int
    dtoh_copies: int
    ssd_launches: list  # (name, seconds, grid or None)
    top_ops: list  # (name, seconds), most device time first
    idle_gaps: list  # (host operation, seconds), longest first

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.top_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def summarize(events, steps: int, top: int = 10) -> TraceSummary:
    """`events`: (name, on_device, start_ns, end_ns, grid) of every traced
    event."""
    spans = [(s, e) for _, _, s, e, _ in events]
    t0 = min(s for s, _ in spans)
    t1 = max(e for _, e in spans)
    dev = [(n, s, e, g) for n, on, s, e, g in events if on]
    kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    busy = merged((s, e) for _, s, e, _ in dev)
    by_name: dict = {}
    for n, s, e, _ in kernels:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # Idle gaps between the device's busy intervals (and at the window's ends).
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]), key=lambda g: g[0] - g[1])[:top]
    host = [(n, s, e) for n, on, s, e, _ in events if not on]
    hs = np.array([s for _, s, _ in host], dtype=np.int64)
    he = np.array([e for _, _, e in host], dtype=np.int64)
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(host) else []
        name = (host[int(inside[np.argmax(hs[inside])])][0] if len(inside)
                else "no_host_operation")
        named.append((clean(name), (b - a) / 1e9))
    return TraceSummary(
        steps=steps, window_s=(t1 - t0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        kernels=len(kernels),
        dtoh_copies=sum(1 for n, *_ in dev if n.startswith("Memcpy") and "DtoH" in n),
        ssd_launches=[(n, (e - s) / 1e9, g) for n, s, e, g in kernels
                      if any(k in n for k in _SSD_KERNELS)],
        top_ops=[(clean(n), t / 1e9) for n, t in top_ops],
        idle_gaps=named,
    )


class Tracer:
    """The profiler over the traced steps of a run."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.active = False
        self.steps = 0

    def start(self) -> None:
        self.prof.start()
        self.active = True

    def step_done(self) -> None:
        self.steps += 1

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.active = False

    def events(self) -> list:
        out = []
        for e in self.prof.profiler.kineto_results.events():
            on = e.device_type() == torch.autograd.DeviceType.CUDA
            name = e.name()
            if not on and getattr(e, "is_python_function", lambda: False)():
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((name, on, s, s + d, _grid(e) if on else None))
        return out

    def summary(self) -> TraceSummary:
        return summarize(self.events(), self.steps)

