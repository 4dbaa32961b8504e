"""The program's spans in a traced window: per span, its count, its time, its
self time, the card's idle time under it and the device-to-host copies in it.

``odometry_torch`` marks its layers with ``utils.profiling.span``: each span
is one host event of the profiler, on the clock of the card's kernels and
copies (``sweep.batched_step`` > ``pipeline.step_batch`` > ``tracker.solve``
> ``read.lm_active``, ...). :func:`table` reads the raw events that
``trace.Tracer.events`` gives, (name, on_device, start_ns, end_ns, grid):

* self time: a span's duration less the part of it that the program spans
  directly inside it cover;
* idle: the part of the union of a name's intervals in which no kernel, copy
  or memset ran on the card (``trace.merged``'s union, as
  ``trace.summarize`` takes the card's busy time), and the card's idle time
  inside the window but inside no program span;
* copies: given the host times at which the device-to-host copies were
  launched (:func:`launched_at`, from the profiler's link of a device event to
  the operator that launched it), each falls to the innermost program span
  around its time. (A copy's own time on the card's timeline does not place
  it: on the H100, most copies' middles fell outside the read span, ~0.1 ms
  long, that made them.)

Run on the card, a cell's set-up and then rounds of one sweep's first steps,
first the untraced rounds, then the traced (each step ends in the harness's
summary read, as in the benchmark's window)::

    python3 vobench/spans.py --workload <cell> --seed <n> [--steps k] [--rounds r]

One JSON line: the step times of both kinds of round, the table of the last
traced round per step, and the sums that check it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The names of the program's spans start so (odometry_torch's modules).
PREFIXES = ("sweep.", "pipeline.", "tracker.", "depth.", "read.")


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _intersect(x, y) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def _complement(intervals, t0: int, t1: int) -> list:
    """[t0, t1] less a sorted list of disjoint intervals."""
    out, at = [], t0
    for a, b in intervals:
        if a > at:
            out.append([at, min(a, t1)])
        at = max(at, b)
    if at < t1:
        out.append([at, t1])
    return out


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    idle_s: float = 0.0  # the card idle under the union of the name's intervals
    dtoh: int = 0  # device-to-host copies whose innermost span this is


@dataclasses.dataclass
class SpanTable:
    spans: dict  # name -> SpanStats
    window_s: float  # first event's start to last event's end, host and device
    idle_s: float  # the card idle in the window
    idle_outside_s: float  # the card idle in the window, inside no program span
    dtoh: int  # device-to-host copies in the window
    dtoh_outside: int | None  # of them, launched inside no program span (None: not placed)
    device_spans: int  # events on the card named as program spans (none expected)


def is_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _is_dtoh(name: str) -> bool:
    return name.startswith("Memcpy") and "DtoH" in name


def launched_at(kineto_events) -> list:
    """For each device-to-host copy among the profiler's raw events (in
    their order), the start on the host of the operator that launched it,
    or None where the profiler linked it to none."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = {e.correlation_id(): e.start_ns() for e in kineto_events
            if e.device_type() != cuda and e.correlation_id() > 0}
    return [host.get(e.linked_correlation_id()) for e in kineto_events
            if e.device_type() == cuda and _is_dtoh(e.name())]


def table(events, copies_at=None) -> SpanTable:
    """The :class:`SpanTable` of `events`: (name, on_device, start_ns,
    end_ns, grid) of every traced event, as ``trace.Tracer.events`` gives
    them. Program spans are host events named with one of ``PREFIXES``;
    they nest as calls do on one thread. `copies_at`: the host times at
    which the device-to-host copies were launched (:func:`launched_at`), to
    place them in spans; without it they are only counted."""
    from vobench.trace import merged

    t0 = min(s for _, _, s, _, _ in events)
    t1 = max(e for _, _, _, e, _ in events)
    busy = merged((s, e) for _, on, s, e, _ in events if on)
    spans = sorted(((s, e, n) for n, on, s, e, _ in events if not on and is_span(n)),
                   key=lambda v: (v[0], -v[1]))
    stats: dict = {}
    covered = [0] * len(spans)  # each span's time covered by its direct children
    by_name: dict = {}
    stack: list = []  # indices of the open spans, outermost first
    for k, (s, e, n) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            ps, pe, _ = spans[stack[-1]]
            covered[stack[-1]] += max(0, min(e, pe) - max(s, ps))
        stack.append(k)
        by_name.setdefault(n, []).append((s, e))
    for k, (s, e, n) in enumerate(spans):
        st = stats.setdefault(n, SpanStats())
        st.count += 1
        st.total_s += (e - s) / 1e9
        st.self_s += (e - s - covered[k]) / 1e9
    for n, iv in by_name.items():
        u = merged(iv)
        stats[n].idle_s = (_length(u) - _length(_intersect(u, busy))) / 1e9
    outside = _complement(merged((s, e) for s, e, _ in spans), t0, t1)
    copies = sum(1 for n, on, *_ in events if on and _is_dtoh(n))
    unplaced = None if copies_at is None else 0
    for at in copies_at or ():
        inner = None
        if at is not None:  # None: linked to no operator
            for s, e, n in spans:  # sorted by start: the last that holds `at` is innermost
                if s > at:
                    break
                if e >= at:
                    inner = n
        if inner is None:
            unplaced += 1
        else:
            stats[inner].dtoh += 1
    return SpanTable(
        spans=stats, window_s=(t1 - t0) / 1e9,
        idle_s=(t1 - t0 - _length(busy)) / 1e9,
        idle_outside_s=(_length(outside) - _length(_intersect(outside, busy))) / 1e9,
        dtoh=copies, dtoh_outside=unplaced,
        device_spans=sum(1 for n, on, *_ in events if on and is_span(n)))


def per_step(tab: SpanTable, steps: int) -> dict:
    """`tab` as numbers per step (ms, counts), with the sums that check it:
    the self times of the step's spans against ``sweep.batched_step``'s
    time, and the idle time under it plus outside every span against the
    window's."""
    ms = lambda s: 1e3 * s / steps
    rows = {n: {"count": st.count / steps, "total_ms": ms(st.total_s), "self_ms": ms(st.self_s),
                "idle_ms": ms(st.idle_s), "dtoh": st.dtoh / steps}
            for n, st in sorted(tab.spans.items())}
    step = tab.spans.get("sweep.batched_step")
    reads = sum(st.count for n, st in tab.spans.items() if n.startswith("read."))
    out = {"spans": rows, "window_ms": ms(tab.window_s), "idle_ms": ms(tab.idle_s),
           "idle_outside_ms": ms(tab.idle_outside_s), "dtoh": tab.dtoh / steps,
           "dtoh_outside": None if tab.dtoh_outside is None else tab.dtoh_outside / steps,
           "reads": reads / steps,
           "device_span_events": tab.device_spans}
    if step is not None:
        out["self_sum_over_step"] = sum(st.self_s for st in tab.spans.values()) / step.total_s
        out["idle_sum_over_window"] = ((step.idle_s + tab.idle_outside_s) / tab.idle_s
                                       if tab.idle_s > 0 else None)
    return out


# ----------------------------------------------------------------------------- on the card


def _round(left, right, cfg, mesh, steps: int, tracer=None) -> list:
    """A sweep's init and its first `steps` steps, each ending in the
    harness's summary read; `tracer` records the steps. Host ms a step."""
    import torch

    from odometry_torch.distributed import sweep as sweep_mod

    from vobench import harness

    states = sweep_mod.batched_init(left[0], right[0], cfg, mesh)
    harness._host_read(states, False)
    torch.cuda.synchronize()
    if tracer is not None:
        tracer.start()
    times = []
    for i in range(1, 1 + steps):
        t0 = time.perf_counter()
        states, outs, _ = sweep_mod.batched_step(states, left[i], right[i], cfg, mesh)
        harness._host_read(outs, True)
        times.append(1e3 * (time.perf_counter() - t0))
        if tracer is not None:
            tracer.step_done()
    if tracer is not None:
        tracer.stop()
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a round (default: the traffic's trace_steps)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="untraced rounds, then as many traced rounds")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from odometry_torch.distributed import sweep as sweep_mod
    from odometry_torch.pipeline import odometry

    from vobench import harness
    from vobench import trace as trace_mod
    from vobench.run import card_line

    cell = harness.load_cell(args.workload)
    steps = args.steps or int(cell.traffic.get("trace_steps", 8))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    left, right = harness.render_frames(cell, harness.lane_order(cell, args.seed), "cuda")
    cfg, mesh = harness.setup_program(cell, "cuda")
    harness.warm_up(left, right, cfg, mesh, int(cell.traffic.get("warmup_steps", 2)), sweep_mod)
    counters = lambda: (getattr(odometry, "DEPTH_RUNS", 0), getattr(odometry, "DEPTH_LANES", 0))
    c0 = counters()
    untraced = [_round(left, right, cfg, mesh, steps) for _ in range(args.rounds)]
    traced = []
    for _ in range(args.rounds):
        tracer = trace_mod.Tracer()
        traced.append(_round(left, right, cfg, mesh, steps, tracer))
    c1 = counters()
    events = tracer.events()
    raw = list(tracer.prof.profiler.kineto_results.events())
    line = {"workload": cell.name, "seed": args.seed, "card": card_line(),
            "lanes": len(cell.lanes), "steps": steps, "untraced_ms": untraced,
            "traced_ms": traced, "depth_runs": c1[0] - c0[0], "depth_lanes": c1[1] - c0[1],
            "last_traced_round": per_step(table(events, launched_at(raw)), steps),
            "breakdown": trace_mod.summarize(events, steps).breakdown()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
