"""``spans.py``'s arithmetic on fixed events, and the depth-lanes reader."""

import pytest

from vobench import harness, spans

# One traced step (times in ns): the program's spans nest as calls do, two
# kernels overlap, a host operator and a copy run after the step, outside
# every span. The copies were launched at LAUNCHED (the second outside every span).
EVENTS = [
    ("sweep.batched_step", False, 0, 100, None),
    ("pipeline.step_batch", False, 5, 95, None),
    ("tracker.solve", False, 10, 60, None),
    ("read.lm_active", False, 20, 25, None),
    ("read.lm_active", False, 40, 42, None),
    ("depth.compute", False, 65, 90, None),
    ("read.depth_refine", False, 70, 72, None),
    ("aten::copy_", False, 104, 107, None),
    ("kernel_a", True, 12, 18, None),
    ("kernel_b", True, 15, 22, None),
    ("kernel_a", True, 30, 35, None),
    ("Memcpy DtoH (Device -> Pageable)", True, 41, 42, None),
    ("kernel_c", True, 66, 80, None),
    ("Memcpy DtoH (Device -> Pageable)", True, 105, 106, None),
    ("kernel_a", True, 125, 130, None),
]
LAUNCHED = [41, 104]


def test_self_time_idle_and_copies_on_fixed_events():
    t = spans.table(EVENTS, LAUNCHED)
    assert t.window_s == pytest.approx(130e-9)
    # The card is busy [12,22] [30,35] [41,42] [66,80] [105,106] [125,130]: 36 of 130.
    assert t.idle_s == pytest.approx(94e-9)
    st = t.spans
    assert st["read.lm_active"].count == 2
    self_ns = {n: round(s.self_s * 1e9) for n, s in st.items()}
    assert self_ns == {"sweep.batched_step": 10, "pipeline.step_batch": 15, "tracker.solve": 43,
                       "read.lm_active": 7, "depth.compute": 23, "read.depth_refine": 2}
    assert sum(self_ns.values()) == round(st["sweep.batched_step"].total_s * 1e9) == 100
    idle_ns = {n: round(s.idle_s * 1e9) for n, s in st.items()}
    assert idle_ns == {"sweep.batched_step": 70, "pipeline.step_batch": 60, "tracker.solve": 34,
                       "read.lm_active": 4, "depth.compute": 11, "read.depth_refine": 0}
    # Outside every span: [100, 130], busy 1 + 5 of it.
    assert t.idle_outside_s == pytest.approx(24e-9)
    assert st["sweep.batched_step"].idle_s + t.idle_outside_s == pytest.approx(t.idle_s)
    assert t.dtoh == 2 and t.dtoh_outside == 1 and st["read.lm_active"].dtoh == 1
    assert t.device_spans == 0


def test_copies_fall_to_the_innermost_span_that_launched_them():
    t = spans.table(EVENTS, copies_at=[11, None])  # None: linked to no operator
    assert t.spans["tracker.solve"].dtoh == 1 and t.spans["read.lm_active"].dtoh == 0
    assert t.dtoh_outside == 1
    t = spans.table(EVENTS)  # no launch times: counted, not placed
    assert t.dtoh == 2 and t.dtoh_outside is None
    assert all(st.dtoh == 0 for st in t.spans.values())


def test_per_step_numbers_and_their_sums():
    out = spans.per_step(spans.table(EVENTS + [(n, on, s + 200, e + 200, g)
                                               for n, on, s, e, g in EVENTS],
                                     LAUNCHED + [t + 200 for t in LAUNCHED]), 2)
    assert out["spans"]["read.lm_active"]["count"] == 2.0
    assert out["spans"]["tracker.solve"]["self_ms"] == pytest.approx(43e-6)
    assert out["reads"] == 3.0 and out["dtoh"] == 2.0 and out["dtoh_outside"] == 1.0
    assert out["self_sum_over_step"] == pytest.approx(1.0)
    assert out["idle_sum_over_window"] == pytest.approx(1.0)
    assert "self_sum_over_step" not in spans.per_step(spans.table(EVENTS[2:]), 1)


def test_depth_lanes_reader(monkeypatch):
    from odometry_torch.pipeline import odometry

    read = harness.load_reader("step.depth_lanes_per_run")
    monkeypatch.setattr(odometry, "DEPTH_RUNS", 0)
    assert read(None) is None  # no depth run: nothing to read
    monkeypatch.setattr(odometry, "DEPTH_RUNS", 4)
    monkeypatch.setattr(odometry, "DEPTH_LANES", 10)
    assert read(None) == pytest.approx(2.5)
    monkeypatch.delattr(odometry, "DEPTH_RUNS")
    assert read(None) is None  # a program without the counters
