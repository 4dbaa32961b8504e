"""The benchmark's arithmetic on fixed inputs."""

import pytest

from vobench import harness, stats
from vobench import trace as trace_mod


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 90) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_rate_and_tail_readers():
    win = harness.Window(steps=[{"t0": 0.0, "t1": 0.5, "lanes": 4, "kind": "init"}]
                         + [{"t0": 0.5 + k, "t1": 1.5 + k, "lanes": 4, "kind": "step"}
                            for k in range(9)],
                         window_s=9.5, frames_done=40, launches={"band": 3, "full": 2},
                         lm_iters=[10.0, 20.0], sweeps=[], depth_failed=0)
    run = harness.Run(cell=None, window=win, setup_s=12.5, lanes=4)
    read = lambda n: harness.load_reader(n)(run)
    assert read("seq_frames_per_s") == pytest.approx(40 / 9.5)
    assert read("frame_latency_p90_ms") == pytest.approx(1000.0)
    assert read("setup_s") == 12.5
    assert read("step.depth_runs_per_step") == pytest.approx(0.5)
    assert read("tracker.lm_iters_per_step") == pytest.approx(15.0)
    for n in ("device.idle_pct", "device.launches_per_step", "step.host_syncs_per_step",
              "ssd_search_roofline"):
        assert read(n) is None  # nothing to read without a trace


def test_interval_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (7, 7)]
    assert trace_mod.merged(iv) == [[0, 3], [5, 6], [7, 7]]
    assert trace_mod.merged([]) == []


def test_trace_summary_on_fixed_events():
    ns = 1_000_000_000
    events = [("aten::step", False, 0, 10 * ns, None),
              ("aten::empty", False, 3 * ns, 4 * ns, None),
              ("kernel_a", True, 1 * ns, 2 * ns, None),
              ("kernel_a", True, 2 * ns, 3 * ns, None),
              ("void band_kernel<true>(float const*)", True, 5 * ns, 6 * ns, (376, 3, 1)),
              ("Memcpy DtoH (Device -> Pageable)", True, 8 * ns, 8 * ns + ns // 2, None)]
    s = trace_mod.summarize(events, steps=2)
    assert s.window_s == pytest.approx(10.0)
    assert s.busy_s == pytest.approx(3.5)
    assert s.kernels == 3 and s.dtoh_copies == 1
    assert s.ssd_launches == [("void band_kernel<true>(float const*)", 1.0, (376, 3, 1))]
    assert s.top_ops[0] == ("kernel_a", 2.0)
    # Gaps: [0,1] [3,5] [6,8] [8.5,10]; the longest named by the host op at its middle.
    assert [g for _, g in s.idle_gaps] == pytest.approx([2.0, 2.0, 1.5, 1.0])
    assert s.idle_gaps[0][0] == "aten::empty"
    run = harness.Run(cell=None, window=harness.Window([], 1.0, 0, {}, [], [], 0, trace=s),
                      setup_s=0.0, lanes=3)
    assert harness.load_reader("device.idle_pct")(run) == pytest.approx(65.0)
    assert harness.load_reader("device.launches_per_step")(run) == pytest.approx(1.5)
    assert harness.load_reader("step.host_syncs_per_step")(run) == pytest.approx(0.5)


def test_roofline_arithmetic():
    # Full search over a 4 x 10 image, boundary 2: xr in [2, x - 1] for each x.
    assert stats.search_pairs(4, 10, 2, None, None) == 4 * sum(max(x - 2, 0) for x in range(10))
    # The band [3, 5]: x - 5 <= xr <= x - 3 and xr >= 2.
    want = sum(max(0, (x - 3) - max(2, x - 5) + 1) for x in range(10))
    assert stats.search_pairs(1, 10, 2, 3, 5) == want
    flops, nbytes = stats.search_work(376, 1241, 4, None, None, False)
    assert nbytes == 4 * 376 * 1241 * 4
    assert flops == 24 * stats.search_pairs(376, 1241, 4, None, None)
    assert stats.bound_s(67e12, 0) == pytest.approx(1.0)
    assert stats.bound_s(0, 3.35e12) == pytest.approx(1.0)
    # The reader: 2 launches of 3 images each at twice their bound -> 50%.
    cell = harness.load_cell("ref_sweep")
    one = stats.bound_s(*stats.search_work(376, 1241, 4, None, None, False))
    s = trace_mod.TraceSummary(steps=2, window_s=1.0, busy_s=0.5, kernels=2, dtoh_copies=0,
                               ssd_launches=[("full_kernel", 6 * one, (376, 3, 1))] * 2,
                               top_ops=[], idle_gaps=[])
    run = harness.Run(cell=cell, window=harness.Window([], 1.0, 0, {}, [], [], 0, trace=s),
                      setup_s=0.0, lanes=3)
    assert harness.load_reader("ssd_search_roofline")(run) == pytest.approx(50.0)
