"""``odometry_torch.utils.profiling`` against the reference's
``odometry_tpu.utils.profiling``: the same spans give the same report keys
and counts; a device trace on the CPU is written and summarised; asking for
the card's trace without a card raises."""

import json

import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.utils import profiling as jp
from odometry_torch.utils import profiling as tp


def _spans(timer, value):
    with timer.stage("pyramid"):
        pass
    with timer.stage("pyramid"):
        pass
    with timer.stage("step", result=(value, [value * 2])):
        pass
    timer.add("io", 0.25)
    timer.add("io", 0.5)
    return timer


def test_stage_timer_report_matches_reference():
    tj = _spans(jp.StageTimer(), jnp.ones(3))
    tt = _spans(tp.StageTimer(), torch.ones(3))
    rj, rt = tj.report(), tt.report()
    assert list(rt) == list(rj) == ["io", "pyramid", "step"]
    for name in rj:
        assert rt[name].keys() == rj[name].keys()
        assert rt[name]["count"] == rj[name]["count"]
    # Spans given by `add` are exact: the same totals and means.
    assert rt["io"] == rj["io"] == {"total_s": 0.75, "count": 2, "mean_ms": 375.0}
    # The table layout is the reference's, line for line (times aside).
    lj, lt = str(tj).splitlines(), str(tt).splitlines()
    assert lt[0] == lj[0] and lt[1] == lj[1]  # header and the "io" row
    assert [r.split()[:2] for r in lt] == [r.split()[:2] for r in lj]


def test_stage_result_synchronises_nested_containers():
    seen = tp._tensor_devices({"a": (torch.ones(1), [torch.zeros(2)]), "b": 3}, set())
    assert seen == {torch.device("cpu")}


def test_device_trace_on_the_cpu_is_written_and_summarised(tmp_path):
    with tp.device_trace(str(tmp_path), device="cpu") as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    summ = tp.trace_summary(prof)
    assert summ["host_ops"] > 0 and summ["window_ms"] > 0
    # Nothing ran on a device.
    assert summ["device_busy_ms"] == 0.0 and summ["device_launches"] == 0
    assert summ["idle_share"] == 1.0 and summ["top_device_ops"] == []


def test_device_trace_on_the_card_without_one_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py traces it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tp.device_trace(str(tmp_path)):
            pass
    assert not list(tmp_path.glob("*.json"))


def test_union_of_intervals():
    assert tp._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert tp._union_us([]) == 0.0
