"""The reader of ``tracker.graph_iters_pct``."""

import pytest

from vobench import harness


def test_graph_iters_reader(monkeypatch):
    from odometry_torch.tracking import tracker

    read = harness.load_reader("tracker.graph_iters_pct")
    monkeypatch.setattr(tracker, "LM_ITERS", 0, raising=False)
    monkeypatch.setattr(tracker, "GRAPH_ITERS", 0, raising=False)
    assert read(None) is None  # no iteration: nothing to read
    monkeypatch.setattr(tracker, "LM_ITERS", 8)
    monkeypatch.setattr(tracker, "GRAPH_ITERS", 6)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.delattr(tracker, "GRAPH_ITERS")
    assert read(None) is None  # a program without the counters
    monkeypatch.delattr(tracker, "LM_ITERS")
    assert read(None) is None


def test_graph_captures_reader(monkeypatch):
    from odometry_torch.tracking import tracker

    read = harness.load_reader("tracker.graph_captures")
    monkeypatch.setattr(tracker, "GRAPH_CAPTURES", 4, raising=False)
    assert read(None) == 4
    monkeypatch.delattr(tracker, "GRAPH_CAPTURES")
    assert read(None) is None  # a program without the counter
