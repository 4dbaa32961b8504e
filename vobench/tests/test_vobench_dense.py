"""The dense cell, ref_dense_sweep: its configuration, its run on the CPU and
the readers of its two tracker metrics."""

import pytest

from conftest import tiny_cell
from vobench import harness

METRICS = ("tracker.dense_weighted_pct", "tracker.dense_mpx_per_iter")


def test_kitti_dense_is_the_dense_preset_as_run():
    from odometry_torch import config as port_config
    from odometry_torch.tools.profile_step import dense_config

    cell = harness.load_cell("ref_dense_sweep")
    assert harness.build_config(port_config, cell.config["pipeline"]) == dense_config()
    ref = harness.load_cell("ref_sweep")
    assert cell.traffic == ref.traffic and cell.limits == ref.limits
    assert [m["name"] for m in cell.per_layer] == list(METRICS)


def test_ref_dense_sweep_runs_on_the_cpu_and_reads_its_metrics():
    res = harness.run_cell(tiny_cell("ref_dense_sweep", lanes=2, frames=4), 2**31 + 9, 0.5,
                           True, device="cpu", log=lambda m: None)
    assert res["correct"] is True
    assert res["compared"]["decision_flips"]["value"] == 0
    assert set(res["metrics"]) == set(METRICS)
    assert 0 < res["metrics"]["tracker.dense_weighted_pct"]["value"] < 100
    # Two lanes at 48x160: at most the finest level's pixels an iteration.
    assert 0 < res["metrics"]["tracker.dense_mpx_per_iter"]["value"] <= 2 * 48 * 160 / 1e6


def test_dense_readers(monkeypatch):
    from odometry_torch.tracking import tracker

    pct, mpx = (harness.load_reader(m) for m in METRICS)
    monkeypatch.setattr(tracker, "DENSE_PX", 0)
    monkeypatch.setattr(tracker, "DENSE_ITERS", 0)
    assert pct(None) is None and mpx(None) is None  # no dense iteration: nothing to read
    monkeypatch.setattr(tracker, "DENSE_PX", 4_000_000)
    monkeypatch.setattr(tracker, "DENSE_ITERS", 2)
    monkeypatch.setattr(tracker, "dense_weighted", lambda: 100_000)
    assert pct(None) == pytest.approx(2.5)
    assert mpx(None) == pytest.approx(2.0)
    # A program without the counters, as the parent of the dense cell.
    for name in ("dense_weighted", "DENSE_ITERS", "DENSE_PX"):
        monkeypatch.delattr(tracker, name)
    assert pct(None) is None and mpx(None) is None
