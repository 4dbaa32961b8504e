"""BENCHMARK.json and the files each cell finds by name."""

import json
import shutil

import pytest

from conftest import ROOT, tiny_cell
from vobench import harness

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_manifest_has_the_contract_keys_and_every_cell_finds_its_files():
    man = harness.manifest()
    assert set(man) == TOP
    assert man["paths"] == ["vobench"]
    assert man["command"][:2] == ["python3", "vobench/run.py"]
    for c in man["configs"]:
        assert (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(conf)
    for w in man["workloads"]:
        cell = harness.load_cell(w["name"], man)
        assert cell.chips in (1, 4)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "seq_frames_per_s"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
        for k in ("trans_gap_median", "valid_px_diff"):
            assert k in cell.limits["limits"]


def test_configuration_files_hold_the_presets_as_run():
    from odometry_torch import config as port_config

    for name, preset in (("kitti_ref", port_config.kitti_config()),
                         ("kitti_fast", port_config.fast_config())):
        cfg = harness.build_config(port_config, harness.load_cell(
            {"kitti_ref": "ref_sweep", "kitti_fast": "fast_sweep"}[name]).config["pipeline"])
        assert cfg == preset


def test_a_cell_is_added_by_files_and_a_manifest_entry(tmp_path):
    """A new configuration, traffic mix, metric and limits: new files plus
    BENCHMARK.json entries, no file that is there edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "vobench", root / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    conf = json.loads((ROOT / "vobench/configs/kitti_fast.json").read_text())
    conf["pipeline"]["tracker"]["point_capacity"] = 2048
    (root / "vobench/configs/dummy.json").write_text(json.dumps(conf))
    traffic = json.loads((ROOT / "vobench/traffic/kitti22_sweep.json").read_text())
    traffic["lane_seeds"] = [100, 104]
    (root / "vobench/traffic/four_lanes.json").write_text(json.dumps(traffic))
    (root / "vobench/metrics/dummy.steps.py").write_text("def read(run):\n    return 7.0\n")
    shutil.copy(root / "vobench/limits/fast_sweep.json", root / "vobench/limits/dummy_cell.json")
    man["configs"].append({"name": "dummy", "source": "x", "file": "vobench/configs/dummy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy", "traffic": "four_lanes",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "dummy.steps", "unit": "steps", "better": "lower",
                             "source": "program_counter", "layer": "step",
                             "moves": "seq_frames_per_s", "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.load_cell("dummy_cell", root=root)
    assert cell.lanes == [100, 101, 102, 103]
    assert cell.config["pipeline"]["tracker"]["point_capacity"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["dummy.steps"]
    assert harness.load_reader("dummy.steps", root=root)(None) == 7.0
    # The cells that are there still load as before.
    assert harness.load_cell("fast_sweep", root=root).lanes == harness.load_cell("fast_sweep").lanes


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    res = harness.run_cell(tiny_cell("ref_sweep", lanes=2, frames=4), 2**31 + 9, 0.5,
                           bool(trace), device="cpu", log=lambda m: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["compared"]
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 2
    want = harness.load_cell("ref_sweep")
    names = {m["name"] for m in (want.per_layer if trace else want.end_to_end)}
    assert set(res["metrics"]) <= names
    assert "setup_s" in res["metrics"] or trace
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(res)
