"""``odometry_torch.tools.bench`` and ``capacity_knee`` against the
reference's ``bench.py`` and ``tools/capacity_knee.py``.

The reference tools render 376x1241 frames and run in ``main``, so they are
not called here: their quantities are computed through the reference's
public API (``run_sequence``, ``mean_translation_error``) on the frames the
port's tool renders (bench.py's workload at a reduced camera, 144x320, and
FRAMES frames), and held against the port tool's as MM_ATOL says.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest

from odometry_tpu import config as jc
from odometry_tpu.eval.metrics import mean_translation_error as j_mte
from odometry_tpu.pipeline.runner import run_sequence as j_run_sequence
from odometry_torch import config as tc
from odometry_torch.tools import bench, capacity_knee
from tests.torch_tools_reference import as_numpy, port_config, reference_config, same_fields
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

FRAMES = 3
# fast_config's "mm" sampler: the LM paths of two float32 implementations
# part (ROADMAP C1; 2.5e-3 m at 144x320 within 6 frames), so runs are
# held as tests/test_torch_pipeline.py:94-96 holds them: the same keyframe
# and lost decisions, poses within MM_ATOL, mte within MM_MTE.
MM_ATOL, MM_MTE = 0.05, 0.01
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_bench():
    """The port's whole bench at the reduced camera, and its frames."""
    cfg = port_config("fast")
    runs = {seed: bench.render_frames(cfg, seed, FRAMES, device="cpu") for seed in bench.SEEDS}
    # bench.bench's steps, on frames rendered once.
    records = bench.accuracy(cfg, [(seed, *runs[seed]) for seed in bench.SEEDS], device="cpu")
    bench.check_gate([r["mte"] for r in records])
    fps, steps = bench.timed_fps(cfg, runs[bench.TIMED_SEED][1], device="cpu")
    assert steps == 2 * (FRAMES - 1)  # frames 1.. twice
    return bench.result_line(fps), records, runs


def test_workload_is_the_references():
    text = (REPO / "bench.py").read_text()
    # bench.py:28-95: the metric name letter for letter, the baseline, seeds,
    # frames, step and gate.
    assert f'"metric": "{bench.METRIC}"' in text
    assert "baseline_fps = 1000.0 / 30.0" in text and bench.BASELINE_FPS == 1000.0 / 30.0
    assert "for seed in (4, 5, 11):" in text and bench.SEEDS == (4, 5, 11)
    assert "num_frames = 49" in text and bench.NUM_FRAMES == 49
    assert "drive_trajectory(num_frames, step=0.35, seed=seed)" in text and bench.STEP == 0.35
    assert "med < 0.15" in text and bench.GATE == 0.15
    assert "if seed == 4:" in text and bench.TIMED_SEED == 4


def test_bench_seeds_match_the_reference(port_bench):
    line, records, runs = port_bench
    cfg_j = reference_config("fast")
    mtes_j = []
    for rec in records:
        poses, frames = runs[rec["seed"]]
        ref = j_run_sequence(as_numpy(frames), cfg_j)
        assert ref.failed_at is None and rec["result"].failed_at is None
        got = rec["result"]
        assert got.keyframe_ids == ref.keyframe_ids and got.lost_ids == ref.lost_ids
        np.testing.assert_allclose(got.poses, ref.poses, rtol=0, atol=MM_ATOL)
        mte_j = j_mte(poses[: ref.num_frames], ref.poses)
        assert rec["mte"] == pytest.approx(mte_j, abs=MM_MTE)
        mtes_j.append(mte_j)
        assert rec["depth_runs"] >= len(got.keyframe_ids)  # init, and each promotion
    # The gate's decision is the reference's.
    assert (np.median(mtes_j) < 0.15) == (np.median([r["mte"] for r in records]) < 0.15)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench.METRIC and line["unit"] == "frames/s"
    assert line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / bench.BASELINE_FPS) <= 1e-3


@pytest.mark.parametrize("mtes, passes", [([0.05, 0.2, 0.1], True), ([0.2, 0.05, 0.16], False),
                                          ([0.15, 0.15, 0.0], False)])
def test_gate_is_the_references(mtes, passes):
    # bench.py:72-73: the median of the three seeds, strictly below 0.15.
    if passes:
        assert bench.check_gate(mtes) == float(np.median(mtes))
    else:
        with pytest.raises(RuntimeError, match="bench accuracy regression"):
            bench.check_gate(mtes)


def test_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench", lambda cfg, **kw: (bench.result_line(40.0), []))
    assert bench.main(["--device", "cpu", "--height", "144", "--width", "320"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert json.loads(out[0]) == {"metric": bench.METRIC, "value": 40.0, "unit": "frames/s",
                                  "vs_baseline": 1.2}


def test_knee_variants_are_the_references():
    # tools/capacity_knee.py:63-77: dataclasses.replace of fast_config().
    text = (REPO / "tools" / "capacity_knee.py").read_text()
    assert "for cap in (2048, 4096, 8192, 16384):" in text
    assert "for mr in (8192, 16384, 32768):" in text
    assert capacity_knee.CAPS == (2048, 4096, 8192, 16384)
    assert capacity_knee.MAX_RESIDUALS == (8192, 16384, 32768)
    base_j, base_t = jc.fast_config(), tc.fast_config()
    for cap in capacity_knee.CAPS:
        ref = dataclasses.replace(base_j, tracker=dataclasses.replace(base_j.tracker,
                                                                      point_capacity=cap))
        assert same_fields(capacity_knee.with_point_capacity(base_t, cap), ref)
    for mr in capacity_knee.MAX_RESIDUALS:
        ref = dataclasses.replace(base_j, depth=dataclasses.replace(base_j.depth,
                                                                    max_residuals=mr))
        assert same_fields(capacity_knee.with_max_residuals(base_t, mr), ref)
    # The presets stay the reference's: the knee is reported, not written back.
    assert same_fields(base_t, base_j)


def test_knee_measure_matches_the_reference(port_bench):
    _, _, runs = port_bench
    poses, frames = runs[bench.TIMED_SEED]
    cfg_j = dataclasses.replace(reference_config("fast"), tracker=dataclasses.replace(
        reference_config("fast").tracker, point_capacity=2048))
    lines = []
    rows = capacity_knee.knee(port_config("fast"), frames, poses, caps=(2048,),
                              max_residuals=(), device="cpu", log=lines.append)
    ref = j_run_sequence(as_numpy(frames), cfg_j)
    assert len(rows) == 1 and rows[0]["fps"] > 0
    assert rows[0]["keyframes"] == len(ref.keyframe_ids) and rows[0]["lost"] == len(ref.lost_ids)
    assert rows[0]["mte"] == pytest.approx(j_mte(poses[: ref.num_frames], ref.poses), abs=MM_MTE)
    # The reference's print lines (tools/capacity_knee.py:68-70).
    assert lines[0] == "point_capacity sweep (max_residuals=16384):"
    assert re.fullmatch(r"  cap   2048: mte +\d+\.\d{4} fps +\d+\.\d kf \d+ lost \d+", lines[1])
