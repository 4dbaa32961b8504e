"""The port's weak-scaling report (``distributed/scaling.py``), the
counterpart of ``tests/test_distributed.py:132-148`` at its 64x96
configuration, on virtual CPU ranks.

The analytic view counts what each rank dispatches (device operations and
kernel launches) and the bytes of the health reduction: the busiest rank's
work stays at one rank's (>= 80%, as the reference's FLOPs do) and the
reduction stays a few bytes whatever the frame size. The table has the
reference's layout."""

import pytest
import torch

from odometry_tpu.distributed.scaling import format_scaling_table as j_format
from odometry_torch import config as tc
from odometry_torch.distributed import sweep
from odometry_torch.distributed.scaling import format_scaling_table, sweep_scaling_report


def _cfg(H, W):
    """tests/test_distributed.py's CFG (64x96) at H x W."""
    return tc.PipelineConfig(
        camera=tc.CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=tc.TrackerConfig(num_levels=2, max_iterations=(6, 6), interp="bilinear",
                                 depth_decimation="even"),
        depth=tc.DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=6,
                             interp="bilinear"),
        keyframe=tc.KeyframeConfig(),
    )


CFG = _cfg(64, 96)


@pytest.fixture(scope="module")
def rows():
    return sweep_scaling_report(CFG, [1, 2, 8], timed=False, device="cpu")


def test_sweep_weak_scaling_analytic(rows):
    assert [r["n"] for r in rows] == [1, 2, 8]
    assert rows[0]["ops_per_device"] > 0
    for r in rows:
        assert r["analytic_efficiency_pct"] >= 80.0, rows
        # The only collective is the health reduction: tiny, frame-size
        # independent (the reference measured 8 bytes/step).
        assert 0 < r["collective_bytes"] < 4096, rows
        assert "steps_per_s" not in r  # timed defaults to False on the CPU
    # 8 B for the reduced pair, 4 B per sequence taken to rank 0 from another.
    assert [r["collective_bytes"] for r in rows] == [8, 12, 36]
    # Rank 0 steps sequence 0 at every size: the mesh adds only the health
    # reduction's operations (a cast and an add per other sequence) to it.
    for r in rows[1:]:
        assert 0 < r["ops_by_rank"][0] - rows[0]["ops_by_rank"][0] <= 4 * (r["n"] - 1)


def test_collective_bytes_independent_of_frame_size(rows):
    small = sweep_scaling_report(_cfg(48, 64), [1, 2], timed=False, device="cpu")
    assert [r["collective_bytes"] for r in small] == [r["collective_bytes"] for r in rows[:2]]


def test_timed_rows_on_the_cpu():
    timed = sweep_scaling_report(CFG, [1, 2], reps=1, timed=True, device="cpu")
    assert all(r["steps_per_s"] > 0 for r in timed)
    assert timed[0]["wall_efficiency_pct"] == 100.0


def test_collective_bytes_counted_where_the_reduction_runs():
    before = sweep.COLLECTIVE_BYTES
    mesh = sweep.sequence_mesh(2, "cpu")
    ok = [torch.tensor([True, True]), torch.tensor([False, True])]
    assert not bool(sweep._global_ok(ok, mesh))
    # Rank 1 counts its two sequences and sends the count: 4 B, plus the 8 B pair.
    assert sweep.COLLECTIVE_BYTES - before == 12


def test_format_scaling_table_is_the_reference_layout(rows):
    shared = ("n", "collective_bytes", "analytic_efficiency_pct", "steps_per_s",
              "wall_efficiency_pct")
    for rs in (rows, [dict(r, steps_per_s=5.0 * r["n"], wall_efficiency_pct=100.0)
                      for r in rows]):
        only = [{k: r[k] for k in shared if k in r} for r in rs]
        assert format_scaling_table(only) == j_format(only)
    text = format_scaling_table(rows)
    assert text.splitlines()[0].split() == ["n", "ops_per_device", "collective_bytes",
                                            "analytic_efficiency_pct"]


def test_scaling_report_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_scaling_report(CFG, [1])
