"""The control comes out not correct: the plain reference computed in
bfloat16 in the program's place, judged by the cell's own limits (on the
card at the cells' sizes by ``vobench/control.py``; here on the CPU at a
small size). And on the card, one short run of each cell is correct."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell
from vobench import control, harness


@pytest.mark.parametrize("name", ["ref_sweep", "fast_sweep"])
def test_control_fails_the_limits(name):
    cell = tiny_cell(name, H=96, W=320, lanes=2, frames=4)
    row = control.readings(cell, [2**31 + 3], 0.5, 1, "cpu")[0]
    limits = cell.limits["limits"]
    assert any(row["control"][k] > limits[k] for k in limits), row["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ref_sweep", "fast_sweep"])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run([sys.executable, "vobench/run.py", "--workload", name, "--seed",
                          str(2**31 + 17), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {m["name"] for m in harness.load_cell(name).end_to_end}
