"""Nothing the run path loads has the top-level name of JAX or the JAX
package (whole names: ``odometry_torch`` is not ``odometry_tpu``), and the
plain reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "odometry_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import vobench.run, vobench.control, vobench.probe
from conftest import tiny_cell
from vobench import harness
res = harness.run_cell(tiny_cell("fast_sweep", lanes=2, frames=3), 5, 0.2, True, device="cpu",
                       log=lambda m: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_path_loads_no_jax():
    names = _top_names(RUN.format(root=str(ROOT), tests=str(ROOT / "vobench" / "tests")))
    assert "odometry_torch" in names and "vobench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_plain_reference_loads_nothing_of_the_program():
    names = _top_names(f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
                       "import vobench.plain.odometry, vobench.check, vobench.render, "
                       "vobench.stats, vobench.trace; "
                       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "odometry_torch" not in names
    assert not names & FORBIDDEN
