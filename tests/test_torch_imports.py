"""The port imports torch and never jax (checked in a fresh interpreter)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "odometry_torch").rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = "\n".join(
        [f"import {m}" for m in modules]
        + [
            "import importlib.util",
            "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')",
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
            "import sys",
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))",
            "assert not bad, bad",
            "print(len(sys.modules))",
        ]
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 20
