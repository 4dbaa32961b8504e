"""The port imports torch, and never jax, the JAX package ``odometry_tpu``,
PIL or OpenCV (checked in a fresh interpreter): the machine with the card
has neither PIL nor OpenCV, and the port reads and writes PNGs itself
(``data/png.py``)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    # Every module of the port, then chip_smoke.py; neither jax, nor any
    # module of odometry_tpu, nor PIL or cv2 may be loaded afterwards.
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
            "ref = sorted(m for m in sys.modules",
            "             if m == 'odometry_tpu' or m.startswith('odometry_tpu.'))",
            "assert not ref, ref",
            "img = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2'))",
            "assert not img, img",
            "print(len(sys.modules))",
        ]
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 20
    assert {"odometry_torch.mapping.pose_graph", "odometry_torch.mapping.loop_closure",
            "odometry_torch.pipeline.slam", "odometry_torch.cli", "odometry_torch.data.png",
            "odometry_torch.data.kitti", "odometry_torch.data.tum",
            "odometry_torch.data.middlebury", "odometry_torch.data.native_loader",
            "odometry_torch.camera.calibration", "odometry_torch.eval.export",
            "odometry_torch.eval.disparity_eval", "odometry_torch.utils.checkpoint",
            "odometry_torch.utils.debug", "odometry_torch.utils.profiling",
            "odometry_torch.distributed.scaling", "odometry_torch.tools",
            "odometry_torch.tools.accuracy_sweep", "odometry_torch.tools.kernel_parity",
            "odometry_torch.tools.profile_step"} <= set(modules)
