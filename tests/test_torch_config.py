"""The port's own copy of the configuration equals the reference's.

``odometry_torch/config.py`` is a copy (the port imports nothing of the JAX
package); each preset is built by both packages and compared field by field,
as is ``adapt_to_camera`` at two small cameras, so the copy cannot drift
silently. ``eval/metrics.py`` is a numpy copy too, held here on random poses.
"""

import dataclasses

import numpy as np
import pytest

from odometry_tpu import config as jc
from odometry_tpu.eval import metrics as jm
from odometry_torch import config as tc
from odometry_torch.eval import metrics as tm

PRESETS = ("kitti_config", "tum_rgbd_config", "accurate_config", "fast_config")


def test_dataclass_fields_identical():
    for name in ("CameraConfig", "TrackerConfig", "DepthConfig", "KeyframeConfig",
                 "PipelineConfig"):
        fj = [(f.name, f.type) for f in dataclasses.fields(getattr(jc, name))]
        ft = [(f.name, f.type) for f in dataclasses.fields(getattr(tc, name))]
        assert fj == ft, name


@pytest.mark.parametrize("camera", [None, (144, 320), (48, 96)])
@pytest.mark.parametrize("preset", PRESETS)
def test_preset_identical(preset, camera):
    cj, ct = getattr(jc, preset)(), getattr(tc, preset)()
    if camera is not None:
        H, W = camera
        cam = dict(fx=0.58 * W, fy=0.58 * W, cx=W / 2.0, cy=H / 2.0, baseline=0.537,
                   height=H, width=W)
        cj = jc.adapt_to_camera(dataclasses.replace(cj, camera=jc.CameraConfig(**cam)))
        ct = tc.adapt_to_camera(dataclasses.replace(ct, camera=tc.CameraConfig(**cam)))
    assert type(ct) is tc.PipelineConfig
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


def test_metrics_identical():
    rng = np.random.default_rng(0)
    n = 20
    gt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    pred = gt.copy()
    pred[:, :3, 3] += rng.normal(0, 0.05, (n, 3))
    c, s = np.cos(0.01), np.sin(0.01)
    pred[:, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    assert tm.mean_translation_error(gt, pred) == jm.mean_translation_error(gt, pred)
    assert tm.ate_rmse(gt, pred) == jm.ate_rmse(gt, pred)
    assert tm.ate_rmse(gt[:, :3], pred[:, :3], align=False) == jm.ate_rmse(gt[:, :3], pred[:, :3],
                                                                          align=False)
    assert tm.rpe(gt, pred, delta=2) == jm.rpe(gt, pred, delta=2)
    for a, b in zip(tm.align_umeyama(gt[:, :3, 3], pred[:, :3, 3]),
                    jm.align_umeyama(gt[:, :3, 3], pred[:, :3, 3])):
        np.testing.assert_array_equal(a, b)
