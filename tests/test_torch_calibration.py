"""Stereo calibration: the port's Kalibr parsing, Bouguet rectification and
remap grids against the reference's on tests/test_calibration.py's
fixtures. The code is the same host numpy, so the results are equal bit for
bit; the rectified images through remap_bilinear agree within 1e-5."""

import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odometry_tpu.camera import calibration as jcal
from odometry_tpu.image.sampling import remap_bilinear as j_remap
from odometry_torch.camera import calibration as tcal
from odometry_torch.image import remap_bilinear as t_remap

W, H = 640, 482

YAML = textwrap.dedent(
    """
    cam0:
      camera_model: pinhole
      intrinsics: [461.487, 460.110, 366.505, 249.541]
      distortion_model: radtan
      distortion_coeffs: [-0.2835, 0.0739, 0.000193, 0.0000176]
      resolution: [640, 482]
    cam1:
      camera_model: pinhole
      intrinsics: [460.273, 458.857, 369.885, 245.568]
      distortion_model: radtan
      distortion_coeffs: [-0.2833, 0.0743, 0.000198, 0.000178]
      resolution: [640, 482]
      T_cn_cnm1:
        - [0.9999, 0.0047, -0.0117, -0.1101]
        - [-0.0047, 0.9999, 0.0024, 0.0004]
        - [0.0117, -0.0025, 0.9999, -0.0008]
        - [0.0, 0.0, 0.0, 1.0]
    """
)


def _calib(mod):
    c0 = mod.MonoCalibration(460.0, 458.0, 320.0, 240.0,
                             np.array([-0.28, 0.07, 1e-4, -2e-4]), W, H)
    c1 = mod.MonoCalibration(457.0, 456.0, 322.0, 241.0,
                             np.array([-0.27, 0.065, 5e-5, 1e-4]), W, H)
    R10 = mod._rodrigues(np.array([0.004, -0.02, 0.003]))
    return mod.StereoCalibration(c0, c1, R10, np.array([-0.11, 0.0005, 0.001]))


def _same_rect(a, b):
    assert a.camera.__dict__ == b.camera.__dict__
    for name in ("map0_u", "map0_v", "map1_u", "map1_v", "R_rect0", "R_rect1"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_helpers_equal_reference():
    w = np.array([0.3, -0.2, 0.1])
    np.testing.assert_array_equal(tcal._rodrigues(w), jcal._rodrigues(w))
    R = jcal._rodrigues(w)
    np.testing.assert_array_equal(tcal._log_so3(R), jcal._log_so3(R))
    x, y = np.linspace(-0.5, 0.5, 7), np.linspace(0.4, -0.3, 7)
    d = np.array([-0.28, 0.07, 1e-4, -2e-4])
    for a, b in zip(tcal._distort_radtan(x, y, d), jcal._distort_radtan(x, y, d)):
        np.testing.assert_array_equal(a, b)


def test_stereo_rectify_equals_reference():
    _same_rect(tcal.stereo_rectify(_calib(tcal)), jcal.stereo_rectify(_calib(jcal)))


def test_kalibr_yaml_equals_reference(tmp_path):
    pytest.importorskip("yaml")
    p = tmp_path / "camchain.yaml"
    p.write_text(YAML)
    a, b = tcal.parse_kalibr_yaml(str(p)), jcal.parse_kalibr_yaml(str(p))
    for cam in ("cam0", "cam1"):
        x, y = getattr(a, cam), getattr(b, cam)
        assert (x.fx, x.fy, x.cx, x.cy, x.width, x.height) == \
            (y.fx, y.fy, y.cx, y.cy, y.width, y.height)
        np.testing.assert_array_equal(x.distortion, y.distortion)
    np.testing.assert_array_equal(a.R_10, b.R_10)
    np.testing.assert_array_equal(a.t_10, b.t_10)
    _same_rect(tcal.setup_stereo_from_kalibr(str(p)), jcal.setup_stereo_from_kalibr(str(p)))


def test_rectified_pair_through_remap_bilinear():
    rect = tcal.stereo_rectify(_calib(tcal))
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:H, 0:W]
    raw = (127 + 90 * np.sin(xs / 9.0) * np.cos(ys / 7.0)
           + rng.normal(0, 5, (H, W))).astype(np.float32)
    for mu, mv in ((rect.map0_u, rect.map0_v), (rect.map1_u, rect.map1_v)):
        a = t_remap(torch.from_numpy(raw), torch.from_numpy(mu), torch.from_numpy(mv)).numpy()
        b = np.asarray(j_remap(jnp.asarray(raw), jnp.asarray(mu), jnp.asarray(mv)))
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
