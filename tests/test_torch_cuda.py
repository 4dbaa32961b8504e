"""The port on an NVIDIA card: the band kernel and the CUDA path vs the CPU path.

These tests need a CUDA card and nvcc, and skip elsewhere. They import
neither jax nor the reference, so they run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import CameraConfig, fast_config
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.image.pyramid import gaussian_blur3
from odometry_torch.kernels import disparity_band
from odometry_torch.kernels.disparity import pattern_stack
from odometry_torch.pipeline.runner import run_sequence

pytestmark = pytest.mark.cuda

HS, WS = 144, 320
CAM_CFG = CameraConfig(fx=180.0, fy=180.0, cx=WS / 2.0, cy=HS / 2.0, baseline=0.537,
                       height=HS, width=WS)
CFG = dataclasses.replace(fast_config(), camera=CAM_CFG)
# The plain version expands ||L||^2 + ||R||^2 - 2 L.R in float32, the kernel
# sums squared differences: winners may differ only where two candidates
# score within TIE_ABS + TIE_REL * (ln + rn) (tools/tpu_parity.py budgets).
TIE_ABS, TIE_REL = 0.5, 8 * 2.0**-24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stereo(H, W, seed, dev):
    cam = Pinhole.create(0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    scene = make_scene(seed + 3, depth=14.0, device=dev)
    left, right, _ = render_stereo(scene, cam, 0.537, torch.eye(4), H, W)
    return gaussian_blur3(left).contiguous(), gaussian_blur3(right).contiguous()


def _ssd(PL, PR, y, x, xr):
    return ((PL[:, y, x] - PR[:, y, xr]) ** 2).sum(dim=0)


@pytest.mark.parametrize("shape", [(48, 256, 64), (64, 384, 192)])
def test_band_kernel_matches_plain(card, shape):
    H, W, D = shape
    ls, rs = _stereo(H, W, 0, card)
    kw = dict(boundary=4, min_disparity=None, max_disparity=D, lr=True, second_best=True)
    before = disparity_band.LAUNCHES
    bk, mk, rk, sk = disparity_band.disparity_band(ls, rs, **kw)
    torch.cuda.synchronize()
    assert disparity_band.LAUNCHES == before + 1
    bp, mp, rp, sp = disparity_band.disparity_band_plain(ls, rs, **kw)
    PL, PR = pattern_stack(ls), pattern_stack(rs)
    ln, rn = (PL * PL).sum(0), (PR * PR).sum(0)
    band = lambda y, x, xr: TIE_ABS + TIE_REL * (ln[y, x] + rn[y, xr])
    n = H * W
    y, x = torch.nonzero(mk != mp, as_tuple=True)
    assert y.numel() <= 0.01 * n
    gap = (_ssd(PL, PR, y, x, mk[y, x].long()) - _ssd(PL, PR, y, x, mp[y, x].long())).abs()
    assert bool((gap < band(y, x, mp[y, x].long())).all())
    y, xr = torch.nonzero(rk != rp, as_tuple=True)
    assert y.numel() <= 0.01 * n
    gap = (_ssd(PL, PR, y, rk[y, xr].long(), xr) - _ssd(PL, PR, y, rp[y, xr].long(), xr)).abs()
    assert bool((gap < band(y, rp[y, xr].long(), xr)).all())
    has = bp < 1e9
    assert bool(((bk < 1e9) == has).all())
    y, x = torch.nonzero(has, as_tuple=True)
    assert bool(((bk - bp)[y, x].abs() <= band(y, x, mp[y, x].long())).all())
    same = (mk == mp) & (sp < 1e9)
    assert bool(((sk - sp).abs()[same] <= TIE_ABS + TIE_REL * 2 * ln.max()).all())


def test_band_kernel_refuses_what_it_does_not_take(card):
    ls, rs = _stereo(48, 256, 0, card)
    kw = dict(boundary=4, min_disparity=None, max_disparity=64, lr=False)
    with pytest.raises(ValueError):
        disparity_band.disparity_band(ls.double(), rs.double(), **kw)
    with pytest.raises(ValueError):
        disparity_band.disparity_band(ls.t(), rs.t(), **kw)
    with pytest.raises(ValueError):
        disparity_band.disparity_band(ls, rs, boundary=4, min_disparity=80, max_disparity=64,
                                      lr=False)


def test_compute_depth_cuda_matches_cpu(card):
    cam = Pinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0, device="cpu")
    left, right, _ = render_stereo(scene, cam, 0.537, torch.eye(4), HS, WS)
    before = disparity_band.LAUNCHES
    dc = compute_depth(left.to(card), right.to(card), CAM_CFG, CFG.depth)
    dp = compute_depth(left, right, CAM_CFG, CFG.depth)
    assert disparity_band.LAUNCHES == before + 1
    vc, vp = dc.valid.cpu().numpy(), dp.valid.numpy()
    nc, npl = int(dc.num_valid), int(dp.num_valid)
    assert npl > 500 and abs(nc - npl) <= 0.01 * npl
    assert (vc & vp).sum() / (vc | vp).sum() >= 0.98
    both = vc & vp
    np.testing.assert_allclose(dc.inv_depth.cpu().numpy()[both], dp.inv_depth.numpy()[both],
                               rtol=0, atol=1e-4)


def test_run_sequence_cuda_matches_cpu(card):
    cam = Pinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0, device="cpu")
    poses = drive_trajectory(13, step=0.35, seed=4)
    frames = [tuple(a.numpy() for a in render_stereo(scene, cam, 0.537, T, HS, WS)[:2])
              for T in poses]
    rc = run_sequence(frames, CFG, device=card)
    rp = run_sequence(frames, CFG, device="cpu")
    assert rc.failed_at is None and rp.failed_at is None
    assert rc.keyframe_ids == rp.keyframe_ids and rc.lost_ids == rp.lost_ids
    # The "mm" tracker's tolerance (tests/test_torch_pipeline.py).
    np.testing.assert_allclose(rc.poses[:, :3, 3], rp.poses[:, :3, 3], rtol=0, atol=0.05)
    err = np.linalg.norm(rc.poses[:, :3, 3] - poses[:, :3, 3], axis=1)
    assert err.mean() < 0.05
