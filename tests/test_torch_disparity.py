"""Stereo search: selection, pattern stacks, winner maps and the dispatcher.

The port's plain winner maps are held to the reference's XLA path and to the
reference's Pallas band kernel itself, run in interpret mode on the CPU as
tests/test_disparity_pallas.py runs it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import make_scene, render_stereo
from odometry_tpu.image import gaussian_blur3 as jblur
from odometry_tpu.kernels import disparity as jd, select as jsel
from odometry_torch.kernels import disparity as td, disparity_band, select as tsel

H, W = 48, 320
MAX_DISP = 160


@pytest.fixture(scope="module")
def stereo():
    cam = JPinhole.create(140.0, 140.0, W / 2.0, H / 2.0)
    scene = make_scene(5, depth=10.0)
    left, right, _ = render_stereo(scene, cam, 0.537, jnp.eye(4), H, W)
    ls, rs = np.array(jblur(left)), np.array(jblur(right))
    return ls, rs


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pattern_stack_exact(stereo):
    ls, _ = stereo
    np.testing.assert_array_equal(np.asarray(jd.pattern_stack(jnp.asarray(ls))),
                                  td.pattern_stack(_t(ls)).numpy())


@pytest.mark.parametrize("min_pts", [0, 8])
def test_select_points_and_block_median_exact(stereo, min_pts):
    ls, rs = stereo
    kw = dict(boundary=4, block_rows=4, block_cols=8, grad_th=8.0,
              max_points_per_block=80, min_points_per_block=min_pts)
    sj = np.asarray(jsel.select_points(jnp.asarray(ls), **kw))
    st = tsel.select_points(_t(ls), **kw).numpy()
    np.testing.assert_array_equal(sj, st)
    vals = (rs % 7.0).astype(np.float32)
    kw = dict(boundary=4, block_rows=4, block_cols=8)
    np.testing.assert_array_equal(
        np.asarray(jsel.block_median_map(jnp.asarray(vals), jnp.asarray(sj), **kw)),
        tsel.block_median_map(_t(vals), _t(sj), **kw).numpy())


def _near_ties(ls, rs, y, x, xr_a, xr_b):
    """Direct-SSD gap of two candidate columns of the same query pixel."""
    P = lambda img: np.asarray(jd.pattern_stack(jnp.asarray(img)))
    PL, PR = P(ls), P(rs)
    ssd = lambda xr: np.sum((PL[:, y, x] - PR[:, y, xr]) ** 2, axis=0)
    return np.abs(ssd(xr_a) - ssd(xr_b))


# Two float32 norm expansions that sum in another order may swap winners
# whose SSDs differ by less than the expansion's rounding band (norms ~1e6
# here: a few tenths). Winners must agree except at such near-ties, and
# best values agree within 1.0 + 512 ulp (tools/tpu_parity.py budgets).
TIE = 1.0


def _check_maps(ls, rs, ref, port, region):
    bj, mj, rj = (np.asarray(a) for a in ref[:3])
    bt, mt, rt = (a.numpy() for a in port[:3])
    bad = region & (mj != mt)
    ys, xs = np.nonzero(bad)
    assert (_near_ties(ls, rs, ys, xs, mj[ys, xs], mt[ys, xs]) < TIE).all()
    assert bad.sum() <= max(2, 0.005 * region.sum())
    bad_r = region & (rj != rt)
    ys, xr = np.nonzero(bad_r)
    P = lambda img: np.asarray(jd.pattern_stack(jnp.asarray(img)))
    PL, PR = P(ls), P(rs)
    ssd = lambda x: np.sum((PL[:, ys, x] - PR[:, ys, xr]) ** 2, axis=0)
    assert (np.abs(ssd(rj[ys, xr]) - ssd(rt[ys, xr])) < TIE).all()
    assert bad_r.sum() <= max(2, 0.005 * region.sum())
    np.testing.assert_allclose(bt[region], bj[region], rtol=512 * 2.0**-23, atol=1.0)


@pytest.mark.parametrize("lr", [False, True])
@pytest.mark.parametrize("band", [(None, MAX_DISP), (12, 96), (None, None)])
def test_plain_winner_maps_match_xla(stereo, lr, band):
    ls, rs = stereo
    min_d, max_d = band
    kw = dict(boundary=4, max_disparity=max_d, min_disparity=min_d, lr_check=lr)
    ref = jd.disparity_winner_maps(jnp.asarray(ls), jnp.asarray(rs), backend="xla",
                                   second_best=True, **kw)
    port = td.disparity_winner_maps(_t(ls), _t(rs), second_best=True, **kw)
    _check_maps(ls, rs, ref, port, np.ones((H, W), bool))
    # `second` follows the XLA path's semantics (not the TPU kernel's, whose
    # fill is the float 2.0): compare where both picked the same winner.
    same = np.asarray(ref[1]) == port[1].numpy()
    np.testing.assert_allclose(port[3].numpy()[same], np.asarray(ref[3])[same],
                               rtol=512 * 2.0**-23, atol=1.0)


@pytest.mark.parametrize("lr", [False, True])
def test_plain_matches_pallas_band_kernel(stereo, lr):
    ls, rs = stereo
    sel = jsel.select_points(jnp.asarray(ls), boundary=4, block_rows=4, block_cols=8,
                             grad_th=8.0, max_points_per_block=80)
    kw = dict(fx=140.0, baseline=0.537, boundary=4, ssd_th=900.0, lr_check=lr,
              max_disparity=MAX_DISP)
    rp = jd.disparity_search(jnp.asarray(ls), jnp.asarray(rs), sel, backend="pallas", **kw)
    rt = td.disparity_search(_t(ls), _t(rs), _t(sel), **kw)
    mp, mt = np.asarray(rp.matched), rt.matched.numpy()
    both = mp & mt
    assert (mp != mt).sum() <= max(2, 0.005 * both.sum())
    flips = both & (np.asarray(rp.disparity) != rt.disparity.numpy())
    assert flips.sum() <= max(2, 0.005 * both.sum())
    np.testing.assert_allclose(rt.best_ssd.numpy()[both], np.asarray(rp.best_ssd)[both],
                               rtol=512 * 2.0**-23, atol=1.0)
    np.testing.assert_allclose(rt.inv_depth.numpy()[both & ~flips],
                               np.asarray(rp.inv_depth)[both & ~flips], rtol=1e-6)


def test_dispatcher_runs_plain_on_cpu_and_never_on_other_devices(stereo):
    ls, rs = stereo
    before = disparity_band.LAUNCHES
    kw = dict(boundary=4, max_disparity=MAX_DISP, lr_check=True)
    out = td.disparity_winner_maps(_t(ls), _t(rs), **kw)
    plain = disparity_band.disparity_band_plain(_t(ls), _t(rs), boundary=4, min_disparity=None,
                                                max_disparity=MAX_DISP, lr=True)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert disparity_band.LAUNCHES == before
    # A non-CPU tensor never takes the plain version: the full search has no
    # kernel yet, and the band wrapper refuses anything but CUDA tensors.
    meta = torch.empty((H, W), device="meta")
    with pytest.raises(NotImplementedError, match="B2"):
        td.disparity_winner_maps(meta, meta, boundary=4, max_disparity=None)
    with pytest.raises(ValueError, match="CUDA"):
        td.disparity_winner_maps(meta, meta, boundary=4, max_disparity=MAX_DISP)
    assert disparity_band.LAUNCHES == before
