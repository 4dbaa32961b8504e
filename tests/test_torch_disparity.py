"""Stereo search: selection, pattern stacks, winner maps and the dispatcher.

The port's plain winner maps are held to the reference's XLA path and to the
reference's two Pallas kernels themselves (the band kernel and the
full-search ``_kernel``), run in interpret mode on the CPU as
tests/test_disparity_pallas.py runs them; the full search also to the
reference's direct-SSD golden model.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import make_scene, render_stereo
from odometry_tpu.image import gaussian_blur3 as jblur
from odometry_tpu.kernels import disparity as jd, select as jsel
from odometry_tpu.kernels.disparity_pallas import disparity_cost_argmin_pallas
from odometry_torch import config as tc
from odometry_torch.depth.estimator import search_band
from odometry_torch.kernels import disparity as td, disparity_band, disparity_full
from odometry_torch.kernels import select as tsel

H, W = 48, 320
MAX_DISP = 160


def _render(h, w, fx):
    cam = JPinhole.create(fx, fx, w / 2.0, h / 2.0)
    scene = make_scene(5, depth=10.0)
    left, right, _ = render_stereo(scene, cam, 0.537, jnp.eye(4), h, w)
    return np.array(jblur(left)), np.array(jblur(right))


@pytest.fixture(scope="module")
def stereo():
    return _render(H, W, 140.0)


@pytest.fixture(scope="module")
def stereo_small():
    """The 48x96 pair of tests/test_disparity_pallas.py (interpret mode is slow)."""
    return _render(48, 96, 140.0)


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
    before = (disparity_band.LAUNCHES, disparity_full.LAUNCHES)
    for max_d in (MAX_DISP, None):
        kw = dict(boundary=4, max_disparity=max_d, lr_check=True)
        out = td.disparity_winner_maps(_t(ls), _t(rs), **kw)
        plain = disparity_band.disparity_band_plain(_t(ls), _t(rs), boundary=4,
                                                    min_disparity=None, max_disparity=max_d,
                                                    lr=True)
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    assert (disparity_band.LAUNCHES, disparity_full.LAUNCHES) == before
    # A non-CPU tensor never takes the plain version: both kernel wrappers
    # refuse anything but CUDA tensors.
    meta = torch.empty((H, W), device="meta")
    for max_d in (None, MAX_DISP, 300):
        with pytest.raises(ValueError, match="CUDA"):
            td.disparity_winner_maps(meta, meta, boundary=4, max_disparity=max_d)
    assert (disparity_band.LAUNCHES, disparity_full.LAUNCHES) == before


@pytest.mark.parametrize("max_d,route", [(24, "band"), (192, "band"), (256, "band"),
                                         (257, "full"), (1241, "full"), (None, "full")])
def test_route_mirrors_reference(max_d, route):
    from odometry_tpu.kernels.disparity_pallas import band_fits_vmem

    assert td._route(max_d) == route
    if max_d is not None:
        assert (route == "band") == band_fits_vmem(max_d)


def test_presets_route_as_the_reference_launches():
    """At KITTI size fast_config's band [12, 192] takes the band kernel;
    accurate_config's [12, 1241] and kitti_config's full search the
    full-search kernel, as the reference's Pallas routing does."""
    routes = {}
    for preset in ("fast_config", "accurate_config", "kitti_config"):
        cfg = getattr(tc, preset)()
        routes[preset] = (search_band(cfg.camera, cfg.depth), td._route(
            search_band(cfg.camera, cfg.depth)[1]))
    assert routes == {"fast_config": ((12, 192), "band"),
                      "accurate_config": ((12, 1241), "full"),
                      "kitti_config": ((None, None), "full")}


def _search_flips_are_ties(ls, rs, rp, rt, budget_of):
    """`disparity_search` results of the reference (`rp`) and the port (`rt`):
    `matched` and `disparity` agree except at near-ties of the winner's SSD,
    within the selected-pixel budget."""
    mp, mt = np.asarray(rp.matched), rt.matched.numpy()
    both = mp & mt
    budget = max(2, int(budget_of * both.sum()))
    assert (mp != mt).sum() <= budget
    dp, dt = np.asarray(rp.disparity), rt.disparity.numpy()
    flips = both & (dp != dt)
    assert flips.sum() <= budget
    ys, xs = np.nonzero(flips)
    xr_p = (xs - dp[ys, xs]).astype(int)
    xr_t = (xs - dt[ys, xs]).astype(int)
    assert (_near_ties(ls, rs, ys, xs, xr_p, xr_t) < TIE).all()
    np.testing.assert_allclose(rt.best_ssd.numpy()[both], np.asarray(rp.best_ssd)[both],
                               rtol=512 * 2.0**-23, atol=1.0)


def _full_kernel_maps(ls, rs, max_d, min_d=None):
    """The reference's full-search Pallas ``_kernel`` (interpret mode on the
    CPU), called directly so that a narrow band is not routed to the band
    kernel."""
    PL, PR = jd.pattern_stack(jnp.asarray(ls)), jd.pattern_stack(jnp.asarray(rs))
    return disparity_cost_argmin_pallas(PL, PR, jnp.sum(PL * PL, axis=0),
                                        jnp.sum(PR * PR, axis=0), boundary=4,
                                        max_disparity=max_d, min_disparity=min_d)


@pytest.mark.parametrize("lr", [False, True])
@pytest.mark.parametrize("max_d", [None, 24])
def test_plain_full_search_matches_xla_and_pallas_kernel(stereo_small, lr, max_d):
    ls, rs = stereo_small
    h, w = ls.shape
    kw = dict(boundary=4, max_disparity=max_d, lr_check=lr)
    ref = jd.disparity_winner_maps(jnp.asarray(ls), jnp.asarray(rs), backend="xla", **kw)
    port = td.disparity_winner_maps(_t(ls), _t(rs), **kw)
    _check_maps(ls, rs, ref, port, np.ones((h, w), bool))

    sel = jsel.select_points(jnp.asarray(ls), boundary=4, block_rows=4, block_cols=8,
                             grad_th=8.0, max_points_per_block=80)
    fin = dict(fx=140.0, baseline=0.537, boundary=4, ssd_th=900.0, lr_check=lr, lr_tol=1)
    best, match, rmatch, _ = _full_kernel_maps(ls, rs, max_d)
    rp = jd._finalize(jnp.asarray(ls), best, match, rmatch, sel, **fin)
    rt = td.disparity_search(_t(ls), _t(rs), _t(sel), max_disparity=max_d,
                             **{k: v for k, v in fin.items() if k != "lr_tol"})
    _search_flips_are_ties(ls, rs, rp, rt, 0.005)


@pytest.mark.parametrize("lr", [False, True])
def test_plain_wide_band_matches_pallas_kernel(stereo, lr):
    """The band [12, 320] at 48x320: too wide for the reference's band
    kernel, so its routing takes the full-search ``_kernel`` with the band as
    a mask; the port's router takes its full-search kernel."""
    ls, rs = stereo
    assert td._route(W) == "full"
    sel = jsel.select_points(jnp.asarray(ls), boundary=4, block_rows=4, block_cols=8,
                             grad_th=8.0, max_points_per_block=80)
    kw = dict(fx=140.0, baseline=0.537, boundary=4, ssd_th=900.0, lr_check=lr,
              max_disparity=W, min_disparity=12)
    rp = jd.disparity_search(jnp.asarray(ls), jnp.asarray(rs), sel, backend="pallas", **kw)
    rt = td.disparity_search(_t(ls), _t(rs), _t(sel), **kw)
    _search_flips_are_ties(ls, rs, rp, rt, 0.005)


def test_reference_full_kernel_scores_padded_columns():
    """A defect of the reference (ROADMAP C), pinned: the full-search Pallas
    kernel pads the width to Wp = 128 with zero left patterns, and its
    reverse pass scores those padded query columns x in [W, Wp) as
    candidates, with SSD = rn[xr]. In a dark region of the right image (small
    rn) they win: `rmatch` points past the image. `match` is unaffected. The
    port follows the XLA path, which has no padded columns."""
    rng = np.random.default_rng(0)
    h, w = 16, 96
    left = rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)
    right = rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)
    right[:, 40:60] = 1.0
    kw = dict(boundary=4, max_disparity=None, lr_check=True)
    bx, mx, rx, _ = (np.asarray(a) for a in jd.disparity_winner_maps(
        jnp.asarray(left), jnp.asarray(right), backend="xla", **kw))
    bp, mp, rp, _ = (np.asarray(a) for a in jd.disparity_winner_maps(
        jnp.asarray(left), jnp.asarray(right), backend="pallas", **kw))
    np.testing.assert_array_equal(mp, mx)
    differ = rp != rx
    assert differ.sum() > 0 and (rp[differ] >= w).all()
    assert differ[:, 40:60].any()
    port = td.disparity_winner_maps(_t(left), _t(right), **kw)
    assert (port[2].numpy() < w).all()
    _check_maps(left, right, (bx, mx, rx), port, np.ones((h, w), bool))


def test_golden_model_matches_plain_full_search():
    """The reference's direct-SSD golden model, copied into the port, agrees
    with the reference's own exactly and with the port's plain full search
    except at near-ties (24x64, every selected pixel)."""
    ls, rs = _render(24, 64, 37.0)
    sel = jsel.select_points(jnp.asarray(ls), boundary=4, block_rows=2, block_cols=4,
                             grad_th=8.0, max_points_per_block=80)
    kw = dict(fx=37.0, baseline=0.537, boundary=4, ssd_th=900.0)
    golden = td.disparity_search_reference(ls, rs, np.asarray(sel), **kw)
    for a, b in zip(golden, jd.disparity_search_reference(ls, rs, sel, **kw)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert np.asarray(sel).sum() > 50 and golden[2].sum() > 20
    rt = td.disparity_search(_t(ls), _t(rs), _t(np.asarray(sel)), **kw)
    disp, inv_depth, matched, best = golden
    assert (matched != rt.matched.numpy()).sum() <= 2
    both = matched & rt.matched.numpy()
    flips = both & (disp != rt.disparity.numpy())
    assert flips.sum() <= 2
    ys, xs = np.nonzero(flips)
    assert (_near_ties(ls, rs, ys, xs, (xs - disp[ys, xs]).astype(int),
                       (xs - rt.disparity.numpy()[ys, xs]).astype(int)) < TIE).all()
    np.testing.assert_allclose(rt.best_ssd.numpy()[both], best[both], rtol=512 * 2.0**-23,
                               atol=1.0)


@pytest.mark.parametrize("band", [(None, None), (12, "W"), (12, 64), (12, 192)])
@pytest.mark.parametrize("shape", [(48, 96), (64, 384)])
def test_plain_matches_xla_bitwise_on_exact_ties(shape, band):
    """Integer-valued periodic images (``tie_stereo_pair``): every SSD is
    exact in float32 in both norm expansions, and each query ties exactly
    with candidates a period apart, so the first-minimum rule alone picks
    the winners. best, match and rmatch agree bit for bit, lr on, on the full
    search, accurate_config's band and fast_config-style narrow bands. Both
    CUDA kernels are held to the plain version on the same images on the
    card (tests/test_torch_cuda.py, chip_smoke.py)."""
    from odometry_torch.data.synthetic import TIE_PERIOD, tie_stereo_pair

    h, w = shape
    ls, rs = tie_stereo_pair(h, w, seed=h + w)
    min_d, max_d = band[0], (w if band[1] == "W" else band[1])
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr_check=True)
    ref = jd.disparity_winner_maps(jnp.asarray(ls), jnp.asarray(rs), backend="xla", **kw)
    port = td.disparity_winner_maps(_t(ls), _t(rs), **kw)
    for r, p in zip(ref[:3], port[:3]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    # The images do tie: at many queries the candidate a period past the
    # winner scores the winner's SSD exactly, and the smaller index won.
    best, match = port[0].numpy(), port[1].numpy()
    PL, PR = (td.pattern_stack(_t(a)).numpy() for a in (ls, rs))
    ys, xs = np.nonzero((best < 1e9) & (match + TIE_PERIOD <= np.arange(w) - (min_d or 1)))
    other = np.sum((PL[:, ys, xs] - PR[:, ys, match[ys, xs] + TIE_PERIOD]) ** 2, axis=0)
    assert (other == best[ys, xs]).sum() > 0.25 * h * w
