"""The port on an NVIDIA card: the band and full-search kernels, the dispatcher,
the CUDA path vs the CPU path, the ring all-gather kernel and the sharded BA.

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
from odometry_torch.data.synthetic import render, tie_stereo_pair
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.distributed import ring_exchange
from odometry_torch.distributed.ba_dist import ba_solve_sharded
from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh, spread
from odometry_torch.geometry import se3_exp
from odometry_torch.image.pyramid import gaussian_blur3
from odometry_torch.image.sampling import clip_gather_2d
from odometry_torch.kernels import disparity_band, disparity_full
from odometry_torch.kernels.disparity import disparity_winner_maps, pattern_stack
from odometry_torch.kernels.points import extract_points
from odometry_torch.kernels.select import select_points
from odometry_torch.mapping.ba import BAConfig, BAProblem, ba_solve
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools import kernel_parity

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
    """The first card ("cuda" names every visible card, ROADMAP C16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cards():
    """cards(c): the first c cards; skips where fewer are visible."""

    def first(c):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < c:
            pytest.skip(f"needs {c} CUDA cards, {count} visible")
        return [torch.device("cuda", k) for k in range(c)]

    return first


def _stereo(H, W, seed, dev):
    cam = Pinhole.create(0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    scene = make_scene(seed + 3, depth=14.0, device=dev)
    left, right, _ = render_stereo(scene, cam, 0.537, torch.eye(4), H, W)
    return gaussian_blur3(left).contiguous(), gaussian_blur3(right).contiguous()


def _ssd(PL, PR, y, x, xr):
    return ((PL[:, y, x] - PR[:, y, xr]) ** 2).sum(dim=0)


def _check_kernel_against_plain(kernel, plain, counter, ls, rs, **kw):
    """`kernel` (which counts its launches in module `counter`) against its
    plain version on the same inputs: winners differ only at near-ties, on
    at most 1% of pixels; best and second within the near-tie band."""
    H, W = ls.shape
    before = counter.LAUNCHES
    bk, mk, rk, sk = kernel(ls, rs, **kw)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + 1
    bp, mp, rp, sp = plain(ls, rs, **kw)
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


@pytest.mark.parametrize("shape", [(48, 256, 64), (64, 384, 192)])
def test_band_kernel_matches_plain(card, shape):
    H, W, D = shape
    ls, rs = _stereo(H, W, 0, card)
    _check_kernel_against_plain(disparity_band.disparity_band, disparity_band.disparity_band_plain,
                                disparity_band, ls, rs, boundary=4, min_disparity=None,
                                max_disparity=D, lr=True, second_best=True)


@pytest.mark.parametrize("band", [(None, None), (12, None), (12, 300)])
@pytest.mark.parametrize("shape", [(48, 96), (64, 384)])
def test_full_kernel_matches_plain(card, shape, band):
    H, W = shape
    ls, rs = _stereo(H, W, 0, card)
    _check_kernel_against_plain(disparity_full.disparity_full, disparity_full.disparity_full_plain,
                                disparity_full, ls, rs, boundary=4, min_disparity=band[0],
                                max_disparity=band[1], lr=True, second_best=True)


@pytest.mark.parametrize("band", [(None, None), (12, "W")])
@pytest.mark.parametrize("shape", [(48, 96), (64, 384)])
def test_full_kernel_equals_plain_on_exact_ties(card, shape, band):
    """On ``tie_stereo_pair`` images every SSD is exact in both forms and
    ties a period apart: the kernel's packed-key reductions must pick the
    plain version's first minima, bit for bit (best, match, rmatch)."""
    H, W = shape
    ls, rs = (torch.from_numpy(a).to(card) for a in tie_stereo_pair(H, W, seed=H + W))
    kw = dict(boundary=4, min_disparity=band[0],
              max_disparity=W if band[1] == "W" else band[1], lr=True)
    got = disparity_full.disparity_full(ls, rs, **kw)
    want = disparity_full.disparity_full_plain(ls, rs, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


# (H, W, min_disparity, max_disparity): fast_config-style bands, the KITTI
# shape, widths that are not a multiple of 128, and a band ([12, 28]) narrower
# than the band kernel's blocking's spread of 24 offsets.
BAND_TIE_CASES = [(48, 256, None, 64), (64, 384, 12, 192), (376, 1241, 12, 192),
                  (48, 200, 12, 40), (48, 200, 12, 28)]


@pytest.mark.parametrize("H,W,min_d,max_d", BAND_TIE_CASES)
def test_band_kernel_equals_plain_on_exact_ties(card, H, W, min_d, max_d):
    """The band kernel's packed-key reductions pick the plain version's first
    minima on ``tie_stereo_pair`` images, bit for bit (best, match, rmatch)."""
    ls, rs = (torch.from_numpy(a).to(card) for a in tie_stereo_pair(H, W, seed=H + W))
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=True)
    got = disparity_band.disparity_band(ls, rs, **kw)
    want = disparity_band.disparity_band_plain(ls, rs, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tie", [False, True])
def test_full_kernel_equals_band_kernel(card, tie):
    """Both kernels score pairs with ssd8(): on one band they agree bit for
    bit on best, match, rmatch and second."""
    H, W = 64, 384
    if tie:
        ls, rs = (torch.from_numpy(a).to(card) for a in tie_stereo_pair(H, W, seed=3))
    else:
        ls, rs = _stereo(H, W, 7, card)
    kw = dict(boundary=4, min_disparity=12, max_disparity=192, lr=True, second_best=True)
    full = disparity_full.disparity_full(ls, rs, **kw)
    band = disparity_band.disparity_band(ls, rs, **kw)
    for a, b in zip(full, band):
        assert torch.equal(a, b)


def test_full_kernel_refuses_what_it_does_not_take(card):
    ls, rs = _stereo(48, 96, 0, card)
    kw = dict(boundary=4, min_disparity=None, max_disparity=None, lr=False)
    with pytest.raises(ValueError):
        disparity_full.disparity_full(ls.double(), rs.double(), **kw)
    with pytest.raises(ValueError):
        disparity_full.disparity_full(ls.cpu(), rs.cpu(), **kw)
    with pytest.raises(ValueError):
        disparity_full.disparity_full(ls.t(), rs.t(), **kw)
    with pytest.raises(ValueError, match="empty band"):
        disparity_full.disparity_full(ls, rs, boundary=4, min_disparity=80, max_disparity=64,
                                      lr=False)


def test_dispatcher_routes_as_the_reference(card):
    ls, rs = _stereo(48, 384, 0, card)
    for max_d, launched in ((192, disparity_band), (300, disparity_full),
                            (None, disparity_full)):
        counts = (disparity_band.LAUNCHES, disparity_full.LAUNCHES)
        disparity_winner_maps(ls, rs, boundary=4, max_disparity=max_d, lr_check=True)
        torch.cuda.synchronize()
        after = (disparity_band.LAUNCHES, disparity_full.LAUNCHES)
        expect = (counts[0] + (launched is disparity_band), counts[1] + (launched is disparity_full))
        assert after == expect


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
    # A row that does not fit one block is refused only on the one-block route.
    wide = torch.zeros((8, 6000), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        disparity_band.disparity_band(wide, wide, force_route=disparity_band.ONE_BLOCK, **kw)


# (kernel, min_disparity, max_disparity) at 8 x 6000, past both one-block
# limits (4,629 columns with lr, 5,606 without): B1 on fast_config's band,
# B2 on the full search and on the band [12, 1241].
WIDE_CASES = [("band", 12, 192), ("full", None, None), ("full", 12, 1241)]


@pytest.mark.parametrize("lr", [False, True])
@pytest.mark.parametrize("kernel,min_d,max_d", WIDE_CASES)
def test_wide_rows_take_the_tiled_route_bit_for_bit(card, kernel, min_d, max_d, lr):
    """Rows wider than a block's shared memory go through the tiled route
    (three launches) and give the plain version's bits on tie images."""
    H, W = 8, 6000
    assert disparity_band.route(W, lr) == disparity_band.TILED
    ls, rs = (torch.from_numpy(a).to(card) for a in tie_stereo_pair(H, W, seed=H + W))
    mod = disparity_band if kernel == "band" else disparity_full
    fn = disparity_band.disparity_band if kernel == "band" else disparity_full.disparity_full
    kw = dict(boundary=4, min_disparity=min_d, max_disparity=max_d, lr=lr)
    before = mod.LAUNCHES
    got = fn(ls, rs, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + disparity_band.TILED_LAUNCHES
    want = disparity_band.disparity_band_plain(ls, rs, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("kernel", ["band", "full"])
def test_tiled_route_equals_one_block_route_at_kitti_size(card, kernel, tie):
    """At 376 x 1241 (one-block route) the tiled route, forced, gives the same
    bits on all four maps."""
    H, W = 376, 1241
    if tie:
        ls, rs = (torch.from_numpy(a).to(card) for a in tie_stereo_pair(H, W, seed=5))
    else:
        ls, rs = _stereo(H, W, 0, card)
    fn = disparity_band.disparity_band if kernel == "band" else disparity_full.disparity_full
    kw = dict(boundary=4, min_disparity=12, max_disparity=192 if kernel == "band" else None,
              lr=True, second_best=True)
    one = fn(ls, rs, force_route=disparity_band.ONE_BLOCK, **kw)
    tiled = fn(ls, rs, force_route=disparity_band.TILED, **kw)
    for a, b in zip(one, tiled):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel,shape,images,max_d,force", kernel_parity.BATCH_CASES)
def test_batch_in_one_launch_equals_single_launches(card, kernel, shape, images, max_d, force):
    """B1 and B2 on (B, H, W) (the sweep's batched depth run): one call (one
    launch, three on the tiled route) gives each image the bits of its own
    call, on all four maps."""
    B, H, W = shape
    ls, rs = kernel_parity.batch_images(shape, images)
    mod = disparity_band if kernel == "band" else disparity_full
    fn = mod.disparity_band if kernel == "band" else mod.disparity_full
    kw = dict(boundary=4, min_disparity=12, max_disparity=max_d, lr=True, second_best=True,
              force_route=force)
    tiled = (force or disparity_band.route(W, True)) == disparity_band.TILED
    before = mod.LAUNCHES
    got = fn(ls, rs, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + (disparity_band.TILED_LAUNCHES if tiled else 1)
    for b in range(B):
        for a, e in zip(got, fn(ls[b], rs[b], **kw)):
            assert torch.equal(a[b], e)


def test_batched_sweep_on_the_card_follows_run_sequence(card):
    """Three sequences as one batch on one rank of the card: each sequence's
    keyframes are run_sequence's and its poses within the "mm" tracker's
    tolerance; one B1 launch per batched depth run."""
    from odometry_torch.distributed.sweep import run_sweep

    cam = Pinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0, device="cpu")
    seqs = [[tuple(a.numpy() for a in render_stereo(scene, cam, 0.537, T, HS, WS)[:2])
             for T in drive_trajectory(9, step=0.35, seed=seed)] for seed in (4, 5, 11)]
    singles = [run_sequence(frames, CFG, device=card) for frames in seqs]
    runs = []
    before = disparity_band.LAUNCHES
    poses = run_sweep(seqs, CFG, sequence_mesh(1, card),
                      progress=lambda i, st, outs, ok: runs.append(
                          outs is None or bool(((outs[0].summary[:, 37] > 0)
                                                | (outs[0].summary[:, 34] < 0.5)).any())))
    assert disparity_band.LAUNCHES - before == sum(runs)
    for s, single in enumerate(singles):
        np.testing.assert_allclose(poses[s][:, :3, 3], single.poses[:, :3, 3], rtol=0, atol=0.05)


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


# (ranks, shard shape, dtype, storage offset in elements): chip_smoke.py's
# phase-9 cases. The float32 ones copy in 16-byte vectors, the last of them
# the full width of a 7-keyframe window of fast_config point blocks per rank;
# a 30-byte float16 shard, a 35-byte int8 shard and a float32 shard 4 bytes
# into its storage take the kernel's byte and 4-byte paths.
RING_CASES = [(1, (4, 128), torch.float32, 0), (2, (3, 4, 4), torch.float32, 0),
              (3, (5, 4, 4), torch.float32, 0), (8, (4, 128), torch.float32, 0),
              (8, (3, 4, 4), torch.float32, 0), (8, (7, 16384), torch.float32, 0),
              (3, (3, 5), torch.float16, 0), (8, (5, 7), torch.int8, 0),
              (4, (6, 33), torch.float32, 1)]


def _ring_shards(num, shape, dtype, offset, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = int(np.prod(shape))
    if dtype.is_floating_point:
        base = [torch.randn(n + offset, generator=g).to(dtype) for _ in range(num)]
    else:
        base = [torch.randint(-128, 128, (n + offset,), generator=g).to(dtype)
                for _ in range(num)]
    devs = dev if isinstance(dev, list) else [dev] * num
    return [b.to(d)[offset:].view(shape) for b, d in zip(base, devs)]


@pytest.mark.parametrize("num,shape,dtype,offset", RING_CASES)
def test_ring_kernel_matches_plain_bitwise(card, num, shape, dtype, offset):
    shards = _ring_shards(num, shape, dtype, offset, card, seed=num * 100 + shape[0])
    assert shards[0].storage_offset() == offset
    before = ring_exchange.LAUNCHES
    outs = ring_exchange.ring_all_gather(shards, sequence_mesh(num, card), axis="seq")
    torch.cuda.synchronize()
    assert ring_exchange.LAUNCHES == before + 1  # one launch per call
    plain = ring_exchange.ring_gather_plain(shards)
    full = torch.cat(shards)
    for o, p in zip(outs, plain):
        assert o.device == shards[0].device and o.dtype == dtype
        assert torch.equal(o, p) and torch.equal(o, full)


def test_ring_kernel_repeats_back_to_back(card):
    """200 launches with no host read between them; every output of every
    launch is compared on the card."""
    shards = [torch.randn((7, 16384), device=card) for _ in range(8)]
    full = torch.cat(shards)
    bad = torch.zeros((), dtype=torch.int64, device=card)
    for _ in range(200):
        bad += sum((o != full).any().long() for o in ring_exchange.ring_gather(shards))
    assert int(bad) == 0


@pytest.mark.parametrize("num,shape,dtype,offset", RING_CASES)
def test_ring_per_shard_route_matches_plain_bitwise(card, num, shape, dtype, offset):
    """force_route="per_shard" on virtual ranks of one card: one launch per
    shard, through the multi-card route's host code, bit for bit."""
    shards = _ring_shards(num, shape, dtype, offset, card, seed=num * 100 + shape[0])
    before = ring_exchange.LAUNCHES
    outs = ring_exchange.ring_gather(shards, force_route="per_shard")
    torch.cuda.synchronize()
    assert ring_exchange.LAUNCHES == before + num
    full = torch.cat(shards)
    assert all(torch.equal(o, full) for o in outs)


@pytest.mark.parametrize("route", [None, "per_shard"])
@pytest.mark.parametrize("num,shape,dtype,offset", RING_CASES)
@pytest.mark.parametrize("c", [2, 4])
def test_ring_across_cards_matches_plain_bitwise(cards, c, num, shape, dtype, offset, route):
    """B3 with rank r on card r * c // num (8 ranks on 4 cards: 2 each): one
    launch per card that holds shards (per shard on that route), every
    output on its rank's card, bit for bit against the plain version and
    torch.cat; no shard copied."""
    devs = spread(cards(c), num)
    shards = _ring_shards(num, shape, dtype, offset, devs, seed=num * 100 + shape[0])
    assert shards[-1].storage_offset() == offset
    before = ring_exchange.LAUNCHES
    outs = ring_exchange.ring_gather(shards, force_route=route)
    for d in set(devs):
        torch.cuda.synchronize(d)
    assert ring_exchange.LAUNCHES - before == len(ring_exchange.launch_plan(devs, route))
    plain = ring_exchange.ring_gather_plain(shards)
    for o, p, d in zip(outs, plain, devs):
        assert o.device == d and o.dtype == dtype
        assert torch.equal(o, p) and torch.equal(o, torch.cat([s.to(d) for s in shards]))


def test_ring_across_cards_repeats_back_to_back(cards):
    """200 gathers over 2 (or 4) cards with no host read between them; every
    output of every gather is compared on its card."""
    devs = cards(4) if torch.cuda.device_count() >= 4 else cards(2)
    shards = [torch.randn((7, 16384), device=d) for d in devs]
    fulls = [torch.cat([s.to(d) for s in shards]) for d in devs]
    bad = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
    for _ in range(200):
        for k, (o, full) in enumerate(zip(ring_exchange.ring_gather(shards), fulls)):
            bad[k] = bad[k] + (o != full).any()
    assert sum(int(b) for b in bad) == 0


def test_two_card_sweep_equals_one_card_batch(cards):
    """run_sweep over 2 cards, 2 sequences each: each card's lanes equal the
    same 2 sequences as one batch on the first card, bit for bit."""
    from odometry_torch.distributed.sweep import run_sweep

    devs = cards(2)
    cam = Pinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0, device="cpu")
    seqs = [[tuple(a.numpy() for a in render_stereo(scene, cam, 0.537, T, HS, WS)[:2])
             for T in drive_trajectory(6, step=0.35, seed=seed)] for seed in (4, 5, 11, 12)]
    both = run_sweep(seqs, CFG, sequence_mesh(device=devs))
    for k in range(2):
        alone = run_sweep(seqs[2 * k:2 * k + 2], CFG, sequence_mesh(device=devs[:1]))
        np.testing.assert_array_equal(both[2 * k:2 * k + 2], alone)


def test_sharded_ba_across_cards(card, cards):
    """ba_solve_sharded over grid_mesh(1, 4) on 2 or 4 cards against
    ba_solve on the first: poses 2e-4, inverse depths 1e-4."""
    devs = spread(cards(4 if torch.cuda.device_count() >= 4 else 2), 4)
    prob, cam = _ba_problem(card)
    cfg = BAConfig(window=4, iters=3, fix_depths=True)
    single = ba_solve(prob, cam, cfg)
    sharded = ba_solve_sharded(prob, cam, grid_mesh(1, 4, devs), cfg)
    torch.testing.assert_close(sharded.pose, single.pose, rtol=0, atol=2e-4)
    torch.testing.assert_close(sharded.inv_depth, single.inv_depth, rtol=0, atol=1e-4)
    assert int(sharded.num_residuals) == int(single.num_residuals)


def test_ring_on_several_devices_raises_without_copying(card):
    """Shards on the CPU and on a card: the kernel takes cards only."""
    shards = [torch.ones((2, 8), device=card), torch.ones((2, 8))]
    before = ring_exchange.LAUNCHES
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="cards only"):
        ring_exchange.ring_gather(shards)
    assert ring_exchange.LAUNCHES == before
    assert torch.cuda.memory_allocated() == allocated
    assert shards[1].device.type == "cpu"


# Across processes: two worker processes of tools/multichip.py share card 0
# (gloo for the host steps; CUDA IPC within one device).
ACROSS_CASES = [c for c in RING_CASES if c[0] >= 2]
# Shards of no bytes: the gather launches nothing, and the processes' host
# steps stay in step for the repeats after it.
EMPTY_CASE = (2, (0, 4), torch.float32, 0)


@pytest.fixture(scope="module")
def two_processes_on_one_card():
    """Both workers' records: the ring cases across them and EMPTY_CASE, 200
    gathers with ``torch.cuda.empty_cache()`` after every 7th, and ``ba_solve_sharded``
    over ``grid_mesh(1, 2)`` on _ba_problem across them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from odometry_torch.tools import multichip

    prob, _ = _ba_problem(torch.device("cpu"))
    job = {"ring_cases": ACROSS_CASES + [EMPTY_CASE], "ring_repeats": (200, 7, (7, 16384)),
           "ba": {"problem": tuple(prob), "camera": (240.0, 240.0, 80.0, 48.0), "iters": 3}}
    return multichip.per_process([[], []], 0, cards=[0, 0], job=job, timeout=600)


@pytest.mark.parametrize("i", range(len(ACROSS_CASES)))
def test_ring_across_two_processes_on_one_card(two_processes_on_one_card, i):
    """B3 across two processes of one card through CUDA IPC: every rank's
    gather equals the plain ring and torch.cat bit for bit, one launch per
    process and gather."""
    for rec in two_processes_on_one_card:
        assert bool(rec[f"case{i}_ok"]) and float(rec[f"case{i}_err"]) == 0.0
        assert int(rec[f"case{i}_launches"]) == 1


def test_empty_ring_across_processes_launches_nothing(two_processes_on_one_card):
    """Shards of no bytes across the two processes: an empty gather equal to
    the plain ring and torch.cat, no launch."""
    i = len(ACROSS_CASES)
    for rec in two_processes_on_one_card:
        assert bool(rec[f"case{i}_ok"]) and int(rec[f"case{i}_launches"]) == 0


def test_ring_across_processes_repeats_with_empty_cache(two_processes_on_one_card):
    """200 back-to-back gathers across the two processes, the caching
    allocator's segments released after every 7th (a peer's new allocation
    over an old one's addresses closes the old mapping): 0 outputs differ."""
    for rec in two_processes_on_one_card:
        assert int(rec["repeats_bad"]) == 0
        assert int(rec["ring_launches"]) == len(ACROSS_CASES) + 200 + 3 * 6 * 2 + 1 * 2


@pytest.mark.parametrize("fix_depths", [True, False])
def test_sharded_ba_across_two_processes_equals_one_process(two_processes_on_one_card, card,
                                                            fix_depths):
    """ba_solve_sharded over grid_mesh(1, 2) across the two processes equals
    it over grid_mesh(1, 2) of one process, bit for bit."""
    prob, cam = _ba_problem(card)
    one = ba_solve_sharded(prob, cam, grid_mesh(1, 2, card),
                           BAConfig(window=4, iters=3, fix_depths=fix_depths))
    for rec in two_processes_on_one_card:
        for k in ("pose", "inv_depth", "cost_initial", "cost_final", "num_residuals"):
            np.testing.assert_array_equal(rec[f"ba_{int(fix_depths)}_{k}"],
                                          getattr(one, k).cpu().numpy())
        # one launch per gather: six partial sums per iteration and the depths, per solve
        assert int(rec["path_ring_launches"]) == 2 * (6 * 3 + 1)


def _ba_problem(dev, K=4, P=512, H=96, W=160, seed=31, pose_noise=0.02):
    """tests/test_ba.py's fixture built with the port: K views of a tilted
    plane 0.35 m apart, P selected points each, poses 1..K-1 perturbed."""
    cam = Pinhole.create(240.0, 240.0, W / 2.0, H / 2.0)
    scene = make_scene(seed, depth=11.0, device="cpu")
    rng = np.random.default_rng(seed)
    poses, T = [], torch.eye(4)
    for _ in range(K):
        poses.append(T.clone())
        xi = torch.tensor([0.35, 0.02 * rng.standard_normal(), 0.05, 0, 0.002, 0],
                          dtype=torch.float32)
        T = T @ se3_exp(xi)
    imgs, xs, ys, inv, inten, valid = [], [], [], [], [], []
    for k in range(K):
        img, z = render(scene, cam, poses[k], H, W)
        sel = select_points(gaussian_blur3(img), boundary=4, block_rows=8, block_cols=16,
                            grad_th=8.0, max_points_per_block=80)
        pts = extract_points(1.0 / z, sel, P)
        imgs.append(img)
        xs.append(pts.xs)
        ys.append(pts.ys)
        inv.append(pts.inv_depth)
        inten.append(clip_gather_2d(img, pts.ys.long(), pts.xs.long()))
        valid.append(pts.valid)
    for k in range(1, K):
        xi = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
        xi[:3] *= pose_noise
        xi[3:] *= pose_noise * 0.1
        poses[k] = poses[k] @ se3_exp(xi)
    prob = BAProblem(torch.stack(imgs), torch.stack(xs), torch.stack(ys), torch.stack(inv),
                     torch.stack(inten), torch.stack(valid), torch.stack(poses),
                     torch.ones(K, dtype=torch.bool))
    return BAProblem(*(a.to(dev) for a in prob)), cam


@pytest.mark.parametrize("fix_depths", [True, False])
def test_sharded_ba_on_the_card(card, fix_depths):
    """ba_solve_sharded on 8 model ranks of one card against ba_solve there:
    poses 2e-4, inverse depths 1e-4 (tests/test_distributed.py:81-87)."""
    prob, cam = _ba_problem(card)
    cfg = BAConfig(window=4, iters=3, fix_depths=fix_depths)
    single = ba_solve(prob, cam, cfg)
    sharded = ba_solve_sharded(prob, cam, grid_mesh(1, 8, card), cfg)
    assert sharded.pose.is_cuda and sharded.inv_depth.is_cuda
    torch.testing.assert_close(sharded.pose, single.pose, rtol=0, atol=2e-4)
    torch.testing.assert_close(sharded.inv_depth, single.inv_depth, rtol=0, atol=1e-4)
    assert int(sharded.num_residuals) == int(single.num_residuals) > 2000
    assert float(single.cost_final) <= float(single.cost_initial)


def test_native_loader_into_pinned_tensors(card, tmp_path):
    """StereoPrefetcher(pin_memory=True) decodes straight into page-locked
    tensors, equal to data/png.py's native-rule decode, and they copy to the
    card asynchronously. Skips where g++ or zlib's header is missing."""
    from odometry_torch.data import native_loader, png

    try:
        native_loader._load()
    except native_loader.NativeLoaderUnavailable as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    rng = np.random.default_rng(0)
    lefts, rights = [], []
    for i in range(3):
        for eye, paths in (("l", lefts), ("r", rights)):
            p = str(tmp_path / f"{eye}{i}.png")
            png.write_png(p, rng.integers(0, 256, (40, 72)).astype(np.uint8))
            paths.append(p)
    stream = list(native_loader.StereoPrefetcher(lefts, rights, 40, 72, pin_memory=True))
    assert len(stream) == 3
    for (left, right), lp, rp in zip(stream, lefts, rights):
        assert left.is_pinned() and right.is_pinned()
        on_card = left.to(card, non_blocking=True)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(on_card.cpu().numpy(), png.read_gray(lp, rule="native"))
        np.testing.assert_array_equal(right.numpy(), png.read_gray(rp, rule="native"))


def test_cli_run_kitti_fast_on_the_card_gives_the_cpu_keyframes(card, tmp_path, capsys):
    """run-kitti --config fast at 144x320 from PNGs on disk: the card (B1
    launched) and the CPU promote the same keyframes and fail nowhere."""
    import json

    from odometry_torch import cli
    from odometry_torch.data import png
    from odometry_torch.data.synthetic import make_driving_scene, stereo_sequence
    from odometry_torch.eval.export import save_kitti_poses

    fx = 180.0
    cam = Pinhole.create(fx, fx, WS / 2.0, HS / 2.0)
    poses = drive_trajectory(13, step=0.35, seed=4)
    frames = list(stereo_sequence(make_driving_scene(3, device="cpu"), cam, 0.537, poses, HS, WS))
    allv = np.concatenate([im.ravel() for f in frames for im in f])
    lo, hi = np.percentile(allv, 2.0), np.percentile(allv, 98.0)
    q = lambda im: np.clip(np.round((im - lo) * 255.0 / (hi - lo)), 0, 255).astype(np.uint8)
    base = tmp_path / "dataset" / "sequences" / "00"
    for i, (left, right) in enumerate(frames):
        for d, im in (("image_0", left), ("image_1", right)):
            (base / d).mkdir(parents=True, exist_ok=True)
            png.write_png(str(base / d / f"{i:06d}.png"), q(im))
    P = f"{fx} 0 {WS / 2.0} 0 0 {fx} {HS / 2.0} 0 0 0 1 0"
    P1 = f"{fx} 0 {WS / 2.0} {-fx * 0.537} 0 {fx} {HS / 2.0} 0 0 0 1 0"
    (base / "calib.txt").write_text(f"P0: {P}\nP1: {P1}\n")
    save_kitti_poses(str(tmp_path / "poses" / "00.txt"), poses)
    reports = {}
    for dev in ("cuda", "cpu"):
        disparity_band.LAUNCHES = 0
        assert cli.main(["run-kitti", "--data", str(tmp_path), "--frames", "13", "--config",
                         "fast", "--lazy-depth", "--out", str(tmp_path / dev), "--dump-vis",
                         "--device", dev]) == 0
        reports[dev] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if dev == "cuda":
            assert disparity_band.LAUNCHES >= reports[dev]["keyframes"] >= 2
    assert reports["cuda"]["failed_at"] is None and reports["cpu"]["failed_at"] is None
    ids = lambda dev: (tmp_path / dev / "vis" / "keyframe_ids" / "keyframe_id.txt").read_text()
    assert reports["cuda"]["keyframes"] == reports["cpu"]["keyframes"]
    assert ids("cuda") == ids("cpu")


def test_kernel_parity_harness_passes_every_case(card):
    """odometry_torch/tools/kernel_parity.py: tools/tpu_parity.py's band,
    full and dense cases at its sizes, and the presets' cases."""
    from odometry_torch.tools import kernel_parity

    assert kernel_parity.main([]) == 0


def test_scaling_report_times_the_card(card):
    from odometry_torch.distributed.scaling import sweep_scaling_report

    rows = sweep_scaling_report(CFG, [1, 2], timed=True)
    assert [r["n"] for r in rows] == [1, 2]
    assert all(r["steps_per_s"] > 0 for r in rows)
    assert [r["collective_bytes"] for r in rows] == [8, 12]
    # Rank 0 steps the same sequence at both sizes: the mesh adds only the
    # health reduction's few operations to its work. (The other rank's
    # scene may need more LM iterations: work depends on the data.)
    assert 0 < rows[1]["ops_by_rank"][0] - rows[0]["ops_by_rank"][0] <= 4


def test_device_trace_sees_the_cards_kernels(card, tmp_path):
    from odometry_torch.utils.profiling import device_trace, trace_summary

    left, right = _stereo(HS, WS, 0, card)
    with device_trace(str(tmp_path)) as prof:
        disparity_band.LAUNCHES = 0
        compute_depth(left, right, CAM_CFG, CFG.depth)
    summ = trace_summary(prof)
    assert summ["device_busy_ms"] > 0 and summ["device_launches"] >= disparity_band.LAUNCHES >= 1
    assert 0.0 <= summ["idle_share"] < 1.0
    assert any("band_kernel" in op["name"] for op in trace_summary(prof, top=None)["top_device_ops"])
    assert list(tmp_path.glob("trace-*.json"))


def test_bench_gate_and_line_on_the_card(card):
    """odometry_torch/tools/bench.py at KITTI size, cut to 13 frames: the
    median-mte gate holds (it raises otherwise) and the JSON line is
    bench.py's; B1 only, once per depth run."""
    import json

    from odometry_torch.tools import bench

    disparity_band.LAUNCHES = disparity_full.LAUNCHES = 0
    line, records = bench.bench(num_frames=13, device=card)
    runs = sum(r["depth_runs"] for r in records)
    assert disparity_full.LAUNCHES == 0 and disparity_band.LAUNCHES >= runs >= 3
    assert set(json.loads(json.dumps(line))) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench.METRIC and line["value"] > 0


def test_default_sweep_is_one_rank_on_the_card(card):
    """sequence_mesh() has one rank per visible card (ROADMAP C16), and on
    one card run_sweep without a mesh steps the three sequences as one
    batch: one B1 launch per batched depth run (ROADMAP C14)."""
    from odometry_torch.distributed.sweep import run_sweep

    assert sequence_mesh().shape == {"seq": torch.cuda.device_count()}
    assert sequence_mesh(device=card).shape == {"seq": 1}
    cam = Pinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0, device="cpu")
    seqs = [[tuple(a.numpy() for a in render_stereo(scene, cam, 0.537, T, HS, WS)[:2])
             for T in drive_trajectory(6, step=0.35, seed=seed)] for seed in (4, 5, 11)]
    runs, sizes = [], []

    def progress(i, states, outs, ok):
        sizes.append([s.cur_pose.shape[0] for s in states])
        runs.append(outs is None or bool(((outs[0].summary[:, 37] > 0)
                                          | (outs[0].summary[:, 34] < 0.5)).any()))

    before = disparity_band.LAUNCHES
    run_sweep(seqs, CFG, device=card, progress=progress)
    assert sizes == [[3]] * 6
    assert disparity_band.LAUNCHES - before == sum(runs)


@pytest.mark.parametrize("interp", ["bilinear", "mm"])
def test_graph_replay_of_the_lm_body_is_eager_bit_for_bit(card, interp):
    """The microbench's LM body (tools/microbench.py) captures in a CUDA
    graph: one replay rewrites the eager call's delta bit for bit, and the
    graph's time per body is a device time above 0."""
    from odometry_torch.tools import microbench
    from odometry_torch.utils.profiling import capture, graph_ms

    body = microbench.lm_body(microbench.lm_inputs(8192), interp, card)
    eager = body()
    graph, replayed = capture(body)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert graph_ms(body, reps=5, replays=2) > 0


def test_device_time_is_at_most_wall_time(card):
    from odometry_torch.tools import microbench
    from odometry_torch.utils.profiling import device_ms, wall_ms

    body = microbench.lm_body(microbench.lm_inputs(8192), "mm", card)
    assert 0 < device_ms(body, 10) <= wall_ms(body, 10)


def test_roofline_row_one_is_phase_fours_bound(card):
    """Row 1 of odometry_torch/tools/roofline.py: B1 on fast_config's band
    [12, 192] with lr at 376x1241, bound by its operations, 0.0277 ms."""
    from odometry_torch.tools import roofline

    rows = roofline.rows(device=card, reps=5, log=lambda s: None)
    assert len(rows) == 4 and all(r["measured_ms"] > 0 for r in rows)
    ms, by = roofline.search_bound(376, 1241, 4, 12, 192, True)
    assert (rows[0]["bound_ms"], rows[0]["bound_by"]) == (ms, by) == (ms, "operations")
    assert round(ms, 4) == 0.0277
