"""Stereo semi-dense inverse-depth frontend, point-lane path (port of
``depth/estimator.py``; reference ``DepthEstimator``, ``depth_estimate.cpp``).

select -> SSD search -> extraction -> lane finalize -> inverse-depth
refinement -> filter -> scatter to dense maps. :func:`refine_depth` is the
dense (H, W) form of the refinement (the reference's, not on its
``compute_depth`` path).

Index hazards of the port: JAX clamps out-of-bounds gathers and drops
out-of-bounds scatter updates, torch raises (or asserts on the device).
Blocked extraction leaves padded lanes with ``ys >= H`` or ``xs >= W``; their
gather indices are clamped here and their scatter updates are masked out.

Batches: every function takes one image pair (H, W) or a batch (B, H, W)
(the counterpart of the reference's ``jax.vmap``); :func:`compute_depth` on a
batch makes one SSD kernel launch, and its refinement one host read per LM
iteration for the whole batch. The refinement loop keeps a per-image
``active`` mask: an image whose loop has stopped keeps its carry while the
others go on, so its result and iteration count are its own run's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from odometry_torch.config import CameraConfig, DepthConfig
from odometry_torch.image.pyramid import central_gradients, gaussian_blur3
from odometry_torch.image.sampling import clip_gather_2d, sample_bilinear, sample_channels_mm
from odometry_torch.kernels.disparity import disparity_winner_maps
from odometry_torch.kernels.points import PointSet, extract_points
from odometry_torch.kernels.select import block_median_map, select_points
from odometry_torch.utils.batch import batch_of_one, lane
from odometry_torch.utils.profiling import span

_SENTINEL = -1000.0  # depth_estimate.cpp:221


class DepthResult(NamedTuple):
    """One pair's products; a batch carries a leading axis B on each."""

    valid: torch.Tensor  # (H, W) bool final validity mask
    disparity: torch.Tensor  # (H, W) raw search disparity (pixels)
    inv_depth: torch.Tensor  # (H, W) refined inverse depth (1/m), 0 where invalid
    ok: torch.Tensor  # bool: >= min_valid_points survivors
    num_valid: torch.Tensor  # int32 survivors
    iters: torch.Tensor  # int32 refinement LM iterations run
    cost: torch.Tensor  # final refinement cost


def _huber_system(r, g, in_bounds, huber_delta, batch_dims: int = 0):
    """Diagonal LM system of the per-lane residual r with slope g; the cost
    is the mean over all but the `batch_dims` leading axes (one per image)."""
    dims = tuple(range(batch_dims, r.dim()))
    a = torch.abs(r)
    w = torch.where(a <= huber_delta, torch.ones_like(a),
                    a.new_tensor(huber_delta) / torch.clamp(a, min=1e-12))
    ibf = in_bounds.to(torch.float32)
    jtwj = g * g * w * ibf
    b = -g * w * r * ibf
    resid = torch.where(in_bounds, a, torch.full_like(a, _SENTINEL))
    n_act = torch.sum(ibf, dim=dims)
    err = torch.where(n_act > 0, torch.sum(r * r * w * ibf, dim=dims) / torch.clamp(n_act, min=1.0),
                      torch.full_like(n_act, float("inf")))
    return jtwj, b, resid, err


def _refine_loop(eval_system, d0: torch.Tensor, cfg: DepthConfig, clamp=None):
    """The reference's ``DepthOptimization`` LM loop (depth_estimate.cpp:
    141-168) over the lanes of a batch of images, d0 (B, ...): one cost, one
    lambda and one ``active`` flag per image. The loop runs while any image
    is active (read on the host once per iteration) and below max_iters;
    every image's carry is updated only on the iterations where it was
    active, as under the reference's ``vmap`` of its ``while_loop``.

    `clamp(tmp_raw) -> tmp` is the window-patch trust region; lanes it bites
    are marked escaped for good. Returns (current, resid, iters, err_now,
    escaped), iters and err_now (B,).
    """
    dev = d0.device
    B = d0.shape[0]
    lanes = (slice(None),) + (None,) * (d0.dim() - 1)  # (B,) -> broadcast over lanes
    f32 = dict(dtype=torch.float32, device=dev)
    tmp = current = pre = d0
    resid = torch.zeros_like(d0)
    err_last = torch.full((B,), 1e10, **f32)
    err_now = torch.zeros((B,), **f32)
    lam = torch.full((B,), cfg.lambda_init, **f32)
    escaped = torch.zeros(d0.shape, dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    it = 0
    going = True
    while going and it < cfg.max_iters:
        keep = lambda new, old: torch.where(active[lanes], new, old)
        jtwj, b, resid_n, err_n = eval_system(tmp)
        bad = err_n > err_last
        lam_up = lam * cfg.lambda_up
        lam_n = torch.where(bad, lam_up, torch.clamp(lam / cfg.lambda_down, min=cfg.lambda_min))
        break_bad = bad & (lam_up > cfg.lambda_max)
        current_n = torch.where(bad[lanes], pre, tmp)
        break_good = (~bad) & (err_n / err_last > cfg.precision)
        denom = jtwj * (1.0 + lam_n[lanes])
        pos = denom > 0
        delta = torch.where(pos, b / torch.where(pos, denom, torch.ones_like(denom)),
                            torch.zeros_like(denom))
        tmp_n = current_n + delta
        if clamp is not None:
            tmp_c = clamp(tmp_n)
            escaped = keep(escaped | (tmp_c != tmp_n), escaped)
            tmp_n = tmp_c
        current = pre = keep(current_n, current)
        tmp = keep(tmp_n, tmp)
        resid = keep(resid_n, resid)
        err_now = torch.where(active, err_n, err_now)
        err_last = torch.where(active & ~bad, err_n, err_last)
        lam = torch.where(active, lam_n, lam)
        iters = iters + active.to(torch.int32)
        active = active & ~(break_bad | break_good)
        it += 1
        with span("read.depth_refine"):
            going = bool(active.any())
    return current, resid, iters, err_now, escaped


def _eval_system(d: torch.Tensor, left: torch.Tensor, right: torch.Tensor, mask: torch.Tensor,
                 tx_fx: float, huber_delta: float, interp: str = "floor"):
    """Reference ``ComputeResidualJacobian`` (depth_estimate.cpp:200-242),
    dense over a batch (B, H, W): interp "floor" is the reference's integer
    warp, "bilinear" (and "mm", the same semantics here) sample the right
    image at the sub-pixel warp. Returns (jtwj, b, resid, err)."""
    H, W = left.shape[-2:]
    dev = left.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(left.shape)
    ys = torch.arange(H, device=dev)[:, None].expand(left.shape)
    warped_xf = xs - tx_fx * d
    warped_x = torch.floor(torch.clamp(warped_xf, -2.0, W + 2.0)).long()
    in_bounds = (warped_x >= 2) & (warped_x <= W - 2) & mask
    wx = torch.clamp(warped_x, 1, W - 2)
    if interp == "floor":
        r = left - clip_gather_2d(right, ys, wx)
        g = tx_fx * 0.5 * (clip_gather_2d(right, ys, wx + 1) - clip_gather_2d(right, ys, wx - 1))
    elif interp in ("bilinear", "mm"):
        uw = torch.clamp(warped_xf, 1.0, W - 2.0)
        yf = ys.float()
        r = left - sample_bilinear(right, uw, yf)
        g = tx_fx * 0.5 * (sample_bilinear(right, uw + 1.0, yf)
                           - sample_bilinear(right, uw - 1.0, yf))
    else:
        raise ValueError(f"unknown interp mode {interp!r}")
    return _huber_system(r, g, in_bounds, huber_delta, batch_dims=1)


def refine_depth(left: torch.Tensor, right: torch.Tensor, inv_depth0: torch.Tensor,
                 mask: torch.Tensor, cam: CameraConfig, cfg: DepthConfig):
    """Dense diagonal per-pixel inverse-depth LM (``DepthOptimization``,
    depth_estimate.cpp:141-168) over the (H, W) map, or each map of a batch
    (B, H, W). Returns (refined, resid, iters, cost)."""
    if left.dim() == 2:
        return lane(refine_depth(*batch_of_one((left, right, inv_depth0, mask)), cam, cfg), 0)
    tx_fx = cam.baseline * cam.fx
    current, resid, it, err, _ = _refine_loop(
        lambda d: _eval_system(d, left, right, mask, tx_fx, cfg.huber_delta, cfg.interp),
        inv_depth0, cfg)
    return current, resid, it, err


def refine_depth_points(left: torch.Tensor, right: torch.Tensor, pts: PointSet,
                        cam: CameraConfig, cfg: DepthConfig):
    """Full-image point-lane refinement (any interp mode) of a batch of
    pairs (B, H, W) with points (B, cap). `pts.inv_depth` carries the
    search-initialized inverse depth. Returns (refined (B, cap), resid
    (B, cap), iters (B,), cost (B,))."""
    tx_fx = cam.baseline * cam.fx
    H, W = left.shape[-2:]
    ys_i = torch.clamp(pts.ys.long(), max=H - 1)
    xs_f = pts.xs
    left_I = clip_gather_2d(left, ys_i, pts.xs.long())
    gxr, _ = central_gradients(right)
    chan = torch.stack([right, gxr], dim=-3) if cfg.interp == "mm" else None

    def eval_system(d):
        warped_xf = xs_f - tx_fx * d
        warped_x = torch.floor(torch.clamp(warped_xf, -2.0, W + 2.0)).long()
        in_bounds = (warped_x >= 2) & (warped_x <= W - 2) & pts.valid
        wx = torch.clamp(warped_x, 1, W - 2)
        if cfg.interp == "mm":
            uw = torch.clamp(warped_xf, 1.0, W - 2.0)
            Rw, Gw = sample_channels_mm(chan, uw, ys_i.float()).unbind(-2)
            r = left_I - Rw
            g = tx_fx * Gw
        elif cfg.interp == "floor":
            r = left_I - clip_gather_2d(right, ys_i, wx)
            g = tx_fx * clip_gather_2d(gxr, ys_i, wx)
        elif cfg.interp == "bilinear":
            uw = torch.clamp(warped_xf, 1.0, W - 2.0)
            r = left_I - sample_bilinear(right, uw, ys_i.float())
            g = tx_fx * clip_gather_2d(gxr, ys_i, torch.round(uw).long())
        else:
            raise ValueError(f"unknown interp mode {cfg.interp!r}")
        return _huber_system(r, g, in_bounds, cfg.huber_delta, batch_dims=1)

    current, resid, it, err, _ = _refine_loop(eval_system, pts.inv_depth, cfg)
    return current, resid, it, err


def refine_depth_points_patch(left: torch.Tensor, right: torch.Tensor, pts: PointSet,
                              cam: CameraConfig, cfg: DepthConfig, half_width: int = 7):
    """Window-patch inverse-depth refinement (the fast_config path).

    One (cap, 2*half_width+1) window of the right image is gathered around
    each lane's search winner once; every LM iteration then samples the
    resident window (bilinear value, nearest-tap gradient). The attempted
    warp is clamped to the window interior, and a lane the clamp bites is
    marked escaped. A batch of pairs (B, H, W) with points (B, cap); returns
    (refined, resid, iters, cost, escaped), each leading with B.
    """
    tx_fx = cam.baseline * cam.fx
    H, W = left.shape[-2:]
    hw = half_width
    ys_i = torch.clamp(pts.ys.long(), max=H - 1)
    left_I = clip_gather_2d(left, ys_i, pts.xs.long())

    x0f = pts.xs - tx_fx * pts.inv_depth
    base = torch.clamp(torch.round(torch.clamp(x0f, -1.0, float(W))).long(), hw, W - 1 - hw)
    offs = torch.arange(-hw, hw + 1, device=left.device)
    # (B, cap, 2hw+1) window of each lane's row around its search winner.
    patch = clip_gather_2d(right, ys_i[..., None].expand(*ys_i.shape, 2 * hw + 1),
                           base[..., None] + offs)
    gpatch = 0.5 * (patch[..., 2:] - patch[..., :-2])  # (B, cap, 2hw-1)

    base_f = base.float()
    lo = base_f - (hw - 2)
    hi = base_f + (hw - 2)
    taps_p = torch.arange(2 * hw + 1, dtype=torch.float32, device=left.device)
    taps_g = torch.arange(1, 2 * hw, dtype=torch.float32, device=left.device)

    def eval_system(d):
        warped_xf = pts.xs - tx_fx * d
        in_bounds = (warped_xf >= lo) & (warped_xf <= hi) & pts.valid
        relp = torch.clamp(warped_xf - (base_f - hw), 1.0, 2 * hw - 1.0)[..., None]
        val = torch.sum(patch * torch.clamp(1.0 - torch.abs(relp - taps_p), min=0.0), dim=-1)
        grad = torch.sum(gpatch * (torch.abs(relp - taps_g) <= 0.5), dim=-1)
        return _huber_system(left_I - val, tx_fx * grad, in_bounds, cfg.huber_delta,
                             batch_dims=1)

    d_lo = (pts.xs - hi) / tx_fx
    d_hi = (pts.xs - lo) / tx_fx
    return _refine_loop(eval_system, pts.inv_depth, cfg,
                        clamp=lambda t: torch.minimum(torch.maximum(t, d_lo), d_hi))


def _scatter(H, W, ys, xs, vals, keep, reduce):
    """Dense (H, W) map from lane values: ``.at[ys, xs].max/add(vals)`` with
    out-of-bounds lanes dropped (`keep` false). Lanes (B, cap) of a batch
    give (B, H, W): one scatter at the flat index b*H*W + y*W + x, so each
    image's updates meet in its own order, as in its own call."""
    lead = ys.shape[:-1]
    n = math.prod(lead)
    flat = torch.zeros(n * H * W, dtype=vals.dtype, device=vals.device)
    image = torch.arange(n, device=ys.device).reshape(*lead, 1) * (H * W)
    idx = torch.where(keep, image + ys * W + xs, torch.zeros_like(ys)).reshape(-1)
    src = torch.where(keep, vals, torch.zeros_like(vals)).reshape(-1)
    if reduce == "add":
        flat.index_put_((idx,), src, accumulate=True)
    else:
        flat.scatter_reduce_(0, idx, src, reduce="amax", include_self=True)
    return flat.reshape(*lead, H, W)


def search_band(cam: CameraConfig, cfg: DepthConfig) -> tuple[int | None, int | None]:
    """(min_disparity, max_disparity) of the SSD search (None = unbounded).
    With ``range_limited_search`` the band is the one implied by [min_depth,
    max_depth], clamped to the image width (estimator.py:443-452 of the
    reference): fast_config's at KITTI size is [12, 192], accurate_config's
    [12, 1241]."""
    max_disp = cfg.max_disparity
    min_disp = None
    if cfg.range_limited_search:
        band_max = min(int(cam.fx * cam.baseline / cfg.min_depth) + 1, cam.width)
        max_disp = band_max if max_disp is None else min(max_disp, band_max)
        min_disp = max(1, int(cam.fx * cam.baseline / cfg.max_depth))
    return min_disp, max_disp


def compute_depth(left: torch.Tensor, right: torch.Tensor, cam: CameraConfig,
                  cfg: DepthConfig) -> DepthResult:
    """Full frontend, equivalent of ``DepthEstimator::ComputeDepth`` (:33-78),
    of one pair (H, W) or a batch of pairs (B, H, W): one SSD kernel launch
    and one refinement loop for the batch, each image's products its own.
    A batch is the span ``depth.compute``."""
    if left.dim() == 2:
        return lane(compute_depth(left[None], right[None], cam, cfg), 0)
    with span("depth.compute"):
        return _compute_depth(left, right, cam, cfg)


def _compute_depth(left: torch.Tensor, right: torch.Tensor, cam: CameraConfig,
                   cfg: DepthConfig) -> DepthResult:
    """:func:`compute_depth` of a batch (B, H, W)."""
    H, W = left.shape[-2:]
    dev = left.device
    left_s = gaussian_blur3(left)
    right_s = gaussian_blur3(right)
    sel = select_points(left_s, boundary=cfg.boundary, block_rows=cfg.block_rows,
                        block_cols=cfg.block_cols, grad_th=cfg.grad_th,
                        max_points_per_block=cfg.max_points_per_block,
                        min_points_per_block=cfg.min_points_per_block)

    min_disp, max_disp = search_band(cam, cfg)
    best, match, rmatch, second = disparity_winner_maps(
        left_s, right_s, boundary=cfg.boundary, max_disparity=max_disp,
        min_disparity=min_disp, lr_check=cfg.lr_check, second_best=cfg.ratio_test > 0,
        second_excl=cfg.ratio_excl,
    )

    xs_g = torch.arange(W, device=dev)[None, :].expand(H, W)
    extra_ok = torch.ones(left.shape, dtype=torch.bool, device=dev)
    if cfg.ratio_test > 0:
        extra_ok = best <= cfg.ratio_test * second
    if cfg.block_consistency_tol > 0:
        cand = sel & (best <= cfg.ssd_th) & extra_ok
        disp_cand = (xs_g - match).float()
        med = block_median_map(disp_cand, cand, boundary=cfg.boundary,
                               block_rows=cfg.block_rows, block_cols=cfg.block_cols)
        near_med = torch.abs(disp_cand - med) <= cfg.block_consistency_tol
        extra_ok = extra_ok & (~torch.isfinite(med) | near_med)

    cap = min(cfg.max_residuals, cfg.block_rows * cfg.block_cols * cfg.max_points_per_block)
    if cfg.point_order == "blocked":
        # Rank each tile's slots by gradient strength, and spend none on
        # pixels the SSD threshold culls anyway.
        gx, gy = central_gradients(left_s)
        grad = torch.sqrt(gx * gx + gy * gy)
        pts = extract_points(best, sel & (best <= cfg.ssd_th) & extra_ok, cap,
                             order="blocked", priority=grad)
    else:
        pts = extract_points(best, sel, cap, order=cfg.point_order)

    # Lane finalize: the dense _finalize semantics on <= cap lanes.
    ys_raw = pts.ys.long()
    xs_raw = pts.xs.long()
    in_image = (ys_raw < H) & (xs_raw < W)
    ys_l = torch.clamp(ys_raw, max=H - 1)
    xs_l = torch.clamp(xs_raw, max=W - 1)
    best_l = pts.inv_depth  # extraction carried the best-SSD values
    m_l = torch.clamp(clip_gather_2d(match, ys_l, xs_l), 0, W - 1)
    b = cfg.boundary
    in_border = (ys_raw >= b) & (ys_raw < H - b) & (xs_raw >= b) & (xs_raw < W - b)
    matched_l = pts.valid & in_border & (best_l <= cfg.ssd_th)
    if cfg.ratio_test > 0 or cfg.block_consistency_tol > 0:
        matched_l = matched_l & (clip_gather_2d(extra_ok.float(), ys_l, xs_l) > 0.5)
    if cfg.lr_check:
        back_l = clip_gather_2d(rmatch, ys_l, m_l)
        matched_l = matched_l & (torch.abs(back_l - xs_raw) <= cfg.lr_tol)
    disp_l = torch.where(matched_l, (xs_raw - m_l).float(), torch.zeros_like(best_l))
    inv0_l = disp_l / float(cam.fx * cam.baseline)
    pts = pts._replace(inv_depth=inv0_l)
    if not cfg.refine_unmatched:
        pts = pts._replace(valid=pts.valid & matched_l)
    use_patch = cfg.refine_backend == "patch" or (
        cfg.refine_backend == "auto"
        and cfg.interp in ("bilinear", "mm")
        and not cfg.refine_unmatched
        and cfg.refine_max_shift > 0
    )
    if use_patch:
        refined, resid, iters, cost, escaped = refine_depth_points_patch(left, right, pts, cam, cfg)
    else:
        refined, resid, iters, cost = refine_depth_points(left, right, pts, cam, cfg)
        escaped = None

    # Writeback + filtering (depth_estimate.cpp:176-197), per lane.
    photo_bad = (resid > cfg.photo_th) | (resid == _SENTINEL)
    safe = torch.where(refined != 0, refined, torch.full_like(refined, float("inf")))
    depth = 1.0 / safe
    range_bad = (depth > cfg.max_depth) | (depth < cfg.min_depth)
    valid_pt = pts.valid & ~photo_bad & ~range_bad
    if escaped is not None:
        valid_pt = valid_pt & ~escaped
    if cfg.refine_max_shift > 0:
        drift = torch.abs(refined * float(cam.fx * cam.baseline) - disp_l)
        valid_pt = valid_pt & (~matched_l | (drift <= cfg.refine_max_shift))
    vals = torch.where(valid_pt, refined, torch.zeros_like(refined))

    valid = _scatter(H, W, ys_raw, xs_raw, valid_pt.float(), in_image, "amax") > 0.5
    inv_depth = _scatter(H, W, ys_raw, xs_raw, vals, in_image, "add")
    disparity = _scatter(H, W, ys_raw, xs_raw, disp_l, in_image, "amax")

    num_valid = torch.sum(valid_pt, dim=-1).to(torch.int32)
    ok = num_valid >= cfg.min_valid_points
    return DepthResult(valid, disparity, inv_depth, ok, num_valid, iters, cost)
