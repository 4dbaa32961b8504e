"""Fixed-capacity point lists (port of ``kernels/points.py``).

Valid pixels are extracted once per keyframe into static-capacity lanes, so
every LM iteration touches only the points that matter.

Tie order: ``lax.top_k`` returns the lower index first among equal keys.
``torch.topk`` promises no order, so the blocked extraction takes the first
S entries of a stable descending ``torch.sort``, which keeps the lower index
first as well.

Every function takes one image's tensors or a batch of them with a leading
axis B (images (B, H, W), point lists (B, cap), poses (B, 4, 4)), the
counterpart of the reference's ``jax.vmap``. Extraction needs no host read:
the first `capacity` set positions of each row of a (B, N) mask come from a
per-row running count (:func:`_first_set`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vobench.plain.pinhole import Pinhole
from vobench.plain.pyramid import central_gradients
from vobench.plain.sampling import clip_gather_2d, sample_bilinear, sample_channels_mm
from vobench.plain.batch import lane


class PointSet(NamedTuple):
    """Sparse pixels with inverse depth; fixed capacity, mask-padded. A
    batch carries a leading axis B on every field."""

    xs: torch.Tensor  # (cap,) float32 pixel x
    ys: torch.Tensor  # (cap,) float32 pixel y
    inv_depth: torch.Tensor  # (cap,) float32
    valid: torch.Tensor  # (cap,) bool
    num: torch.Tensor  # scalar int32 = number of valid entries


def _first_set(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per row of a (B, N) mask, ``jnp.nonzero(row, size=capacity,
    fill_value=0)``: the first `capacity` set positions in order, zeros
    after them. A set position's running count is its slot; positions past
    the capacity go to a spare column that is dropped."""
    B, N = mask.shape
    count = torch.cumsum(mask, dim=1, dtype=torch.int32)
    slot = torch.where(mask & (count <= capacity), count - 1, capacity).long()
    out = torch.zeros((B, capacity + 1), dtype=torch.int64, device=mask.device)
    pos = torch.arange(N, device=mask.device).expand(B, N)
    return out.scatter_(1, slot, pos)[:, :capacity]


def extract_points(values: torch.Tensor, mask: torch.Tensor, capacity: int,
                   order: str = "row", priority: torch.Tensor | None = None) -> PointSet:
    """Gather pixels where `mask` into a capacity-bounded PointSet.

    order="row": first `capacity` valid pixels in row-major order.
    order="spread": enumeration by 8x8 phase class, so a truncated selection
    is a spatially uniform subsample.
    order="blocked": per-tile slot budget; `priority` (blocked only) ranks
    pixels within a tile, highest first, else scan order.

    (H, W) inputs give one PointSet; (B, H, W) inputs a batch of them.
    """
    if values.dim() == 2:
        return lane(extract_points(values[None], mask[None], capacity, order,
                                   None if priority is None else priority[None]), 0)
    B, H, W = values.shape
    if order == "blocked":
        return _extract_points_blocked(values, mask, capacity, priority)
    if order == "spread":
        t = 8
        Hp, Wp = -(-H // t) * t, -(-W // t) * t
        nby, nbx = Hp // t, Wp // t

        def perm(a):
            a = torch.nn.functional.pad(a, (0, Wp - W, 0, Hp - H))
            return a.reshape(B, nby, t, nbx, t).permute(0, 2, 4, 1, 3).reshape(B, -1)

        flat_mask = perm(mask.to(torch.uint8)).bool()
        flat_vals = perm(values)
        idx = _first_set(flat_mask, capacity)
        py = idx // (t * nby * nbx)
        r1 = idx % (t * nby * nbx)
        px = r1 // (nby * nbx)
        r2 = r1 % (nby * nbx)
        ys = ((r2 // nbx) * t + py).float()
        xs = ((r2 % nbx) * t + px).float()
    elif order == "row":
        flat_mask = mask.reshape(B, -1)
        flat_vals = values.reshape(B, -1)
        idx = _first_set(flat_mask, capacity)
        ys = (idx // W).float()
        xs = (idx % W).float()
    else:
        raise ValueError(f"unknown extraction order {order!r}")
    count = torch.clamp(torch.sum(flat_mask, dim=1), max=capacity).to(torch.int32)
    vals = torch.gather(flat_vals, 1, idx)
    slots = torch.arange(capacity, device=values.device)
    return PointSet(xs, ys, vals, slots < count[:, None], count)


def _blocked_grid(H: int, W: int, capacity: int, slots: int = 16):
    """(S, nby, nbx, th, tw): S slots per tile over an nby x nbx grid with
    nby*nbx*S == capacity and roughly square tiles; None for tiny images."""
    S = slots
    while S > 1 and capacity % S != 0:
        S >>= 1
    B = capacity // S
    if B < 1:
        return None
    target = math.sqrt(max(B * H / max(W, 1), 1e-9))
    nby = 1
    while nby * 2 <= B and abs(math.log2(nby * 2) - math.log2(target)) <= abs(
        math.log2(nby) - math.log2(target)
    ):
        nby *= 2
    while B % nby != 0:
        nby >>= 1
    nbx = B // nby
    th = -(-H // nby)
    tw = -(-W // nbx)
    if th * tw < S or th < 1 or tw < 1:
        return None
    return S, nby, nbx, th, tw


def _extract_points_blocked(values, mask, capacity, priority=None) -> PointSet:
    """Per-tile top-S extraction of a batch (B, H, W) (see extract_points)."""
    Bn, H, W = values.shape
    grid = _blocked_grid(H, W, capacity)
    if grid is None:
        return extract_points(values, mask, capacity, order="spread")
    S, nby, nbx, th, tw = grid
    T = nby * nbx
    Hp, Wp = nby * th, nbx * tw
    dev = values.device

    def relayout(a):
        a = torch.nn.functional.pad(a, (0, Wp - W, 0, Hp - H))
        return a.reshape(Bn, nby, th, nbx, tw).permute(0, 1, 3, 2, 4).reshape(Bn, T, th * tw)

    mb = relayout(mask.to(torch.uint8)).bool()
    vb = relayout(values)
    if priority is None:
        scan = torch.arange(th * tw, dtype=torch.int32, device=dev).expand(Bn, T, th * tw)
        prio = torch.where(mb, -scan, torch.full_like(scan, -(2**30)))
        top, idx = torch.sort(prio, dim=-1, descending=True, stable=True)
        valid = top[..., :S] > -(2**30)
    else:
        neg = torch.tensor(-3e38, dtype=torch.float32, device=dev)
        prio = torch.where(mb, relayout(priority).float(), neg)
        top, idx = torch.sort(prio, dim=-1, descending=True, stable=True)
        valid = top[..., :S] > neg
    idx = idx[..., :S]
    vals = torch.gather(vb, -1, idx)
    t = torch.arange(T, device=dev)[:, None]
    ys = (t // nbx) * th + idx // tw
    xs = (t % nbx) * tw + idx % tw
    valid = (valid & (ys < H) & (xs < W)).reshape(Bn, -1)
    vals = torch.where(valid, vals.reshape(Bn, -1),
                       torch.zeros((), dtype=vals.dtype, device=dev))
    return PointSet(xs.reshape(Bn, -1).float(), ys.reshape(Bn, -1).float(), vals, valid,
                    torch.sum(valid, dim=1).to(torch.int32))


def depth_point_pyramid(dpyr, boundary: int, min_inv_depth: float, capacity: int,
                        order: str = "row"):
    """Per-level PointSets from an inverse-depth pyramid: valid = |d| >=
    min_inv_depth inside the border margin (``lm_optimizer.cpp:190-193``);
    capacity shrinks 4x per level."""
    out = []
    for l, dep in enumerate(dpyr):
        H, W = dep.shape[-2:]
        ys = torch.arange(H, device=dep.device)[:, None]
        xs = torch.arange(W, device=dep.device)[None, :]
        border = (ys >= boundary) & (ys < H - boundary) & (xs >= boundary) & (xs < W - boundary)
        mask = border & (torch.abs(dep) >= min_inv_depth)
        cap = max(min(capacity >> (2 * l), H * W), 8)
        out.append(extract_points(dep, mask, cap, order=order))
    return tuple(out)


class PointSystem(NamedTuple):
    r: torch.Tensor  # (cap,) ((B, cap) for a batch)
    J: torch.Tensor  # (cap, 6)
    valid: torch.Tensor  # (cap,) bool


def residual_jacobian_points(pts: PointSet, img_cur: torch.Tensor, cam: Pinhole,
                             T: torch.Tensor, *, kf_intensity: torch.Tensor,
                             interp: str = "floor", grads: tuple | None = None,
                             chan: torch.Tensor | None = None) -> PointSystem:
    """Photometric residuals and 6-DoF Jacobians at the keyframe points.

    `grads` = (gx, gy) central-difference images of `img_cur` (floor:
    sampled at the warp's integer pixel; bilinear: at the nearest pixel).
    interp="mm" samples the (3, H, W) stack `chan` = [img, gx, gy] with the
    mm sampler's semantics (gradients interpolated bilinearly). A batch:
    points (B, cap), images (B, H, W), `chan` (B, 3, H, W), `T` (B, 4, 4).
    """
    H, W = img_cur.shape[-2:]
    d = pts.inv_depth
    safe_d = torch.where(torch.abs(d) < 1e-12, torch.ones_like(d), d)
    Z0 = 1.0 / safe_d
    X = Z0 * (pts.xs - cam.cx) / cam.fx
    Y = Z0 * (pts.ys - cam.cy) / cam.fy

    # T's entries broadcast over each image's points.
    M = T[..., None]
    Xw = M[..., 0, 0, :] * X + M[..., 0, 1, :] * Y + M[..., 0, 2, :] * Z0 + M[..., 0, 3, :]
    Yw = M[..., 1, 0, :] * X + M[..., 1, 1, :] * Y + M[..., 1, 2, :] * Z0 + M[..., 1, 3, :]
    Zw = M[..., 2, 0, :] * X + M[..., 2, 1, :] * Y + M[..., 2, 2, :] * Z0 + M[..., 2, 3, :]
    safe_Zw = torch.where(Zw == 0, torch.ones_like(Zw), Zw)
    u = cam.fx * Xw / safe_Zw + cam.cx
    v = cam.fy * Yw / safe_Zw + cam.cy
    uf = torch.floor(u)
    vf = torch.floor(v)
    valid = pts.valid & (Zw > 0.0) & (uf >= 0.0) & (vf >= 0.0) & (uf < W) & (vf < H)

    if interp == "floor":
        # float -> int casts of out-of-range values are undefined in torch;
        # clamp in float first (the result is the same clipped pixel).
        xi = torch.clamp(uf, -1.0, float(W)).long().clamp(0, W - 1)
        yi = torch.clamp(vf, -1.0, float(H)).long().clamp(0, H - 1)
        I2w = clip_gather_2d(img_cur, yi, xi)
        if grads is not None:
            gx = clip_gather_2d(grads[0], yi, xi)
            gy = clip_gather_2d(grads[1], yi, xi)
        else:
            gx = 0.5 * (clip_gather_2d(img_cur, yi, xi + 1) - clip_gather_2d(img_cur, yi, xi - 1))
            gy = 0.5 * (clip_gather_2d(img_cur, yi + 1, xi) - clip_gather_2d(img_cur, yi - 1, xi))
    elif interp == "mm":
        if chan is None:
            g = grads if grads is not None else central_gradients(img_cur)
            chan = torch.stack([img_cur, g[0], g[1]], dim=-3)
        I2w, gx, gy = sample_channels_mm(chan, u, v).unbind(-2)
    elif interp == "bilinear":
        I2w = sample_bilinear(img_cur, u, v)
        if grads is not None:
            xi = torch.clamp(torch.round(u), -1.0, float(W)).long().clamp(0, W - 1)
            yi = torch.clamp(torch.round(v), -1.0, float(H)).long().clamp(0, H - 1)
            gx = clip_gather_2d(grads[0], yi, xi)
            gy = clip_gather_2d(grads[1], yi, xi)
        else:
            gx = 0.5 * (sample_bilinear(img_cur, u + 1.0, v) - sample_bilinear(img_cur, u - 1.0, v))
            gy = 0.5 * (sample_bilinear(img_cur, u, v + 1.0) - sample_bilinear(img_cur, u, v - 1.0))
    else:
        raise ValueError(f"unknown interp mode {interp!r}")

    r = I2w - kf_intensity

    # 2x6 warp Jacobian at the keyframe point (lm_optimizer.cpp:232-234).
    inv_Z = 1.0 / torch.where(Z0 == 0, torch.ones_like(Z0), Z0)
    fx_z = cam.fx * inv_Z
    fy_z = cam.fy * inv_Z
    xy = X * Y
    inv_Z2 = inv_Z * inv_Z
    a = gx * fx_z
    b = gy * fy_z
    J = torch.stack(
        [
            a,
            b,
            -(a * X + b * Y) * inv_Z,
            -a * xy * inv_Z - gy * cam.fy * (1.0 + Y * Y * inv_Z2),
            gx * cam.fx * (1.0 + X * X * inv_Z2) + b * xy * inv_Z,
            -a * Y + b * X,
        ],
        dim=-1,
    )
    vf32 = valid.to(r.dtype)
    return PointSystem(r * vf32, J * vf32[..., None], valid)


def fit_affine_ab(r0: torch.Tensor, kf_intensity: torch.Tensor, valid: torch.Tensor,
                  a_dead: float = 0.0, b_dead: float = 0.0):
    """Closed-form brightness-affine fit (a, b) minimizing
    ``sum_valid (I2w - a*I1 - b)^2`` from the raw residual ``r0 = I2w - I1``;
    clamped to a plausible photometric envelope. (N,) lanes give scalars,
    a batch (B, N) one (a, b) per image, shaped (B,)."""
    vf = valid.to(r0.dtype)
    n = torch.clamp(torch.sum(vf, dim=-1), min=1.0)
    i2 = r0 + vf * kf_intensity
    s1 = torch.sum(vf * kf_intensity, dim=-1)
    s2 = torch.sum(vf * kf_intensity * kf_intensity, dim=-1)
    t0 = torch.sum(i2, dim=-1)
    t1 = torch.sum(i2 * kf_intensity, dim=-1)
    det = s2 * n - s1 * s1
    ok_fit = det > 1e-6 * torch.clamp(s2 * n, min=1.0)
    one = torch.ones_like(det)
    a = torch.where(ok_fit, (t1 * n - t0 * s1) / torch.where(ok_fit, det, one), one)
    b = torch.where(ok_fit, (t0 - a * s1) / n, torch.zeros_like(det))

    def soft(x, dead):
        return torch.sign(x) * torch.clamp(torch.abs(x) - dead, min=0.0)

    if a_dead:
        a = 1.0 + soft(a - 1.0, a_dead)
    if b_dead:
        b = soft(b, b_dead)
    return torch.clamp(a, 0.7, 1.4), torch.clamp(b, -40.0, 40.0)


class PointNormalEqs(NamedTuple):
    JtWJ: torch.Tensor
    JtWr: torch.Tensor
    err: torch.Tensor
    num_valid: torch.Tensor


def normal_equations_points(sys: PointSystem, weights: torch.Tensor) -> PointNormalEqs:
    """6x6 normal equations of (cap,) lanes, or of each image of a batch
    (B, cap): J^T W J and J^T W r, one product each for the batch."""
    w = weights * sys.valid.to(weights.dtype)
    JwT = (sys.J * w[..., None]).transpose(-1, -2)
    JtWJ = JwT @ sys.J
    JtWr = JwT @ sys.r if sys.r.dim() == 1 else (JwT @ sys.r[..., None])[..., 0]
    num_valid = torch.sum(sys.valid, dim=-1)
    err = torch.sum(w * sys.r * sys.r, dim=-1) / torch.clamp(num_valid, min=1).to(sys.r.dtype)
    return PointNormalEqs(JtWJ, JtWr, err, num_valid)
