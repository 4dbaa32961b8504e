"""Banded SSD stereo search: the CUDA kernel's wrapper and its plain version.

:func:`disparity_band` launches ``csrc/disparity_band.cu``, the port of the
TPU kernel ``odometry_tpu/kernels/disparity_pallas.py:_band_kernel``.
:func:`disparity_band_plain` is the same contract in plain PyTorch: the
row-chunked norm expansion of the reference's XLA path
(``odometry_tpu/kernels/disparity.py:191-238``); with ``max_disparity=None``
it is also the full-search kernel's plain version
(:mod:`odometry_torch.kernels.disparity_full`). The CPU path and the tests
use the plain version; on the card it serves only as the comparison.
:func:`launch` launches either kernel (they share one C signature).

Both return ``(best, match, rmatch, second)`` (see
:func:`odometry_torch.kernels.disparity.disparity_winner_maps`), and both
take one (H, W) pair or a batch (B, H, W) of pairs of one shape; the kernel
takes the batch in one launch (``csrc/ssd_row.cuh``), the plain version one
image at a time. The two
compute the SSD differently (direct sum of squares vs norm expansion), so
they may pick different winners where two candidates' SSDs are within the
norm expansion's float32 rounding band.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 1e10
_ROW_CHUNK = 8  # rows per (rows, W, W) cost volume of the plain version

# Shared memory a block may use on the H100 (232,448 bytes). Both kernels run
# one block per row (csrc/ssd_row.cuh), which keeps one 8-byte winner key per
# query column and, with lr, one per candidate column, and the right image's
# 8 pattern values per candidate column as two 16-byte planes; candidate
# columns are padded by _PAD on each side (a group of 4 x 32 columns,
# Blocking::kPad), and the key count is rounded up to even. A row that does
# not fit takes the tiled route (ssd_row.cuh: launch_tiled), which makes
# TILED_LAUNCHES launches: fill the key buffers, search the tiles, unpack.
_SMEM_LIMIT = 232448
_PAD = 128
ONE_BLOCK, TILED = "one_block", "tiled"
TILED_LAUNCHES = 3

# Kernel launches made by disparity_band(); tests and chip_smoke.py read it to
# show a run went through the kernel.
LAUNCHES = 0


def _min_d(min_disparity: int | None) -> int:
    return max(1, min_disparity or 1)


def disparity_band_plain(left_s: torch.Tensor, right_s: torch.Tensor, *, boundary: int,
                         min_disparity: int | None, max_disparity: int | None, lr: bool,
                         second_best: bool = False, second_excl: int = 2):
    """Plain PyTorch winner maps (``max_disparity=None`` = full search).

    Per chunk of _ROW_CHUNK rows, one (W, 8) x (8, W) product per row scores every
    (x, xr) pair; masked pairs score 1e10; ``torch.argmin`` takes the first
    index on ties, the strict-< scan rule of the reference. A batch (B, H, W)
    is searched one image at a time, so each image's maps are its own call's.
    """
    kw = dict(boundary=boundary, min_disparity=min_disparity, max_disparity=max_disparity,
              lr=lr, second_best=second_best, second_excl=second_excl)
    if left_s.dim() == 3:
        per_image = [_plain_one(a, b, **kw) for a, b in zip(left_s, right_s)]
        return tuple(torch.stack(maps) for maps in zip(*per_image))
    return _plain_one(left_s, right_s, **kw)


def _plain_one(left_s, right_s, *, boundary, min_disparity, max_disparity, lr, second_best,
               second_excl):
    from odometry_torch.kernels.disparity import pattern_stack

    H, W = left_s.shape
    dev = left_s.device
    PL = pattern_stack(left_s)
    PR = pattern_stack(right_s)
    ln = torch.sum(PL * PL, dim=0)
    rn = torch.sum(PR * PR, dim=0)
    xs = torch.arange(W, device=dev)[:, None]
    xr = torch.arange(W, device=dev)[None, :]
    d = xs - xr
    cand_ok = (xr >= boundary) & (d >= _min_d(min_disparity))
    if max_disparity is not None:
        cand_ok = cand_ok & (d <= max_disparity)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    best = torch.empty((H, W), dtype=torch.float32, device=dev)
    match = torch.empty((H, W), dtype=torch.int32, device=dev)
    rmatch = torch.zeros((H, W), dtype=torch.int32, device=dev)
    second = torch.full((H, W), BIG, dtype=torch.float32, device=dev)
    for r0 in range(0, H, _ROW_CHUNK):
        r1 = min(H, r0 + _ROW_CHUNK)
        cross = torch.bmm(PL[:, r0:r1].permute(1, 2, 0), PR[:, r0:r1].permute(1, 0, 2))
        ssd = ln[r0:r1, :, None] + rn[r0:r1, None, :] - 2.0 * cross
        ssd = torch.where(cand_ok, ssd, big)
        best[r0:r1] = torch.amin(ssd, dim=2)
        m = torch.argmin(ssd, dim=2)
        match[r0:r1] = m.to(torch.int32)
        if lr:
            rmatch[r0:r1] = torch.argmin(ssd, dim=1).to(torch.int32)
        if second_best:
            near = torch.abs(xr[None] - m[:, :, None]) <= second_excl
            second[r0:r1] = torch.amin(torch.where(near, big, ssd), dim=2)
    return best, match, rmatch, second


def check_images(name: str, left_s: torch.Tensor, right_s: torch.Tensor):
    """Raise unless `left_s`/`right_s` are one (H, W) or (B, H, W) float32
    contiguous pair of CUDA tensors on one device: what the winner kernels
    take."""
    if not (left_s.is_cuda and right_s.is_cuda):
        raise ValueError(f"{name}: inputs must be CUDA tensors")
    if left_s.device != right_s.device:
        raise ValueError(f"{name}: inputs on different devices")
    if left_s.dtype != torch.float32 or right_s.dtype != torch.float32:
        raise ValueError(f"{name}: inputs must be float32")
    if left_s.dim() not in (2, 3) or left_s.shape != right_s.shape or left_s.numel() == 0:
        raise ValueError(f"{name}: shapes {tuple(left_s.shape)} / "
                         f"{tuple(right_s.shape)} are not one (H, W) or (B, H, W)")
    if not (left_s.is_contiguous() and right_s.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def staged_bytes(width: int, lr: bool) -> int:
    """Dynamic shared memory of one one-block-route block of either kernel at
    image width `width`."""
    keys = (width + (width + 2 * _PAD if lr else 0) + 1) & ~1
    return 8 * keys + 32 * (width + 2 * _PAD)


def route(width: int, lr: bool) -> str:
    """ONE_BLOCK (one block per row) where a row's keys and planes fit a
    block's shared memory, else TILED: up to 4,629 columns with `lr`, 5,606
    without. Both routes give the same bits."""
    return ONE_BLOCK if staged_bytes(width, lr) <= _SMEM_LIMIT else TILED


def launch(name: str, left_s: torch.Tensor, right_s: torch.Tensor, *, boundary: int,
           min_d: int, max_d: int, lr: bool, second_best: bool, second_excl: int,
           force_route: str | None = None):
    """Launch ``csrc/<name>.cu`` on the current stream (no synchronise) and
    return ``((best, match, rmatch, second), launches)``. A batch (B, H, W)
    is one launch on the one-block route (TILED_LAUNCHES on the tiled), as
    one image is.

    The band and the full-search kernels share these C signatures. The route
    is :func:`route`'s unless `force_route` forces one (the tiled route takes any
    width; the one-block route raises on a row that does not fit). Inputs are
    checked by the caller; raises if a launch is refused.
    """
    from odometry_torch.kernels import _build

    shape = left_s.shape
    H, W = shape[-2:]
    batch = left_s.numel() // (H * W)
    chosen = route(W, lr) if force_route is None else force_route
    if chosen not in (ONE_BLOCK, TILED):
        raise ValueError(f"{name}: unknown route {chosen!r}")
    if chosen == ONE_BLOCK and staged_bytes(W, lr) > _SMEM_LIMIT:
        raise ValueError(f"{name}: width {W} needs {staged_bytes(W, lr)} B of shared memory "
                         f"per block on the one-block route, more than the {_SMEM_LIMIT} B "
                         f"a block can use")
    tiled = chosen == TILED
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_tiled_launch" if tiled else f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (7 if tiled else 6) + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])

    dev = left_s.device
    best = torch.empty(shape, dtype=torch.float32, device=dev)
    match = torch.empty(shape, dtype=torch.int32, device=dev)
    rmatch = torch.empty(shape, dtype=torch.int32, device=dev) if lr else None
    second = torch.empty(shape, dtype=torch.float32, device=dev) if second_best else None
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = [left_s.data_ptr(), right_s.data_ptr(), best.data_ptr(), match.data_ptr(),
            ptr(rmatch), ptr(second)]
    if tiled:
        # Per-row forward (and reverse) key buffers the tiles merge into. Freed
        # on return: the caching allocator hands the memory only to work queued
        # after the three launches on this stream.
        keys = torch.empty((2 if lr else 1, batch, H, W), dtype=torch.int64, device=dev)
        ptrs.append(keys.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, batch, H, W, int(boundary), int(min_d), int(max_d), int(second_excl),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({chosen} route): cudaError {rc}")
    if rmatch is None:
        rmatch = torch.zeros_like(match)
    if second is None:
        second = torch.full_like(best, BIG)
    return (best, match, rmatch, second), (TILED_LAUNCHES if tiled else 1)


def disparity_band(left_s: torch.Tensor, right_s: torch.Tensor, *, boundary: int,
                   min_disparity: int | None, max_disparity: int, lr: bool,
                   second_best: bool = False, second_excl: int = 2,
                   force_route: str | None = None):
    """Launch the CUDA band kernel on the current stream (no synchronise).

    `left_s`/`right_s`: (H, W) or (B, H, W) float32 contiguous CUDA tensors
    (the blurred images), of any width: rows too wide for one block take the
    tiled route (:func:`route`; `force_route` forces one). Raises on anything
    the kernel does not take, or if a launch is refused. Forward and reverse
    winners come from one pass over the pairs, bit for bit those of a
    strict-< ascending scan of each column, on either route; each image of a
    batch gets the bits of its own call. Adds each launch to ``LAUNCHES`` (1
    per call on the one-block route, TILED_LAUNCHES on the tiled, whatever B
    is).
    """
    global LAUNCHES
    check_images("disparity_band", left_s, right_s)
    if max_disparity is None:
        raise ValueError("disparity_band: max_disparity is required")
    min_d = _min_d(min_disparity)
    if max_disparity < min_d:
        raise ValueError(f"disparity_band: empty band [{min_d}, {max_disparity}]")
    out, launches = launch("disparity_band", left_s, right_s, boundary=boundary, min_d=min_d,
                           max_d=max_disparity, lr=lr, second_best=second_best,
                           second_excl=second_excl, force_route=force_route)
    LAUNCHES += launches
    return out
