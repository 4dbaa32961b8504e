"""PNG reader and writer on numpy and the standard library's ``zlib``.

The port's image IO: it takes the place of PIL, which the reference's
loaders and dump writer import (``data/kitti.py``, ``data/tum.py``,
``data/middlebury.py``, ``eval/export.py``) and which the machine with the
card need not have.

Read: 8-bit and 16-bit greyscale (colour type 0; 16-bit is big-endian on
disk, as TUM depth and disparity maps are), 8-bit RGB and RGBA (types 2 and
6), all five scanline filters, any number of IDAT chunks, no interlace.
Anything else raises :class:`PNGError` naming the file and what is not
supported.

Colour to grey, two rules, both kept because the reference uses both:

* :func:`gray_pil` is PIL's ``convert("L")``,
  ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``: what ``kitti.load_gray``,
  ``tum.load_gray`` and ``middlebury.load_pair`` see;
* :func:`gray_native` is the native decoder's ``(299R + 587G + 114B + 500)
  / 1000`` (``native/png_loader.cpp``), what ``StereoPrefetcher`` yields.

Write: 8-bit and 16-bit greyscale, with one scanline filter for every row or
PIL-like adaptive filtering (per row, the filter whose bytes have the least
sum of absolute values as signed bytes).

Unfiltering: rows of filter types None, Sub and Up are undone one row at a
time with numpy vectors. Average and Paeth depend on the pixel to the left
and the row above, so the rows from the first to the last that uses them are
undone as a wavefront: the rows are skewed so that pixel (y, x) sits in
column x + y, and each column, which depends only on earlier ones, is one
vector step (width + rows steps in all).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types this module reads
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha", 6: "RGBA"}


class PNGError(ValueError):
    """A file that is not a PNG this module reads."""


# ---------------------------------------------------------------- reading


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise PNGError(f"{path}: truncated {kind!r} chunk")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise PNGError(f"{path}: bad CRC in {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise PNGError(f"{path}: no IEND chunk")


def _header(payload: bytes, path: str):
    width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", payload)
    if width == 0 or height == 0:
        raise PNGError(f"{path}: empty image ({width}x{height})")
    if interlace != 0:
        raise PNGError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if colour not in _CHANNELS:
        raise PNGError(f"{path}: colour type {colour} "
                       f"({_COLOUR_NAMES.get(colour, 'unknown')}) is not supported")
    if not (depth == 8 or (depth == 16 and colour == 0)):
        raise PNGError(f"{path}: bit depth {depth} with colour type {colour} is not "
                       f"supported (8-bit grey/RGB/RGBA or 16-bit grey)")
    return width, height, depth, colour


def _unfilter_easy(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filter None (0), Sub (1) or Up (2) on one row of bytes."""
    if ftype == 0:
        return row
    if ftype == 1:  # each byte adds the byte bpp before it: a running sum per channel
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    return row + prev  # uint8 arithmetic wraps modulo 256


def _unfilter_wavefront(ftypes: np.ndarray, rows: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Undo any filters on a run of m rows below the decoded row `prev`.

    Skewed layout, columns first: cell [s, r] holds pixel x = s - r - 1 of
    row r (1..m; row 0 is `prev`), so a pixel's left (a), up (b) and up-left
    (c) neighbours are cells [s-1, r], [s-1, r-1] and [s-2, r-1], and column
    s depends only on earlier columns. Cells left of the image (x < 0) have
    zero inputs and so stay 0, the filters' value beyond the edge; cells
    right of it (x >= width) fill with values no pixel of the image reads.
    """
    m, stride = rows.shape
    wp = stride // bpp
    ncols = wp + m + 1
    skew = np.zeros((ncols, m + 1, bpp), np.int32)
    raw = np.zeros((ncols, m + 1, bpp), np.int32)
    skew[1 : 1 + wp, 0] = prev.reshape(wp, bpp)
    for r in range(1, m + 1):
        raw[r + 1 : r + 1 + wp, r] = rows[r - 1].reshape(wp, bpp)
    f = ftypes.astype(np.int32)[:, None]
    is_paeth = f == 4
    any_paeth, all_paeth = bool(is_paeth.any()), bool(is_paeth.all())
    # Filters 0-3 predict (wa*a + wb*b) >> 1: None (0, 0), Sub (2, 0), Up (0, 2), Average (1, 1).
    wa = np.select([f == 1, f == 3], [2, 1], 0).astype(np.int32)
    wb = np.select([f == 2, f == 3], [2, 1], 0).astype(np.int32)
    for s in range(2, ncols):
        left = skew[s - 1]
        a, b, c = left[1:], left[:-1], skew[s - 2, :-1]
        if any_paeth:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            if not all_paeth:
                pred = np.where(is_paeth, pred, (wa * a + wb * b) >> 1)
        else:
            pred = (wa * a + wb * b) >> 1
        np.bitwise_and(raw[s, 1:] + pred, 255, out=skew[s, 1:])
    out = np.empty((m, stride), np.uint8)
    for r in range(1, m + 1):
        out[r - 1] = skew[r + 1 : r + 1 + wp, r].reshape(-1)
    return out


def _unfilter(data: np.ndarray, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    data = data.reshape(height, stride + 1)
    ftypes, rows = data[:, 0], data[:, 1:]
    if ftypes.max() > 4:
        raise PNGError(f"{path}: bad scanline filter type {int(ftypes.max())}")
    out = np.empty((height, stride), np.uint8)
    hard = np.nonzero(ftypes >= 3)[0]
    lo, hi = (int(hard[0]), int(hard[-1]) + 1) if len(hard) else (height, height)
    prev = np.zeros(stride, np.uint8)
    for y in range(lo):
        out[y] = prev = _unfilter_easy(int(ftypes[y]), rows[y], prev, bpp)
    if lo < hi:
        out[lo:hi] = _unfilter_wavefront(ftypes[lo:hi], rows[lo:hi], prev, bpp)
        prev = out[hi - 1]
    for y in range(hi, height):
        out[y] = prev = _unfilter_easy(int(ftypes[y]), rows[y], prev, bpp)
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) uint8 or uint16 for greyscale, (H, W, 3|4) uint8
    for RGB / RGBA. Raises FileNotFoundError for a missing file and PNGError
    for one this module does not read."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(payload, path)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise PNGError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, colour = header
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != height * (stride + 1):
        raise PNGError(f"{path}: image data holds {len(raw)} bytes, expected "
                       f"{height * (stride + 1)}")
    px = _unfilter(np.frombuffer(raw, np.uint8), height, stride, bpp, path)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(height, width)
    return px.reshape(height, width, channels) if channels > 1 else px


def gray_pil(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of an 8-bit RGB(A) or 16-bit grey array, uint8:
    ITU-R 601-2 luma in 16.16 fixed point (alpha ignored); 16-bit grey
    clipped to 255."""
    if img.ndim == 2:
        return np.minimum(img, 255).astype(np.uint8)
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def gray_native(img: np.ndarray) -> np.ndarray:
    """The native decoder's grey of an 8-bit RGB(A) array, uint8:
    ``(299R + 587G + 114B + 500) / 1000`` (``native/png_loader.cpp``)."""
    if img.ndim == 2:
        return img.astype(np.uint8)
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.uint8)


def read_gray(path: str, rule: str = "pil") -> np.ndarray:
    """A PNG as float32 greyscale; colour converted by `rule` ("pil", as
    ``PIL.Image.convert("L")``, or "native", as the native decoder)."""
    img = read_png(path)
    if rule == "pil":
        return gray_pil(img).astype(np.float32)
    if rule == "native":
        if img.dtype != np.uint8:
            raise PNGError(f"{path}: the native rule reads 8-bit images only")
        return gray_native(img).astype(np.float32)
    raise ValueError(f"unknown grey rule {rule!r}")


# ---------------------------------------------------------------- writing


def _filter_rows(px: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, stride) uint8: every row filtered with each of the five filters.

    Filtering reads only the original bytes, so it is one vector expression
    per filter over the whole image."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    return np.stack([(x - p) & 255 for p in preds]).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray, filter: int | str = "adaptive",
              idat_size: int = 1 << 20) -> None:
    """Write a 2-D uint8 or uint16 array as an 8-bit or 16-bit greyscale PNG.

    `filter` is a scanline filter type 0-4 for every row, or "adaptive":
    per row, the filter with the least sum of absolute signed bytes (the
    heuristic of libpng and PIL). The compressed stream is split into IDAT
    chunks of at most `idat_size` bytes.
    """
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes a 2-D uint8 or uint16 array, not {img.dtype} "
                         f"{img.shape}")
    height, width = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    bpp = depth // 8
    px = img.astype(">u2").view(np.uint8).reshape(height, width * 2) if depth == 16 else img
    filtered = _filter_rows(px, bpp)
    if filter == "adaptive":
        signed = np.minimum(filtered, 256 - filtered.astype(np.int16))
        choice = np.argmin(signed.sum(axis=2, dtype=np.int64), axis=0)
    elif filter in range(5):
        choice = np.full(height, filter)
    else:
        raise ValueError(f"bad filter {filter!r}")
    rows = filtered[choice, np.arange(height)]
    raw = np.concatenate([choice.astype(np.uint8)[:, None], rows], axis=1)
    stream = zlib.compress(raw.tobytes())
    out = [SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))]
    out += [_chunk(b"IDAT", stream[i : i + idat_size])
            for i in range(0, max(len(stream), 1), idat_size)]
    out.append(_chunk(b"IEND", b""))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
    os.replace(tmp, path)
