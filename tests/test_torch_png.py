"""The port's PNG codec (data/png.py) against PIL, and its native loader
against the reference's, on files written here."""

import struct
import threading
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from odometry_tpu.data import native_loader as ref_native
from odometry_torch.data import native_loader as port_native
from odometry_torch.data import png


def _pil_save(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def _smooth(shape, seed):
    """A textured image with a gradient, so PIL's adaptive rows use every filter."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = 127 + 80 * np.sin(xs / 5.0) * np.cos(ys / 3.0)
    if len(shape) == 3:
        base = base[..., None] + 20 * np.arange(shape[2])
    return np.clip(base + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)


def _filters_used(path):
    data = open(path, "rb").read()
    chunks = dict(png._chunks(data, path))
    width, height, depth, colour = png._header(chunks[b"IHDR"], path)
    raw = zlib.decompress(b"".join(p for k, p in png._chunks(data, path) if k == b"IDAT"))
    stride = width * png._CHANNELS[colour] * depth // 8
    return {raw[y * (stride + 1)] for y in range(height)}


@pytest.mark.parametrize("kind", ["L", "L_noise", "I;16", "RGB", "RGBA"])
def test_reads_what_pil_writes(tmp_path, kind):
    rng = np.random.default_rng(0)
    if kind == "I;16":
        arr = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
    elif kind == "L_noise":
        arr = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    else:
        arr = _smooth((37, 53) if kind == "L" else (37, 53, len(kind)), 1)
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    out = png.read_png(path)
    ref = np.asarray(Image.open(path))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, arr)


def test_pil_rows_exercise_paeth_and_the_writer_all_filters(tmp_path):
    path = _pil_save(tmp_path / "s.png", _smooth((40, 64, 3), 2))
    assert 4 in _filters_used(path)  # PIL's adaptive rows reach the wavefront
    img = _smooth((40, 64), 3)
    for f in range(5):
        p = str(tmp_path / f"f{f}.png")
        png.write_png(p, img, filter=f)
        assert _filters_used(p) == {f}
        np.testing.assert_array_equal(png.read_png(p), img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def _write_rows(path, arr, choice):
    """A PNG of `arr` (8-bit grey/RGB/RGBA or 16-bit grey) with filter
    choice[y] on row y."""
    h = arr.shape[0]
    if arr.dtype == np.uint16:
        px, bpp, depth, colour = arr.astype(">u2").view(np.uint8).reshape(h, -1), 2, 16, 0
    else:
        ch = 1 if arr.ndim == 2 else arr.shape[2]
        px, bpp, depth, colour = arr.reshape(h, -1), ch, 8, {1: 0, 3: 2, 4: 6}[ch]
    rows = png._filter_rows(px, bpp)[choice, np.arange(h)]
    raw = np.concatenate([np.asarray(choice, np.uint8)[:, None], rows], axis=1).tobytes()
    w = arr.shape[1]
    data = (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


@settings(max_examples=60, deadline=None, database=None)
@given(st.data())
def test_any_filter_per_row_any_layout(tmp_path_factory, data):
    """Random images and a random filter on every row, each layout the
    reader takes: decoded equal to the image and to PIL's decode."""
    layout = data.draw(st.sampled_from(["L", "RGB", "RGBA", "I;16"]))
    h = data.draw(st.integers(1, 9))
    w = data.draw(st.integers(1, 11))
    seed = data.draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    shape = {"L": (h, w), "RGB": (h, w, 3), "RGBA": (h, w, 4), "I;16": (h, w)}[layout]
    arr = (rng.integers(0, 65536, shape).astype(np.uint16) if layout == "I;16"
           else rng.integers(0, 256, shape).astype(np.uint8))
    choice = np.asarray(data.draw(st.lists(st.integers(0, 4), min_size=h, max_size=h)))
    path = str(tmp_path_factory.mktemp("h") / "x.png")
    _write_rows(path, arr, choice)
    np.testing.assert_array_equal(png.read_png(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)


def test_multi_idat_and_writer_round_trips(tmp_path):
    img8 = _smooth((60, 90), 4)
    img16 = (np.random.default_rng(5).integers(0, 65536, (60, 90))).astype(np.uint16)
    for img in (img8, img16):
        p = str(tmp_path / f"m{img.dtype}.png")
        png.write_png(p, img, idat_size=97)
        kinds = [k for k, _ in png._chunks(open(p, "rb").read(), p)]
        assert kinds.count(b"IDAT") > 1
        back = png.read_png(p)
        assert back.dtype == img.dtype
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    # PIL's own multi-IDAT files (it splits large images).
    big = _smooth((300, 400), 6)
    p = _pil_save(tmp_path / "big.png", big)
    kinds = [k for k, _ in png._chunks(open(p, "rb").read(), p)]
    assert kinds.count(b"IDAT") > 1
    np.testing.assert_array_equal(png.read_png(p), big)


def test_grey_rules(tmp_path):
    """PIL's rule against Image.convert("L") (RGB, RGBA and 16-bit grey,
    which PIL clips); the native rule against the reference's decoder."""
    rng = np.random.default_rng(7)
    for mode in ("RGB", "RGBA"):
        arr = rng.integers(0, 256, (31, 45, len(mode))).astype(np.uint8)
        p = _pil_save(tmp_path / f"{mode}.png", arr)
        expected = np.asarray(Image.open(p).convert("L")).astype(np.float32)
        np.testing.assert_array_equal(png.read_gray(p, rule="pil"), expected)
    d16 = rng.integers(0, 600, (31, 45)).astype(np.uint16)
    p = _pil_save(tmp_path / "d16.png", d16)
    np.testing.assert_array_equal(png.read_gray(p, rule="pil"),
                                  np.asarray(Image.open(p).convert("L")).astype(np.float32))
    arr = rng.integers(0, 256, (31, 45, 3)).astype(np.uint8)
    # Two of the 9,040 colours (of 2**24) on which the rules part by one level.
    arr[0, :2] = [[0, 0, 250], [0, 4, 168]]
    rgb = _pil_save(tmp_path / "RGB.png", arr)
    try:
        ref = ref_native.png_read_gray(rgb)
    except ref_native.NativeLoaderUnavailable as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    np.testing.assert_array_equal(png.read_gray(rgb, rule="native"), ref)
    # The two rules are different rules: they part on some pixels.
    assert not np.array_equal(png.read_gray(rgb, rule="pil"), ref)


def test_native_loader_equals_the_reference(tmp_path):
    """The port's build of the same C++ source decodes bit for bit as the
    reference's, one file at a time and through StereoPrefetcher's stream."""
    try:
        port_native._load()
        ref_native._load()
    except (port_native.NativeLoaderUnavailable, ref_native.NativeLoaderUnavailable) as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    assert port_native._build().parent.name == "odometry_torch"  # build/odometry_torch/
    rng = np.random.default_rng(8)
    lefts, rights = [], []
    for i in range(5):
        a = _pil_save(tmp_path / f"l{i}.png", _smooth((24, 40), 10 + i))
        b = _pil_save(tmp_path / f"r{i}.png", rng.integers(0, 256, (24, 40, 3)).astype(np.uint8))
        lefts.append(a)
        rights.append(b)
        for p in (a, b):
            np.testing.assert_array_equal(port_native.png_read_gray(p),
                                          ref_native.png_read_gray(p))
    ours = list(port_native.StereoPrefetcher(lefts, rights, 24, 40))
    theirs = list(ref_native.StereoPrefetcher(lefts, rights, 24, 40))
    assert len(ours) == len(theirs) == 5
    for (l1, r1), (l2, r2) in zip(ours, theirs):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(ours[0][0], png.read_gray(lefts[0], rule="native"))


def test_prefetcher_survives_a_slow_frame(tmp_path):
    """One pair's decode lagging the other thread by more than a full queue
    (here frame 0's left image carries a 16 MB ancillary chunk) must not
    stall the stream. The reference's loader bounds the queue's size and
    deadlocks on this input; the port's bounds each pair's distance from the
    next one served."""
    try:
        port_native._load()
    except port_native.NativeLoaderUnavailable as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    rng = np.random.default_rng(11)
    lefts, rights = [], []
    for i in range(20):
        for eye, paths in (("l", lefts), ("r", rights)):
            p = str(tmp_path / f"{eye}{i}.png")
            png.write_png(p, rng.integers(0, 256, (16, 24)).astype(np.uint8))
            paths.append(p)
    data = open(lefts[0], "rb").read()
    pad = bytes(16 << 20)
    chunk = struct.pack(">I", len(pad)) + b"zzZz" + pad + struct.pack(">I", zlib.crc32(b"zzZz" + pad))
    open(lefts[0], "wb").write(data[:-12] + chunk + data[-12:])  # before IEND
    got = []
    t = threading.Thread(target=lambda: got.extend(
        port_native.StereoPrefetcher(lefts, rights, 16, 24)), daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the prefetcher stalled"
    assert len(got) == 20
    for (left, right), lp, rp in zip(got, lefts, rights):
        np.testing.assert_array_equal(left, png.read_gray(lp, rule="native"))
        np.testing.assert_array_equal(right, png.read_gray(rp, rule="native"))


def _patch_header(src, dst, **fields):
    """Copy a PNG with IHDR fields replaced (CRC recomputed)."""
    data = bytearray(open(src, "rb").read())
    w, h, depth, colour, comp, filt, inter = struct.unpack(">IIBBBBB", data[16:29])
    vals = {"depth": depth, "colour": colour, "interlace": inter, **fields}
    data[16:29] = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"], comp, filt,
                              vals["interlace"])
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(dst, "wb").write(bytes(data))
    return str(dst)


def test_clear_errors(tmp_path):
    good = _pil_save(tmp_path / "g.png", _smooth((8, 8), 9))
    with pytest.raises(png.PNGError, match=r"i\.png: interlaced"):
        png.read_png(_patch_header(good, tmp_path / "i.png", interlace=1))
    with pytest.raises(png.PNGError, match=r"b4\.png: bit depth 4"):
        png.read_png(_patch_header(good, tmp_path / "b4.png", depth=4))
    pal = str(tmp_path / "p.png")
    Image.fromarray(_smooth((8, 8), 9)).convert("P").save(pal)
    with pytest.raises(png.PNGError, match=r"p\.png: colour type 3 \(palette\)"):
        png.read_png(pal)
    bad = bytearray(open(good, "rb").read())
    bad[40] ^= 0xFF
    open(tmp_path / "c.png", "wb").write(bytes(bad))
    with pytest.raises(png.PNGError, match="CRC"):
        png.read_png(str(tmp_path / "c.png"))
    with pytest.raises(FileNotFoundError, match="missing.png"):
        png.read_png(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
