"""ctypes bindings for the native C++ PNG decode / prefetch runtime (port of
``data/native_loader.py``).

``odometry_torch/native/png_loader.cpp`` is built with g++ at first use into
``build/odometry_torch/libotpu_png-<hash>.so`` at the repository root (the
directory of the port's CUDA builds), keyed by a hash of the source and the
flags. Where g++ or zlib's header is missing the build raises
:class:`NativeLoaderUnavailable` with the compiler's message, and callers
fall back to the numpy decoder of ``data/png.py`` (``data/kitti.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from odometry_torch.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent.parent / "native" / "png_loader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None


class NativeLoaderUnavailable(RuntimeError):
    pass


def _build() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libotpu_png-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeLoaderUnavailable(f"native build failed: {detail}") from None
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.otpu_png_read_gray.restype = ctypes.c_int
        lib.otpu_png_read_gray.argtypes = [ctypes.c_char_p, f32p,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
        lib.otpu_loader_open.restype = ctypes.c_void_p
        lib.otpu_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.otpu_loader_next.restype = ctypes.c_int
        lib.otpu_loader_next.argtypes = [ctypes.c_void_p, f32p, f32p]
        lib.otpu_loader_close.restype = None
        lib.otpu_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _f32p(ptr: int):
    return ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float))


def png_read_gray(path: str) -> np.ndarray:
    """Decode one PNG to float32 grayscale with the native decoder."""
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.otpu_png_read_gray(path.encode(), None, ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native PNG decode failed: {path}")
    out = np.empty((h.value, w.value), np.float32)
    if lib.otpu_png_read_gray(path.encode(), _f32p(out.ctypes.data), ctypes.byref(w),
                              ctypes.byref(h)) != 0:
        raise IOError(f"native PNG decode failed: {path}")
    return out


class StereoPrefetcher:
    """Background-threaded stereo pair stream (decode overlaps compute).

    Yields (left, right) float32 numpy arrays, or with `pin_memory` float32
    CPU tensors in page-locked memory that the decoder writes directly, ready
    for an asynchronous copy to the card."""

    def __init__(self, left_paths: Sequence[str], right_paths: Sequence[str], height: int,
                 width: int, prefetch: int = 4, num_threads: int = 2,
                 pin_memory: bool = False):
        if len(left_paths) != len(right_paths):
            raise ValueError("left/right path counts differ")
        lib = _load()
        self._lib = lib
        self._n = len(left_paths)
        self._shape = (height, width)
        self._pin = pin_memory
        self._larr = (ctypes.c_char_p * self._n)(*[p.encode() for p in left_paths])
        self._rarr = (ctypes.c_char_p * self._n)(*[p.encode() for p in right_paths])
        self._handle = lib.otpu_loader_open(self._larr, self._rarr, self._n, prefetch,
                                            num_threads)
        if not self._handle:
            raise NativeLoaderUnavailable("loader_open failed")

    def _buffer(self):
        if self._pin:
            t = torch.empty(self._shape, dtype=torch.float32, pin_memory=True)
            return t, t.data_ptr()
        a = np.empty(self._shape, np.float32)
        return a, a.ctypes.data

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        try:
            while True:
                left, lp = self._buffer()
                right, rp = self._buffer()
                rc = self._lib.otpu_loader_next(self._handle, _f32p(lp), _f32p(rp))
                if rc == 1:
                    return
                if rc != 0:
                    raise IOError("native decode error in prefetcher")
                yield left, right
        finally:
            self.close()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.otpu_loader_close(self._handle)
            self._handle = None
