"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled for sm_90a into ``build/odometry_torch/lib<name>-<hash>.so`` at the
repository root, keyed by a hash of the source, the shared headers and the
flags, and loaded with ``ctypes``. Nothing is built at import: the first
launch builds (``build_all`` builds several sources at once).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "odometry_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists.

    The key hashes the source, every header of ``csrc/`` (the kernels share
    ``ssd8.cuh``) and the flags, so an edited header never loads a stale
    library. The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``.
    """
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names) -> dict:
    """Build several sources at once, one nvcc process each, all started
    together; returns {name: (library path, seconds its build took)}."""

    def timed(name):
        t0 = time.perf_counter()
        path = build(name)
        return name, (path, time.perf_counter() - t0)

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(pool.map(timed, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
