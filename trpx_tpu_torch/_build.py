"""Build and load the CUDA kernels of ``trpx_tpu_torch/csrc``.

The kernels have a plain C interface and are bound with ``ctypes``: one
``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library, in seconds (a source that includes PyTorch's headers takes
minutes). The library is built at first use, only from the package's own
sources, into ``trpx_tpu_torch/_build/`` (git-ignored). Its file name
carries a hash of the sources and flags, so an edited kernel is rebuilt,
and the finished file is moved into place atomically, so concurrent
builds race safely (as ``native`` does for the host codec).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtrpx_cuda_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); "
                           "the CUDA kernels cannot be built")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.
    Raises RuntimeError with nvcc's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.trpx_pack.restype = i
            lib.trpx_pack.argtypes = [vp, i, i, i, i, i, i, i, i, i, vp, vp,
                                      vp, i, vp]
            lib.trpx_unpack.restype = i
            lib.trpx_unpack.argtypes = [vp, vp, i, i, i, i, i, i, i, i, i,
                                        vp, vp, i, vp]
            lib.trpx_pack_tiled.restype = i
            lib.trpx_pack_tiled.argtypes = [vp, i, i, i, i, i, i, i, i, i,
                                            vp, vp, vp, vp, i, vp]
            lib.trpx_unpack_tiled.restype = i
            lib.trpx_unpack_tiled.argtypes = [vp, vp, i, i, i, i, i, i, i,
                                              i, i, vp, vp, i, vp]
            lib.trpx_cuda_error_string.restype = ctypes.c_char_p
            lib.trpx_cuda_error_string.argtypes = [i]
            _LIB = lib
        return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = load().trpx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
