"""Build and load the CUDA kernels of ``trpx_tpu_torch/csrc``.

The kernels have a plain C interface and are bound with ``ctypes``: each
``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all started
together, and the objects are linked into one shared library, in seconds
(a source that includes PyTorch's headers takes minutes). The library is
built at first use, only from the package's own sources, into
``trpx_tpu_torch/_build/`` (git-ignored). Its file name carries a hash of
the sources and flags, so an edited kernel is rebuilt, and the finished
file is moved into place atomically, so concurrent builds race safely (as
``native`` does for the host codec).

Two builds exist. The normal one is what every wrapper launches. The
bounds-checked one adds ``CHECKED_FLAGS``: each ``TRPX_CHECK`` of the
sources becomes a device ``assert`` on a shared-memory or global index,
which prints its file, line and thread and leaves a sticky
``cudaErrorAssert``; the library also exports ``trpx_checked_selftest``,
which trips one on purpose. A process chooses the checked build with
:func:`select_checked` before its first :func:`load`; the two libraries
live side by side under their own hashes.

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
#: added to NVCC_FLAGS for the bounds-checked build
CHECKED_FLAGS = ("-DTRPX_CHECKED", "-lineinfo")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_checked = False
#: guards every wrapper's ``launches`` count: the ctypes launchers run on
#: any host thread
_LAUNCH_LOCK = threading.Lock()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def flags(checked: bool = False) -> tuple:
    """nvcc's flags of the normal or the bounds-checked build."""
    return NVCC_FLAGS + CHECKED_FLAGS if checked else NVCC_FLAGS


def library_path(checked: bool = False) -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(flags(checked)).encode())
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


def _run_all(cmds: list) -> None:
    """Runs the commands at once; raises RuntimeError with the output of
    the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def build(checked: bool = False) -> Path:
    """Compile the kernels (the bounds-checked build with ``checked``)
    unless a library of the current sources exists. Raises RuntimeError
    with nvcc's output when the build fails."""
    so = library_path(checked)
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, fl = _nvcc(), flags(checked)
    compile_flags = [f for f in fl if f != "-shared"]
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        objs = [str(Path(d) / f"{src.stem}.o") for src in srcs]
        _run_all([[nvcc, *compile_flags, "-c", str(src), "-o", obj]
                  for src, obj in zip(srcs, objs)])
        tmp = str(Path(d) / "lib.so")
        _run_all([[nvcc, *fl, "-o", tmp, *objs]])
        os.replace(tmp, so)
    return so


def select_checked(on: bool = True) -> None:
    """Choose the bounds-checked build (``on``) or the normal one for this
    process. Raises RuntimeError once the other build is loaded."""
    global _checked
    with _LOCK:
        if _LIB is not None and on != _checked:
            raise RuntimeError("the kernel library is already loaded; "
                               "choose the build before the first launch")
        _checked = on


def load() -> ctypes.CDLL:
    """The loaded kernel library of the chosen build, built on first
    use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build(_checked)))
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
            if _checked:
                lib.trpx_checked_selftest.restype = i
                lib.trpx_checked_selftest.argtypes = [i]
            _LIB = lib
        return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = load().trpx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, in ``wrapper.launches``,
    exact under any number of host threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
