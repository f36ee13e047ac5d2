"""Native host runtime: ctypes bindings to the C++ codec (host_codec.cpp).

The port's own copy of ``trpx_tpu/native``. The shared library is compiled
on demand from this package's ``host_codec.cpp`` with ``$CXX`` (else
``g++``) and OpenMP into ``trpx_tpu_torch/_build/native/`` (git-ignored),
under a name that carries a hash of the source, and loaded via ctypes. The
build writes a temporary file and renames it into place, so concurrent
builders (test workers) race safely. If no compiler is available,
``available()`` returns False and callers take the pure-Python normative
codec. The JAX package's library (same C symbols) may be loaded in the same
process: ctypes loads each with ``RTLD_LOCAL``.

Why native code here: the bitstream's serial parts — the per-block header
walk on decode and the whole encoder for 64-bit dtypes the device path
can't take — are pointer-chasing bit arithmetic, exactly what a CPU does
well and Python does ~1000x too slowly for 10k-frame stacks. The device
(CUDA) path remains the compute path for (u)int8/16/32 frames.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("host_codec.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

#: slack bytes required past logical buffer ends (16-byte window memcpys)
SLACK = 16


def _cache_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "_build" / "native"


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    d = _cache_dir()
    so = d / f"host_codec_{tag}.so"
    if so.exists():
        return so
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(
            suffix=".so", dir=d, delete=False
        ) as tmp:
            tmp_path = Path(tmp.name)
        cmd = [
            os.environ.get("CXX", "g++"), "-std=c++20", "-O3", "-shared",
            "-fPIC", "-march=native", "-fopenmp", str(_SRC), "-o",
            str(tmp_path),
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp_path, so)  # atomic: concurrent builders race safely
        return so
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return None


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.trpx_walk.restype = ctypes.c_int
        lib.trpx_walk.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, c_i32p, c_i64p, c_i64p, ctypes.c_int,
        ]
        lib.trpx_walk_indexed.restype = ctypes.c_int
        lib.trpx_walk_indexed.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, c_i64p, c_i32p, c_i64p, ctypes.c_int,
        ]
        lib.trpx_encode_frames.restype = ctypes.c_int64
        lib.trpx_encode_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            c_u8p, ctypes.c_int64, c_i64p, c_i32p,
        ]
        lib.trpx_gather_frames.restype = None
        lib.trpx_gather_frames.argtypes = [
            c_u8p, c_i64p, c_i64p, ctypes.c_int64, c_u8p, ctypes.c_int64,
        ]
        lib.trpx_tile_prepass.restype = ctypes.c_int
        lib.trpx_tile_prepass.argtypes = [
            c_i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, c_i64p, c_i64p,
        ]
        lib.trpx_decode_frames.restype = ctypes.c_int
        lib.trpx_decode_frames.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, c_i32p, c_i64p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True if the native library compiled and loaded."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _padded_payload(payload) -> np.ndarray:
    # a uint8 ndarray is accepted as ALREADY padded (callers that walk
    # repeatedly cache the padded copy — it is a full-payload memcpy)
    if isinstance(payload, np.ndarray):
        return payload
    buf = np.zeros(len(payload) + SLACK, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf


def gather_frames(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                  out: np.ndarray) -> None:
    """Scatter per-frame payload chunks into the rows of ``out`` (tails
    zeroed) with a parallel C memcpy. ``out`` must be C-contiguous uint8
    (F, row_bytes); rows beyond ``len(starts)`` are left untouched."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    lib.trpx_gather_frames(
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64), len(starts),
        _ptr(out, ctypes.c_uint8), out.shape[1],
    )


def _check_width(rc: int, max_width: int | None) -> None:
    """Walkers return the max block width seen (>=0) or -1; reject
    streams whose widths exceed the header's claim (the encoder sets
    prolix_bits to the max width, Terse.hpp:516 — anything wider is
    corruption a later kernel would silently garbage-decode)."""
    if rc < 0:
        raise ValueError("malformed TRPX payload: header walk ran past end")
    if max_width is not None and rc > max_width:
        raise ValueError(
            f"corrupt TRPX payload: block width {rc} exceeds the "
            f"header's prolix_bits={max_width}")


def _wide_hint(max_width: int | None) -> int:
    """Select the branchless wide-stream walk loop: on overflow-heavy
    streams (field widths > 16 bits) the repeat/explicit branch
    mispredicts at ~every width change; prolix_bits is a free proxy."""
    return int(max_width is not None and max_width > 16)


def walk(payload, nframes: int, nvalues: int, block: int,
         want_poffs: bool = True, out_widths: np.ndarray | None = None,
         max_width: int | None = None):
    """Header walk for a whole archive (C speed).

    Returns (widths (F, nb) int32, poffs (F, nb) int64 absolute bit offsets
    — or None when ``want_poffs=False``, which skips ~2/3 of the output
    traffic; the tree decoders derive offsets from widths — and
    fstarts (F+1,) int64 byte offsets). Raises ValueError on a malformed
    stream, or on any block wider than ``max_width`` when given.
    ``payload`` may be a pre-padded uint8 array (padded_buffer);
    ``out_widths`` lets the walk write straight into a caller table.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    nb = -(-nvalues // block)
    plen = (len(payload) - SLACK if isinstance(payload, np.ndarray)
            else len(payload))
    buf = _padded_payload(payload)
    widths = (out_widths if out_widths is not None
              else np.empty((nframes, nb), dtype=np.int32))
    poffs = np.empty((nframes, nb), dtype=np.int64) if want_poffs else None
    fstarts = np.empty(nframes + 1, dtype=np.int64)
    rc = lib.trpx_walk(
        _ptr(buf, ctypes.c_uint8), plen, nframes, nvalues, block,
        _ptr(widths, ctypes.c_int32),
        _ptr(poffs, ctypes.c_int64) if want_poffs else None,
        _ptr(fstarts, ctypes.c_int64), _wide_hint(max_width),
    )
    _check_width(rc, max_width)
    return widths, poffs, fstarts


def padded_buffer(payload: bytes) -> np.ndarray:
    """Payload as a uint8 array with the SLACK bytes the 16-byte-window
    bit reader needs — build once, then walk chunks against it."""
    return _padded_payload(payload)


def walk_chunk(buf: np.ndarray, start: int, nframes: int, nvalues: int,
               block: int, want_poffs: bool = False,
               max_width: int | None = None):
    """Header walk of ``nframes`` frames starting at byte ``start`` of a
    ``padded_buffer`` array.

    The chunk walks are serially dependent (chunk k+1 starts where chunk
    k ended) but each call returns quickly, so callers overlap the next
    chunk's walk with the device unpack of the previous one
    (runtime/stream.iter_decode).

    Returns (widths (nf, nb) int32, poffs (nf, nb) int64 bit offsets
    relative to ``start`` — None unless ``want_poffs`` — and
    fstarts (nf+1,) int64 byte offsets relative to ``start``).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    nb = -(-nvalues // block)
    sub = buf[start:]
    payload_len = buf.shape[0] - SLACK - start
    widths = np.empty((nframes, nb), dtype=np.int32)
    poffs = np.empty((nframes, nb), dtype=np.int64) if want_poffs else None
    fstarts = np.empty(nframes + 1, dtype=np.int64)
    rc = lib.trpx_walk(
        _ptr(sub, ctypes.c_uint8), payload_len, nframes, nvalues, block,
        _ptr(widths, ctypes.c_int32),
        _ptr(poffs, ctypes.c_int64) if want_poffs else None,
        _ptr(fstarts, ctypes.c_int64), _wide_hint(max_width),
    )
    _check_width(rc, max_width)
    return widths, poffs, fstarts


def walk_indexed(payload, fstarts: np.ndarray, nvalues: int,
                 block: int, want_poffs: bool = True,
                 out_widths: np.ndarray | None = None,
                 max_width: int | None = None):
    """Parallel header walk given known per-frame byte offsets (OpenMP).

    Returns (widths (F, nb) int32, poffs (F, nb) int64 absolute bit
    offsets — or None when ``want_poffs=False``). Raises ValueError on a
    malformed stream. ``payload``/``out_widths`` as in :func:`walk`.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    fstarts = np.ascontiguousarray(fstarts, dtype=np.int64)
    nframes = fstarts.shape[0]
    nb = -(-nvalues // block)
    plen = (len(payload) - SLACK if isinstance(payload, np.ndarray)
            else len(payload))
    buf = _padded_payload(payload)
    widths = (out_widths if out_widths is not None
              else np.empty((nframes, nb), dtype=np.int32))
    poffs = np.empty((nframes, nb), dtype=np.int64) if want_poffs else None
    rc = lib.trpx_walk_indexed(
        _ptr(buf, ctypes.c_uint8), plen, nframes, nvalues, block,
        _ptr(fstarts, ctypes.c_int64),
        _ptr(widths, ctypes.c_int32),
        _ptr(poffs, ctypes.c_int64) if want_poffs else None,
        _wide_hint(max_width),
    )
    _check_width(rc, max_width)
    return widths, poffs


def tile_tables(widths: np.ndarray, nvalues: int, block: int,
                tile_blocks: int):
    """Tiled-decode prepass tables at C speed (OpenMP).

    Returns (tile_bits (F, T) int64, level_max list[int] of log2(Tb)
    per-level node maxima) computed from the walk's (F, nb) width
    tables — the native twin of pallas_unpack.block_bits_host +
    _level_maxima. ``tile_blocks`` must be a power of two."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    widths = np.ascontiguousarray(widths, dtype=np.int32)
    F, nb = widths.shape
    T = -(-nb // tile_blocks)
    levels = max(0, tile_blocks.bit_length() - 1)
    tile_bits = np.empty((F, T), dtype=np.int64)
    level_max = np.zeros(max(1, levels), dtype=np.int64)
    rc = lib.trpx_tile_prepass(
        _ptr(widths, ctypes.c_int32), F, nb, nvalues, block, tile_blocks,
        _ptr(tile_bits, ctypes.c_int64), _ptr(level_max, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("tile_prepass: invalid arguments")
    return tile_bits, [int(v) for v in level_max[:levels]]


def encode_frames(frames: np.ndarray, block: int, signed: bool):
    """Encode (F, n) integral frames -> (payload bytes, fstarts,
    prolix_bits). Bit-identical to the reference encoder.

    The C side is templated on the element size, so frames pass through
    in their ORIGINAL dtype — no int64-widening copy, and the worst-case
    reservation scales with the dtype's width instead of 65 bits."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if frames.dtype.kind not in "iu":
        raise TypeError(f"integral frames required, got {frames.dtype}")
    # the C templates read native-endian elements; normalize byte order
    # (no copy for native input)
    frames = np.ascontiguousarray(
        frames, dtype=frames.dtype.newbyteorder("="))
    F, n = frames.shape
    nb = -(-n // block)
    itemsize = frames.dtype.itemsize
    max_w = 8 * itemsize + (1 if signed else 0)  # 65 only for int64
    per_frame = (max_w * n + 12 * nb) // 8 + 2
    cap = F * per_frame + SLACK
    out = np.empty(cap, dtype=np.uint8)  # C writes every returned byte
    fstarts = np.empty(F + 1, dtype=np.int64)
    prolix = np.zeros(1, dtype=np.int32)
    total = lib.trpx_encode_frames(
        frames.ctypes.data_as(ctypes.c_void_p), itemsize, int(signed),
        F, n, block,
        _ptr(out, ctypes.c_uint8), cap, _ptr(fstarts, ctypes.c_int64),
        _ptr(prolix, ctypes.c_int32),
    )
    if total < 0:
        raise ValueError("unencodable frame (field width > 73 bits)")
    return out[:total].tobytes(), fstarts, int(prolix[0])


def decode_frames(
    payload: bytes,
    nframes: int,
    nvalues: int,
    block: int,
    target_dtype,
    stream_signed: bool = False,
    max_width: int | None = None,
    fstarts=None,
) -> np.ndarray:
    """Decode all frames -> (F, n) of ``target_dtype`` with the reference's
    extraction semantics (sign-extension into signed targets, clamping).
    ``stream_signed`` only matters for float targets, which route through
    int64/uint64 by the *stream*'s signedness (Terse.hpp:379-383)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    dtype = np.dtype(target_dtype)
    out_dtype = dtype.newbyteorder("=")  # C stores native-endian
    if fstarts is not None and len(fstarts) == nframes:
        # known frame offsets (encoder archives / validated sidecar):
        # the header walk parallelizes across frames (OpenMP) instead of
        # chaining serially through the stream
        widths, poffs = walk_indexed(
            payload, np.asarray(fstarts, np.int64), nvalues, block,
            max_width=max_width)
    else:
        widths, poffs, _ = walk(payload, nframes, nvalues, block,
                                max_width=max_width)
    buf = _padded_payload(payload)
    if dtype.kind == "i":
        signed, bits = 1, 8 * dtype.itemsize
        info = np.iinfo(dtype)
        cmin, cmax = int(info.min), int(info.max)
        out = np.empty((nframes, nvalues), dtype=out_dtype)
    elif dtype.kind == "u":
        signed, bits = 0, 8 * dtype.itemsize
        cmin, cmax = 0, int(np.iinfo(dtype).max)
        out = np.empty((nframes, nvalues), dtype=out_dtype)
    else:  # float target: int64/uint64 semantics, no clamp (Terse.hpp:379-383)
        signed, bits, cmin, cmax = (1 if stream_signed else 0), 64, 0, 0
        out = np.empty((nframes, nvalues), dtype=np.int64)
    # the C side stores the target width directly (clamp/sign semantics
    # applied on the int64 value, then truncated to the output's low
    # bits — exactly what the former astype(dtype) narrowing did)
    rc = lib.trpx_decode_frames(
        _ptr(buf, ctypes.c_uint8), len(payload), nframes, nvalues, block,
        _ptr(widths, ctypes.c_int32), _ptr(poffs, ctypes.c_int64),
        signed, bits, cmin, cmax,
        out.ctypes.data_as(ctypes.c_void_p), out.dtype.itemsize,
    )
    if rc != 0:
        raise ValueError("malformed TRPX payload")
    if dtype.kind == "f":
        if not stream_signed:
            return out.view(np.uint64).astype(dtype)
        return out.astype(dtype)
    return out.astype(dtype, copy=False)  # byte-swap iff target non-native
