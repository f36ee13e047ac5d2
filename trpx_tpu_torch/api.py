"""High-level API of the PyTorch port: compress/decompress arrays.

The surface of ``trpx_tpu.api`` with a torch device in place of the JAX
backend. The entry points run on the card unless the caller asks for the
CPU:

* ``device=None`` (the default) and ``device=True`` mean ``"cuda"``; on a
  machine without a card the call raises RuntimeError;
* a ``torch.device`` or its name (``"cuda"``, ``"cuda:1"``, ``"cpu"``)
  runs the torch path there; on ``"cpu"`` it runs the kernels' plain
  PyTorch versions;
* ``device=False`` runs the native host codec.

64-bit frames (and float frames, truncated through int64 as the
reference CLI does) have no kernel in either package: with
``device=None`` they take the host codec, as do decodes into a target the
kernels cannot hold (64-bit, or a stream wider than the target).

There is no fallback from a device: a missing card or a failing kernel
raises.

Each call counts in ``calls.api.compress`` or ``calls.api.decompress``
(``runtime.metrics``). The parse of bytes, a path or a file runs in the
span ``trpx.api.parse``, and a decode of more than
``_DEVICE_CHUNK_FRAMES`` frames copies its chunks into the output in
``trpx.api.consume``; both count the host bytes they write and allocate.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import native, ops
from .format import pycodec
from .format.header import TrpxMeta, emit_header
from .format.pycodec import TrpxArchive
from .format.spec import DEFAULT_BLOCK
from .io.trpx import read_trpx, subset_frames
from .native import codec as ncodec
from .ops import coding
from .runtime.metrics import count, span

__all__ = ["compress", "decompress", "output_dtype"]

#: dtypes the kernels encode and decode
_DEVICE_KINDS = frozenset(coding._DEVICE_DTYPES)

#: device decodes beyond this many frames stream through the chunked
#: walk || unpack pipeline (runtime/stream.iter_decode) instead of one
#: whole-archive call: host buffers stay O(chunk) and the serial header
#: walk overlaps the device
_DEVICE_CHUNK_FRAMES = 256


def _torch_device(device) -> torch.device | None:
    """The torch device a call runs on, or None for the host codec
    (``device=False``). None and True mean ``"cuda"``; a CUDA device on a
    machine without a card raises RuntimeError."""
    if device is False:
        return None
    dev = torch.device("cuda" if device is None or device is True
                       else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "trpx_tpu_torch runs on a CUDA card unless asked otherwise, and "
            "this machine has none: pass device='cpu' for the kernels' "
            "plain PyTorch versions or device=False for the native host "
            "codec")
    return dev


def _route(device, kernel_ok: bool) -> torch.device | None:
    """:func:`_torch_device`, except that ``device=None`` sends what no
    kernel takes (``kernel_ok`` false) to the host codec."""
    if device is None and not kernel_ok:
        return None
    return _torch_device(device)


def _as_stack(frames) -> tuple[np.ndarray, tuple[int, ...]]:
    """Normalize input to (F, n) plus the dimensions attribute tuple."""
    frames = np.asarray(frames)
    dims: tuple[int, ...] = ()
    if frames.ndim == 1:
        frames = frames[None]
    elif frames.ndim == 2:
        # a single image: dimensions = (width, height) (terse.cpp:70-71)
        dims = (frames.shape[1], frames.shape[0])
        frames = frames.reshape(1, -1)
    elif frames.ndim == 3:
        dims = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    else:
        raise ValueError("frames must be 1-D, 2-D (one image) or 3-D (stack)")
    if frames.shape[0] == 0 or frames.shape[1] == 0:
        # match the normative codec (format/pycodec.py): a degenerate
        # 0-frame/0-value archive is never valid TRPX
        raise ValueError("no frames to encode")
    return frames, dims


def _host_encode(stack, block, dims) -> TrpxArchive:
    if native.available():
        return ncodec.encode(stack, block=block, dimensions=dims)
    return pycodec.encode(list(stack), block=block, dimensions=dims)


def output_dtype(meta: TrpxMeta) -> np.dtype:
    """Output pixel dtype the way the prolix CLI picks it (prolix.cpp:69-92),
    with bug B3 fixed (true 32-bit paths) and 64-bit supported."""
    bits = meta.prolix_bits
    if meta.signed:
        if bits <= 16:
            return np.dtype(np.int16)
        if bits <= 32:
            return np.dtype(np.int32)
        return np.dtype(np.int64)
    if bits <= 16:
        return np.dtype(np.uint16)
    if bits <= 32:
        return np.dtype(np.uint32)
    return np.dtype(np.uint64)


def _decode_ok(meta: TrpxMeta, dtype: np.dtype) -> bool:
    """True if the unpack kernels can decode the stream into ``dtype``
    (``ops.coding.kernel_decodes``)."""
    return coding.kernel_decodes(dtype, meta.prolix_bits)


def _as_archive(archive) -> TrpxArchive:
    """An archive of this package from itself, ``.trpx`` bytes, a path (read
    with any ``.idx`` sidecar) or a file object. Other than an archive, in
    the span ``trpx.api.parse``, which counts the ``.trpx`` bytes read or
    copied, a sidecar's width table read, and the payload's copy."""
    if isinstance(archive, TrpxArchive):
        return archive
    is_path = isinstance(archive, (str, os.PathLike))
    is_buffer = isinstance(archive, (bytes, bytearray, memoryview))
    if not (is_path or is_buffer or hasattr(archive, "read")):
        raise TypeError(
            "expected a trpx_tpu_torch TrpxArchive, .trpx bytes, a path or "
            f"a file object, got {type(archive).__module__}."
            f"{type(archive).__name__} (an archive of another package "
            "crosses as its to_bytes())")
    with span("trpx.api.parse") as s:
        arch = read_trpx(archive)
        size = arch.meta.memory_size
        if is_path:
            read = os.path.getsize(archive)
            table = getattr(arch, "width_table", None)
            if table is not None:
                # the sidecar's file and the copy its width table views
                read += 2 * table.nbytes
        elif is_buffer:
            # bytes are parsed as they are; another buffer is copied first
            read = (0 if isinstance(archive, bytes)
                    else memoryview(archive).nbytes)
        else:
            read = len(emit_header(arch.meta)) + size
        s.fresh(read + size)
        s.host(read + size)
    return arch


def compress(
    frames,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] | None = None,
    device=None,
) -> TrpxArchive:
    """Losslessly compress integral frames into a TRPX archive.

    ``frames``: (n,), (h, w) or (F, h, w) array (or nested lists).
    ``dimensions``: overrides the dims stored in the header.
    ``device``: see the module docstring.
    """
    count("calls.api.compress")
    frames = np.asarray(frames)
    if frames.dtype.kind == "f":
        # reference CLI truncates float TIFFs through int64 (terse.cpp:120-123)
        frames = frames.astype(np.int64)
    if frames.dtype.kind not in "iu":
        raise TypeError(f"only integral frames are encodable, got {frames.dtype}")
    stack, dims = _as_stack(frames)
    if dimensions is not None:
        dims = tuple(dimensions)
    dev = _route(device, stack.dtype in _DEVICE_KINDS)
    if dev is None:
        return _host_encode(stack, block, dims)
    return ops.encode(stack, block=block, dimensions=dims, device=dev)


def decompress(
    archive: TrpxArchive | bytes | str,
    dtype=None,
    device=None,
    frames=None,
) -> np.ndarray:
    """Decode an archive to pixels.

    ``archive`` may be a :class:`TrpxArchive`, the raw ``.trpx`` bytes, a
    filesystem path (read with any ``.idx`` sidecar) or a file object.
    Returns (F, h, w) when the header carries 2-D dimensions, else (F, n);
    single-frame archives are squeezed to (h, w) / (n,). ``dtype``
    defaults to :func:`output_dtype` of the stream. ``frames`` selects a
    subset (an int, slice or sequence of indices) at O(selected frames)
    cost. ``device``: see the module docstring.

    A decode of up to ``_DEVICE_CHUNK_FRAMES`` frames on a card may
    return page-locked memory, lent from torch's caching host allocator
    while the results that callers hold stay within
    ``ops.staging.PINNED_RESULT_BYTES`` (``ops.decode``); its block goes
    back to torch's cache when the result and every view of it have died.
    """
    count("calls.api.decompress")
    archive = _as_archive(archive)
    if frames is not None:
        archive = subset_frames(archive, frames)
    meta = archive.meta
    dtype = np.dtype(dtype) if dtype is not None else output_dtype(meta)
    if meta.signed and dtype.kind == "u":
        raise TypeError(
            "signed streams must not be decoded into unsigned types "
            "(Terse.hpp:356-357)"
        )
    device_ok = _decode_ok(meta, dtype)
    dev = _route(device, device_ok)
    if dev is not None and not device_ok:
        raise ValueError(
            f"device decode unavailable for dtype {dtype} with "
            f"prolix_bits={meta.prolix_bits}"
        )
    F = meta.number_of_frames
    if dev is None:
        out = (ncodec.decode(archive, dtype) if native.available()
               else pycodec.decode(archive, dtype))
    elif F > _DEVICE_CHUNK_FRAMES:
        # big archives stream through the pipelined chunked decode: host
        # buffers of O(chunk), and the header walk of chunk k+1 overlaps
        # the device unpack of chunk k; each chunk lands in its slice of
        # one preallocated output, by torch's copy on all host threads
        from .runtime import stream

        with span("trpx.api.consume") as s:
            out = np.empty((F, meta.number_of_values), dtype)
            s.fresh(out.nbytes)
        lo = 0
        for chunk in stream.iter_decode(archive, dtype, _DEVICE_CHUNK_FRAMES,
                                        device=dev):
            with span("trpx.api.consume") as s:
                hi = lo + chunk.shape[0]
                torch.from_numpy(out[lo:hi]).copy_(torch.from_numpy(chunk))
                s.host(chunk.nbytes)
            lo = hi
    else:
        out = ops.decode(archive, dtype, device=dev)
    if len(meta.dimensions) == 2:
        w, h = meta.dimensions
        if w * h == meta.number_of_values:
            out = out.reshape(F, h, w)
    if F == 1:
        out = out[0]
    return out
