"""High-level API of the PyTorch port: compress/decompress arrays.

The same surface and routing rules as ``trpx_tpu.api``, with a torch
device in place of the JAX backend:

* ``device=None`` picks the CUDA path for device dtypes ((u)int8/16/32)
  when the workload reaches 4 MiB and ``torch.cuda.is_available()``, else
  the native host codec;
* ``device=False`` forces the host codec;
* ``device=True`` means ``"cuda"``; a ``torch.device`` or a string such as
  ``"cuda"``, ``"cuda:1"`` or ``"cpu"`` forces the torch path on that
  device (on the CPU it runs the kernels' plain PyTorch versions).

There is no fallback from a requested device: if CUDA is missing or a
kernel fails, the call raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from trpx_tpu.api import (
    _DEVICE_CHUNK_FRAMES,
    _DEVICE_KINDS,
    _DEVICE_MIN_BYTES,
    _as_stack,
    _host_encode,
    output_dtype,
)
from trpx_tpu import native
from trpx_tpu.format import pycodec
from trpx_tpu.format.pycodec import TrpxArchive
from trpx_tpu.format.spec import DEFAULT_BLOCK
from trpx_tpu.io.trpx import read_trpx, subset_frames
from trpx_tpu.native import codec as ncodec

from . import ops

__all__ = ["compress", "decompress", "output_dtype"]


def _torch_device(device, auto_ok: bool) -> torch.device | None:
    """The torch device a call runs on, or None for the host codec."""
    if device is None:
        return (torch.device("cuda")
                if auto_ok and torch.cuda.is_available() else None)
    if device is False:
        return None
    if device is True:
        return torch.device("cuda")
    return torch.device(device)


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
    frames = np.asarray(frames)
    if frames.dtype.kind == "f":
        # reference CLI truncates float TIFFs through int64 (terse.cpp:120-123)
        frames = frames.astype(np.int64)
    if frames.dtype.kind not in "iu":
        raise TypeError(f"only integral frames are encodable, got {frames.dtype}")
    stack, dims = _as_stack(frames)
    if dimensions is not None:
        dims = tuple(dimensions)
    dev = _torch_device(device, stack.dtype in _DEVICE_KINDS
                        and stack.nbytes >= _DEVICE_MIN_BYTES)
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

    ``archive`` may be a :class:`TrpxArchive`, the raw ``.trpx`` bytes, or
    a filesystem path (read with any ``.idx`` sidecar). Returns (F, h, w)
    when the header carries 2-D dimensions, else (F, n); single-frame
    archives are squeezed to (h, w) / (n,). ``dtype`` defaults to
    :func:`output_dtype` of the stream. ``frames`` selects a subset (an
    int, slice or sequence of indices) at O(selected frames) cost.
    ``device``: see the module docstring.
    """
    if isinstance(archive, (str, os.PathLike)):
        archive = read_trpx(archive)
    if isinstance(archive, (bytes, bytearray, memoryview)):
        archive = TrpxArchive.from_bytes(bytes(archive))
    if frames is not None:
        archive = subset_frames(archive, frames)
    meta = archive.meta
    dtype = np.dtype(dtype) if dtype is not None else output_dtype(meta)
    if meta.signed and dtype.kind == "u":
        raise TypeError(
            "signed streams must not be decoded into unsigned types "
            "(Terse.hpp:356-357)"
        )
    capacity = 8 * dtype.itemsize if dtype.kind in "iu" else 64
    device_ok = (
        dtype in _DEVICE_KINDS
        and meta.prolix_bits <= capacity + (1 if dtype.kind == "i" else 0)
    )
    raw_bytes = (meta.number_of_frames * meta.number_of_values
                 * dtype.itemsize)
    dev = _torch_device(device, device_ok and raw_bytes >= _DEVICE_MIN_BYTES)
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

        out = np.empty((F, meta.number_of_values), dtype)
        lo = 0
        for chunk in stream.iter_decode(archive, dtype, _DEVICE_CHUNK_FRAMES,
                                        device=dev):
            hi = lo + chunk.shape[0]
            torch.from_numpy(out[lo:hi]).copy_(torch.from_numpy(chunk))
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
