"""Archive-level host codec on top of the native C++ runtime.

Mirrors ``format.pycodec``'s encode/decode API at C speed. Used by the
public API for 64-bit dtypes (outside the device path) and as the fast host
fallback when no accelerator is present.
"""

from __future__ import annotations

import numpy as np

from ..format.header import TrpxMeta
from ..format.pycodec import TrpxArchive
from ..format.spec import DEFAULT_BLOCK
from . import available, decode_frames, encode_frames


def encode(
    frames: np.ndarray,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Encode (F, n) integral frames (any width up to 64-bit)."""
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[None]
    if frames.dtype.kind not in "iu":
        raise TypeError(f"only integral dtypes are encodable, got {frames.dtype}")
    signed = frames.dtype.kind == "i"
    # the C encoder is templated on the element size: frames pass through
    # in their own dtype (no int64-widening copy)
    payload, fstarts, prolix = encode_frames(frames, block, signed)
    meta = TrpxMeta(
        prolix_bits=prolix,
        signed=signed,
        block=block,
        memory_size=len(payload),
        number_of_values=frames.shape[1],
        dimensions=tuple(dimensions),
        number_of_frames=frames.shape[0],
    )
    arch = TrpxArchive(meta=meta, payload=payload)
    arch.frame_index = fstarts[:-1]  # parallel walk on later decodes
    return arch


def decode(archive: TrpxArchive, dtype) -> np.ndarray:
    """Decode all frames -> (F, n) of ``dtype``."""
    dtype = np.dtype(dtype)
    meta = archive.meta
    if meta.signed and dtype.kind == "u":
        raise TypeError(
            "signed streams must not be decoded into unsigned types "
            "(Terse.hpp:356-357)"
        )
    return decode_frames(
        archive.payload,
        meta.number_of_frames,
        meta.number_of_values,
        meta.block,
        dtype,
        stream_signed=meta.signed,
        max_width=meta.prolix_bits,
        fstarts=getattr(archive, "frame_index", None),
    )


__all__ = ["encode", "decode", "available"]
