"""Normative pure-Python TRPX codec (spec-as-code).

Bit-for-bit reimplementation of the reference encoder semantics
(Terse.hpp:500-549) and the *corrected* decoder (the reference decoder has
frame-offset bugs B1/B2 — SURVEY.md §2.1 — which this implementation fixes by
computing absolute frame offsets; the encoder side is bug-free in the
reference and is matched exactly).

Slow by design: this is the ground truth for the vectorized numpy and CUDA
paths and for conformance tests against the compiled reference binaries.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .bitstream import BitReader, BitWriter
from .header import TrpxMeta, emit_header, parse_header
from .spec import DEFAULT_BLOCK, frame_nbytes, significant_bits


@dataclass
class TrpxArchive:
    """In-memory form of a ``.trpx`` file: metadata + raw bitstream bytes.

    ``frame_index``: optional absolute byte offset of every frame within
    the payload (F entries). NOT part of the normative format — it comes
    from an optional ``.trpx.idx`` sidecar (io/trpx.py) or from having
    encoded the archive ourselves, and lets the decode prepass walk all
    frames in parallel instead of chaining through them.
    """

    meta: TrpxMeta
    payload: bytes
    frame_index: object = None  # np.ndarray (F,) int64 or None

    def to_bytes(self) -> bytes:
        return emit_header(self.meta) + self.payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "TrpxArchive":
        meta, off = parse_header(data)
        payload = data[off : off + meta.memory_size]
        if len(payload) != meta.memory_size:
            raise ValueError(
                f"truncated .trpx payload: have {len(payload)}, "
                f"header says {meta.memory_size}"
            )
        return cls(meta=meta, payload=payload)


def _iter_blocks(n: int, block: int):
    for start in range(0, n, block):
        yield start, min(n, start + block)


def encode(
    frames: np.ndarray | list[np.ndarray],
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Encode one or more equally-sized frames of one integral dtype.

    ``frames``: a single 1-D/2-D array (one frame; 2-D sets dimensions from
    shape unless given) or a list/3-D stack of frames.
    """
    if isinstance(frames, np.ndarray):
        if frames.ndim == 1:
            frame_list = [frames]
        elif frames.ndim == 2:
            if not dimensions:
                # TIFF convention: dimensions = (width, height) i.e. (ncols, nrows)
                dimensions = (frames.shape[1], frames.shape[0])
            frame_list = [frames.reshape(-1)]
        elif frames.ndim == 3:
            if not dimensions:
                dimensions = (frames.shape[2], frames.shape[1])
            frame_list = [f.reshape(-1) for f in frames]
        else:
            raise ValueError("frames must be 1-D, 2-D or 3-D")
    else:
        frame_list = [np.asarray(f).reshape(-1) for f in frames]
    if not frame_list:
        raise ValueError("no frames to encode")
    dtype = frame_list[0].dtype
    if dtype.kind not in "iu":
        raise TypeError(f"only integral dtypes are encodable, got {dtype}")
    signed = dtype.kind == "i"
    size = frame_list[0].size
    for f in frame_list:
        if f.size != size:
            raise ValueError("all frames must have the same size (Terse.hpp:314)")
        if f.dtype != dtype:
            raise ValueError("all frames must share one dtype")

    w = BitWriter()
    prolix_bits = 0
    for frame in frame_list:
        vals = [int(v) for v in frame]
        prev = 0  # reset at each frame start (Terse.hpp:505)
        for lo, hi in _iter_blocks(size, block):
            m = 0
            for v in vals[lo:hi]:
                m |= -v if v < 0 else v
            width = significant_bits(m, signed)
            prolix_bits = max(prolix_bits, width)
            if width == prev:
                w.write(1, 1)
            else:
                w.write(0, 1)
                if width < 7:
                    w.write(width, 3)
                elif width < 10:
                    w.write(0b111 | ((width - 7) << 3), 5)
                else:
                    w.write(0b11111 | ((width - 10) << 5), 11)
                prev = width
            if width:
                for v in vals[lo:hi]:
                    w.write(v, width)
        # next frame begins on the byte after the terminal byte (Terse.hpp:547)
        w.align_to_byte_plus_terminal()

    payload = w.getvalue()[: w.pos >> 3]  # align left pos at an exact byte edge
    meta = TrpxMeta(
        prolix_bits=prolix_bits,
        signed=signed,
        block=block,
        memory_size=len(payload),
        number_of_values=size,
        dimensions=tuple(dimensions),
        number_of_frames=len(frame_list),
    )
    return TrpxArchive(meta=meta, payload=payload)


def walk_frame(
    payload: bytes, start_byte: int, nvalues: int, block: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Walk one frame's block headers without unpacking payload values.

    Returns ``(widths, payload_bit_offsets, next_frame_start_byte)`` where
    offsets are absolute bit positions into ``payload``. This is the serial
    part of decode (Terse.hpp:359-372); everything downstream of it is
    parallel.
    """
    r = BitReader(payload, start_byte * 8)
    nb = -(-nvalues // block)
    widths = np.zeros(nb, dtype=np.int64)
    offsets = np.zeros(nb, dtype=np.int64)
    width = 0  # persists across blocks within a frame
    for b in range(nb):
        if r.read(1) == 0:
            width = r.read(3)
            if width == 7:
                width += r.read(2)
                if width == 10:
                    width += r.read(6)
        widths[b] = width
        offsets[b] = r.pos
        count = min(block, nvalues - b * block)
        r.pos += width * count
    next_start = start_byte + frame_nbytes(r.pos - start_byte * 8)
    return widths, offsets, next_start


def frame_offsets(archive: TrpxArchive) -> list[int]:
    """Absolute byte offset of every frame (fixes reference bugs B1/B2)."""
    meta = archive.meta
    offs = [0]
    pos = 0
    for _ in range(meta.number_of_frames - 1):
        _, _, pos = walk_frame(archive.payload, pos, meta.number_of_values, meta.block)
        offs.append(pos)
    return offs


def concat_archives(*archives: TrpxArchive) -> TrpxArchive:
    """Concatenate archives frame-wise — equivalent to having pushed all
    their frames into one ``jpa::Terse`` (Terse.hpp:312), without
    re-encoding anything.

    Valid because frame streams are independent and byte-aligned: each
    frame's repeat-width chain resets at its start (Terse.hpp:505) and
    frame n+1 begins at the byte after frame n's terminal byte
    (Terse.hpp:502-504,547), so byte-concatenating payloads yields
    exactly the stream a single whole-stack encode would produce
    (property-tested byte-identical in tests/test_terse_adapter.py).

    Archives must agree on values/frame, block and signedness (the
    checks ``push_back`` performs, Terse.hpp:314-319) and on dimensions
    when both declare them; ``prolix_bits`` is the max over inputs
    exactly as one encoder accumulating all frames would have kept it
    (Terse.hpp:516).
    """
    if not archives:
        raise ValueError("concat_archives needs at least one archive")
    head = archives[0].meta
    for a in archives[1:]:
        m = a.meta
        if m.number_of_values != head.number_of_values:
            raise ValueError(
                f"values/frame differ: {m.number_of_values} vs "
                f"{head.number_of_values}")
        if m.block != head.block:
            raise ValueError(f"block differs: {m.block} vs {head.block}")
        if m.signed != head.signed:
            raise ValueError("signedness differs between archives")
        if m.dimensions and head.dimensions and (
                m.dimensions != head.dimensions):
            raise ValueError(
                f"dimensions differ: {m.dimensions} vs {head.dimensions}")
    payload = b"".join(a.payload for a in archives)
    dims = next((a.meta.dimensions for a in archives if a.meta.dimensions),
                ())
    meta = TrpxMeta(
        prolix_bits=max(a.meta.prolix_bits for a in archives),
        signed=head.signed,
        block=head.block,
        memory_size=len(payload),
        number_of_values=head.number_of_values,
        dimensions=dims,
        number_of_frames=sum(a.meta.number_of_frames for a in archives),
    )
    # per-frame byte offsets stay valid under concatenation: shift each
    # archive's index by its payload's start (recover missing indexes
    # with the cheap host walk so one unindexed input doesn't discard
    # the others' random access)
    index: list[int] = []
    base = 0
    for a in archives:
        offs = (a.frame_index if a.frame_index is not None
                else frame_offsets(a))
        index.extend(int(o) + base for o in offs)
        base += len(a.payload)
    return TrpxArchive(meta=meta, payload=payload,
                       frame_index=np.asarray(index, dtype=np.int64))


def _clamp_info(dtype: np.dtype) -> tuple[int, int, int]:
    info = np.iinfo(dtype)
    return int(info.min), int(info.max), info.bits


def decode_frame(
    archive: TrpxArchive, frame: int, dtype, start_byte: int | None = None
) -> np.ndarray:
    """Decode one frame into ``dtype`` with the reference's extraction
    semantics (Bit_pointer.hpp:597-617,742-792):

    * width-0 blocks are zero-filled;
    * if the target dtype is signed, every field whose top bit is set is
      sign-extended as width-bit two's complement (this is what the reference
      does even for unsigned streams — SURVEY B4);
    * if the field width exceeds the target width, the mathematically decoded
      value is clamped to the target range.
    """
    dtype = np.dtype(dtype)
    meta = archive.meta
    if meta.signed and dtype.kind == "u":
        raise TypeError("signed streams must not be decoded into unsigned types "
                        "(Terse.hpp:356-357)")
    if start_byte is None:
        start_byte = frame_offsets(archive)[frame]
    n = meta.number_of_values
    widths, offsets, _ = walk_frame(archive.payload, start_byte, n, meta.block)
    out = np.zeros(n, dtype=np.object_)
    tmin, tmax, tbits = _clamp_info(dtype) if dtype.kind in "iu" else (0, 0, 64)
    # Integral targets sign-extend iff the *target* is signed (B4); float
    # targets go through int64/uint64 picked by the *stream*'s signedness
    # (Terse.hpp:379-383).
    target_signed = dtype.kind == "i" or (dtype.kind == "f" and meta.signed)
    r = BitReader(archive.payload)
    for b, (wdt, off) in enumerate(zip(widths, offsets)):
        wdt = int(wdt)
        lo = b * meta.block
        hi = min(n, lo + meta.block)
        if wdt == 0:
            continue
        r.pos = int(off)
        for i in range(lo, hi):
            u = r.read(wdt)
            if target_signed and (u >> (wdt - 1)) & 1:
                v = u - (1 << wdt)
            else:
                v = u
            if dtype.kind in "iu" and wdt > tbits:
                v = min(max(v, tmin), tmax)
            out[i] = v
    if dtype.kind == "f":
        # float targets go through int64/uint64 casts (Terse.hpp:379-383)
        return out.astype(np.float64).astype(dtype)
    return out.astype(dtype)


def decode(archive: TrpxArchive, dtype) -> np.ndarray:
    """Decode all frames → (nframes, nvalues) array of ``dtype``."""
    meta = archive.meta
    offs = frame_offsets(archive)
    return np.stack(
        [decode_frame(archive, i, dtype, start_byte=offs[i])
         for i in range(meta.number_of_frames)]
    )
