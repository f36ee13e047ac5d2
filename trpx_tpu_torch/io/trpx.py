""".trpx file read/write: one XML header + raw bitstream (Terse.hpp:454-496).

Thin file-boundary helpers over format.TrpxArchive; kept separate from the
codec so streaming/multi-file pipelines have a single place for file I/O.

Sidecar frame index (`<file>.trpx.idx`, NON-normative framework
extension): ``TRPXIDX1`` magic + little-endian u64 frame count + u64
payload size + F×u64 absolute payload byte offsets. With it, the decode
prepass walks all frames in parallel (native OpenMP walk) instead of
chaining through the stream; without it everything still works — the
``.trpx`` bytes themselves are always exactly the reference format.

``TRPXIDX2`` additionally carries the per-block WIDTH tables
(u64 blocks-per-frame + F×nb u8 widths after the offsets): decode then
skips the header walk entirely — the prepass becomes a parallel memcpy
gather, removing the serial-walk bottleneck for decode-many archives
(~19% of the compressed size for the flagship workload; opt-in via
``write_trpx(..., index=True)`` / ``trpx encode --index``).

Both versions end with a little-endian CRC32 of everything before it.
The v2 fast path feeds sidecar offsets straight into the parallel
gather with NO validating walk, so silent sidecar corruption must be
impossible: the CRC rejects any damaged file outright (falling back to
the walk), and the structural checks below still guard against
stale-but-intact or handcrafted tables.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

from ..format.pycodec import TrpxArchive

_IDX_MAGIC = b"TRPXIDX1"
_IDX_MAGIC2 = b"TRPXIDX2"


def _idx_path(path) -> Path:
    p = Path(path)
    return p.with_name(p.name + ".idx")


def write_index(path, offsets, payload_size: int, widths=None) -> None:
    """Write the sidecar index for the ``.trpx`` at ``path``.

    With ``widths`` ((F, nb) per-block field widths, values <= 64) the v2
    format is written and later decodes skip the header walk."""
    offs = np.ascontiguousarray(offsets, dtype="<u8")
    if widths is None:
        blob = (_IDX_MAGIC + struct.pack("<QQ", offs.shape[0], payload_size)
                + offs.tobytes())
    else:
        wt = np.ascontiguousarray(widths, dtype=np.uint8)
        if wt.ndim != 2 or wt.shape[0] != offs.shape[0]:
            raise ValueError("widths must be (n_frames, blocks_per_frame)")
        blob = (_IDX_MAGIC2
                + struct.pack("<QQQ", offs.shape[0], payload_size,
                              wt.shape[1])
                + offs.tobytes() + wt.tobytes())
    blob += struct.pack("<I", zlib.crc32(blob))
    _idx_path(path).write_bytes(blob)


def _offsets_valid(offs: np.ndarray, payload_size: int) -> bool:
    """Structural sanity of sidecar frame offsets: frame 0 at byte 0,
    strictly increasing (every frame carries a terminal byte), all
    inside the payload. The v2 fast path feeds these straight into the
    native parallel gather WITHOUT a validating walk, so a corrupt or
    hostile sidecar must be rejected here, not segfault in memcpy."""
    return bool(
        offs.size > 0
        and offs[0] == 0
        and int(offs[-1]) < payload_size
        and (np.diff(offs) > 0).all()
    )


def read_index_full(path, n_frames: int, payload_size: int):
    """Load the sidecar index if present and consistent.

    Returns (offsets (F,) int64 | None, widths (F, nb) uint8 | None)."""
    p = _idx_path(path)
    try:
        raw = p.read_bytes()
    except OSError:
        return None, None
    # trailing CRC32 first: ANY corruption of the sidecar file is
    # rejected here (decode falls back to the validating walk); the
    # structural checks below then only have to handle stale-but-intact
    # or handcrafted tables
    if len(raw) < 12 or zlib.crc32(raw[:-4]) != struct.unpack(
            "<I", raw[-4:])[0]:
        return None, None
    data = raw[:-4]
    if len(data) >= 32 and data[:8] == _IDX_MAGIC2:
        count, size, nb = struct.unpack("<QQQ", data[8:32])
        if count != n_frames or size != payload_size:
            return None, None  # stale sidecar
        if len(data) != 32 + 8 * count + count * nb:
            return None, None
        offs = np.frombuffer(data, dtype="<u8", offset=32,
                             count=count).astype(np.int64)
        if not _offsets_valid(offs, payload_size):
            return None, None
        wt = np.frombuffer(data, dtype=np.uint8,
                           offset=32 + 8 * count).reshape(count, nb)
        if wt.size and int(wt.max()) > 73:
            # widths beyond the format's 12-bit header maximum
            # (Terse.hpp:530-533: 10 + 63) — corrupt table; treat as
            # stale so decode falls back to (and validates via) the walk
            return None, None
        return offs, wt
    if len(data) < 24 or data[:8] != _IDX_MAGIC:
        return None, None
    count, size = struct.unpack("<QQ", data[8:24])
    if count != n_frames or size != payload_size:
        return None, None  # stale sidecar
    if len(data) != 24 + 8 * count:
        return None, None
    offs = np.frombuffer(data, dtype="<u8", offset=24).astype(np.int64)
    if not _offsets_valid(offs, payload_size):
        return None, None
    return offs, None


def read_index(path, n_frames: int, payload_size: int):
    """Back-compat: offsets only (v1 or v2 sidecar), else None."""
    return read_index_full(path, n_frames, payload_size)[0]


def read_trpx(src) -> TrpxArchive:
    """Read a ``.trpx`` file (path, bytes, or file object) into an archive.

    When reading from a path, a consistent ``.trpx.idx`` sidecar is
    attached as ``archive.frame_index`` (enables the parallel walk)."""
    path = None
    if isinstance(src, (str, os.PathLike)):
        path = src
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        data = src.read()
    arch = TrpxArchive.from_bytes(data)
    if path is not None:
        offs, wt = read_index_full(
            path, arch.meta.number_of_frames, arch.meta.memory_size
        )
        if wt is not None and wt.size and int(wt.max()) > arch.meta.prolix_bits:
            # walk paths enforce width <= prolix_bits (encoder invariant,
            # Terse.hpp:516); a sidecar that skips the walk must meet the
            # same bar or be discarded as corrupt
            offs = wt = None
        arch.frame_index = offs
        if wt is not None:
            arch.width_table = wt  # (F, nb) u8: decode skips the walk
    return arch


def write_trpx(archive: TrpxArchive, dst, index: bool = False) -> None:
    """Write an archive as a ``.trpx`` file (path or file object).

    ``index=True`` (path destinations only) also writes the ``.trpx.idx``
    sidecar, computing frame offsets with the native walker if the
    archive doesn't carry them."""
    blob = archive.to_bytes()
    if isinstance(dst, (str, os.PathLike)):
        with open(dst, "wb") as f:
            f.write(blob)
        if index:
            offs = archive.frame_index
            wt = getattr(archive, "width_table", None)
            if offs is None or wt is None:
                offs, wt = _compute_offsets(archive)
            write_index(dst, offs, archive.meta.memory_size, widths=wt)
    else:
        if index:
            raise ValueError("sidecar index needs a path destination")
        dst.write(blob)


def _compute_offsets(archive: TrpxArchive):
    """One walk -> (frame offsets, (F, nb) u8 width tables) for the v2
    sidecar. Known frame offsets (encoder archives always carry them,
    ops/coding.assemble_archive) make the width walk parallel; otherwise
    a single serial pass yields both."""
    meta = archive.meta
    known = getattr(archive, "frame_index", None)
    try:
        from .. import native

        if native.available():
            if known is not None:
                offs = np.asarray(known, dtype=np.int64)
                widths, _ = native.walk_indexed(
                    archive.payload, offs, meta.number_of_values,
                    meta.block, want_poffs=False,
                    max_width=meta.prolix_bits,
                )
            else:
                widths, _, fstarts = native.walk(
                    archive.payload, meta.number_of_frames,
                    meta.number_of_values, meta.block, want_poffs=False,
                    max_width=meta.prolix_bits,
                )
                offs = fstarts[:-1]
            return offs, widths.astype(np.uint8)
    except Exception as e:
        from .._fallback import warn_once

        warn_once("io.sidecar_walk", e,
                  "serial pure-Python walk for the sidecar index")
    from ..format.pycodec import walk_frame

    nb = -(-meta.number_of_values // meta.block)
    offs = np.zeros(meta.number_of_frames, np.int64)
    widths = np.zeros((meta.number_of_frames, nb), np.uint8)
    pos = 0
    for f in range(meta.number_of_frames):
        offs[f] = pos
        w, _o, pos = walk_frame(archive.payload, pos,
                                meta.number_of_values, meta.block)
        widths[f] = w
    if widths.size and int(widths.max()) > meta.prolix_bits:
        raise ValueError(
            f"corrupt TRPX payload: block width {int(widths.max())} "
            f"exceeds the header's prolix_bits={meta.prolix_bits}")
    return offs, widths


def cached_frame_offsets(archive: TrpxArchive) -> np.ndarray:
    """(F,) int64 byte offset of every frame, computed once and CACHED
    on the archive (with the width tables, so a later decode's prepass
    is walk-free). Distinct from format.pycodec.frame_offsets, the
    pure-Python uncached walk."""
    offs = getattr(archive, "frame_index", None)
    if offs is None:
        offs, wt = _compute_offsets(archive)
        archive.frame_index = offs
        archive.width_table = wt
    return np.asarray(offs, dtype=np.int64)


def subset_frames(archive: TrpxArchive, frames) -> TrpxArchive:
    """Sub-archive holding only the selected frames.

    ``frames``: int, slice, or a sequence of ints (any order, negatives
    allowed). Frames are byte-aligned and independent — the repeat-width
    chain resets at each frame start (Terse.hpp:505) — so their payload
    slices concatenate into a VALID archive of exactly those frames.
    Cost: one cached index walk + O(selected payload bytes); random
    access through the public API is therefore O(frame), not O(archive)
    (the reference's f_find_terse_frame rescans and is wrong for
    frame >= 1 anyway, bugs B1/B2).
    """
    meta = archive.meta
    F = meta.number_of_frames
    if isinstance(frames, slice):
        idx = np.arange(F, dtype=np.int64)[frames]
    else:
        idx = np.atleast_1d(np.asarray(frames, dtype=np.int64))
    if idx.ndim != 1:
        raise ValueError("frames must be an int, slice, or 1-D sequence")
    if idx.size == 0:
        raise ValueError("empty frame selection")
    idx = np.where(idx < 0, idx + F, idx)
    if ((idx < 0) | (idx >= F)).any():
        raise IndexError(f"frame selection out of range [0, {F})")
    if idx.size == F and np.array_equal(idx, np.arange(F)):
        return archive
    offs = cached_frame_offsets(archive)
    ends = np.concatenate([offs[1:], [meta.memory_size]])
    sizes = (ends - offs)[idx]
    starts_new = np.concatenate([[0], np.cumsum(sizes[:-1])])
    total = int(sizes.sum())
    payload = archive.payload
    if idx.size > 1 and (idx[1:] == idx[:-1] + 1).all():
        # contiguous run: one slice, no copy assembly
        blob = payload[int(offs[idx[0]]) : int(ends[idx[-1]])]
    else:
        out = bytearray(total)
        for k, f in enumerate(idx):
            lo, hi = int(offs[f]), int(ends[f])
            out[int(starts_new[k]) : int(starts_new[k]) + (hi - lo)] = (
                payload[lo:hi]
            )
        blob = bytes(out)
    from dataclasses import replace

    sub = TrpxArchive(
        meta=replace(meta, number_of_frames=int(idx.size),
                     memory_size=total),
        payload=blob,
    )
    sub.frame_index = starts_new
    wt = getattr(archive, "width_table", None)
    if wt is not None and wt.shape[0] == F:
        sub.width_table = np.ascontiguousarray(wt[idx])
    return sub
