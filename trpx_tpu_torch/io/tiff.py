"""Greyscale TIFF ingest/emit — the container layer of the framework.

A from-scratch numpy implementation with the same capability envelope as the
reference's ``Grey_tif`` (Grey_tif.hpp:321-873): uncompressed single-sample
(greyscale) baseline TIFF, 8/16/32/64-bit, signed/unsigned/float, single
images or stacks, both endiannesses on read, native-endian on write.

Accepted tag set and validation rules mirror ``f_make_Image``
(Grey_tif.hpp:710-827):

* 0x0100 ImageWidth, 0x0101 ImageLength
* 0x0102 BitsPerSample ∈ {8, 16, 32, 64}
* 0x0103 Compression must be 1 (uncompressed)
* 0x0106 PhotometricInterpretation ≤ 1
* 0x0111 StripOffsets (multi-strip allowed, strips must be contiguous —
  Grey_tif.hpp:803-809)
* 0x0115 SamplesPerPixel must be 1
* 0x0117 StripByteCounts
* 0x0153 SampleFormat 1=unsigned / 2=signed / 3=float

The writer mirrors ``f_push_back`` (Grey_tif.hpp:601-625): 8-byte header,
pixel data first, 2-byte padding to even offsets, then a 7-tag IFD per image
(0x0100, 0x0101, 0x0102, 0x0103, 0x0106, 0x0111, 0x0153) with SHORT values
except the LONG strip offset, and a chained next-IFD pointer. Width goes to
0x0100 and height to 0x0101 — the convention of the empty-image overload used
by the ``prolix`` CLI. (The reference's *container* ``push_back`` overload
swaps them — quirk Q1, Grey_tif.hpp:531-532 vs :615-616 — which we
deliberately do not imitate; only square images ever round-trip through that
path anyway.)

Array convention: each image is a 2-D numpy array of shape
``(height, width)`` = (tag 0x0101, tag 0x0100), row-major — matching the
TIFF strip layout directly.

Beyond the reference envelope: **BigTIFF** (magic 43, 64-bit offsets,
20-byte IFD entries, LONG8 fields) is read transparently and written on
demand (``write_tiff(..., bigtiff=True)`` / ``TiffWriter(...,
bigtiff=True)``; the default ``bigtiff="auto"`` of ``write_tiff``
switches only when the file would exceed classic TIFF's 4 GiB offset
cap — a limit the reference reader/writer shares, Grey_tif.hpp uses
uint32 offsets throughout). This lifts the single-file ceiling for
10k+-frame movie stacks; classic output stays byte-identical.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

# (bits, sample_format) -> dtype; sample_format: 1 unsigned, 2 signed, 3 float
_DTYPES: dict[tuple[int, int], np.dtype] = {
    (8, 1): np.dtype(np.uint8),
    (8, 2): np.dtype(np.int8),
    (16, 1): np.dtype(np.uint16),
    (16, 2): np.dtype(np.int16),
    (32, 1): np.dtype(np.uint32),
    (32, 2): np.dtype(np.int32),
    (32, 3): np.dtype(np.float32),
    (64, 1): np.dtype(np.uint64),
    (64, 2): np.dtype(np.int64),
    (64, 3): np.dtype(np.float64),
}

_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}

# IFD field types and their byte sizes (TIFF 6.0 + BigTIFF); the classic
# subset the reference emits/reads: 1=BYTE, 3=SHORT, 4=LONG
# (Grey_tif.hpp:829-840, :743-750); 16=LONG8/17=SLONG8/18=IFD8 are BigTIFF
_FIELD_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 6: 1, 8: 2, 9: 4, 16: 8, 17: 8, 18: 8}

_VAL_DTYPE = {1: "u1", 2: "u2", 4: "u4", 8: "u8"}  # field size -> numpy kind


class TiffError(ValueError):
    """Raised for files outside the supported greyscale-TIFF envelope
    (the reference throws std::runtime_error — Grey_tif.hpp:810-811)."""


@dataclass
class TiffStack:
    """A stack of greyscale images (possibly of different dtypes)."""

    images: list[np.ndarray] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.images[i]

    def __iter__(self):
        return iter(self.images)

    @property
    def dims(self) -> tuple[int, int]:
        """(width, height) of the first image — the ``dim()`` the CLI stores
        into the .trpx ``dimensions`` attribute (terse.cpp:70-71)."""
        h, w = self.images[0].shape
        return (w, h)

    def uniform(self) -> bool:
        """True if all images share shape and dtype (terse.cpp:65-67
        requires uniform stacks)."""
        first = self.images[0]
        return all(
            im.shape == first.shape and im.dtype == first.dtype
            for im in self.images
        )

    def as_array(self) -> np.ndarray:
        """(F, h, w) array; requires a uniform stack."""
        if not self.uniform():
            raise TiffError("stack images differ in shape or dtype")
        return np.stack(self.images)

    def regularize(self, dtype=None) -> "TiffStack":
        """Convert every image to one dtype in place, mirroring
        ``Grey_tif<T>::f_regularize`` (Grey_tif.hpp:627-673):

        * same-itemsize integral→integral conversion REINTERPRETS the bit
          patterns (the reference just relabels the buffer, :636-651);
        * integral↔float of the same size converts values
          (``static_cast`` through the reinterpreted lane, :639-650);
        * different sizes copy with C++ integral-conversion semantics
          (wrap on narrowing, truncate on float→int — ``std::copy_n``
          :655-668).

        ``dtype=None`` regularizes to ``np.result_type`` of the stack (a
        lossless promotion — the reference's template parameter T plays
        that role for typed instances; its byte-typed CLI never
        regularizes, see COMPONENTS.md divergence ledger).
        """
        if dtype is None:
            dtype = np.result_type(*[im.dtype for im in self.images])
        dtype = np.dtype(dtype)
        out = []
        for im in self.images:
            if im.dtype == dtype:
                out.append(im)
            elif (im.dtype.itemsize == dtype.itemsize
                    and im.dtype.kind in "iu" and dtype.kind in "iu"):
                out.append(im.view(dtype))
            elif im.dtype.kind == "f" and dtype.kind in "iu":
                out.append(im.astype(np.int64).astype(dtype))
            else:
                out.append(im.astype(dtype))
        self.images = out
        return self


def _parse_tiff_header(data: bytes):
    """Parse the 8-byte classic / 16-byte BigTIFF header.

    Returns ``(end, big, first_ifd_offset)`` where ``end`` is the struct
    byte-order char and ``big`` selects the 64-bit IFD layout.
    """
    if len(data) < 8:
        raise TiffError("not a TIFF: file shorter than header")
    if data[0:2] == b"II":
        end = "<"
    elif data[0:2] == b"MM":
        end = ">"
    else:
        raise TiffError("not a TIFF: bad byte-order mark")
    (magic,) = struct.unpack(end + "H", data[2:4])
    if magic == 42:
        (ifd_off,) = struct.unpack(end + "I", data[4:8])
        return end, False, ifd_off
    if magic == 43:  # BigTIFF
        if len(data) < 16:
            raise TiffError("truncated BigTIFF header")
        offsize, reserved = struct.unpack(end + "HH", data[4:8])
        if offsize != 8 or reserved != 0:
            raise TiffError("bad BigTIFF header (offset size must be 8)")
        (ifd_off,) = struct.unpack(end + "Q", data[8:16])
        return end, True, ifd_off
    raise TiffError("not a TIFF: magic != 42/43")


def _read_val(end: str, entry: bytes, base: memoryview, big: bool):
    """Decode one IFD entry (12 bytes classic / 20 bytes BigTIFF) ->
    (tag, list-of-values)."""
    tag, ftype = struct.unpack(end + "HH", entry[0:4])
    if big:
        (count,) = struct.unpack(end + "Q", entry[4:12])
        inline, cap = entry[12:20], 8
    else:
        (count,) = struct.unpack(end + "I", entry[4:8])
        inline, cap = entry[8:12], 4
    if ftype not in _FIELD_SIZE:
        return tag, None  # unknown field type: ignore the tag
    fsize = _FIELD_SIZE[ftype]
    nbytes = fsize * count
    if nbytes <= cap:
        raw = inline[:nbytes]
    else:
        (off,) = struct.unpack(end + ("Q" if big else "I"), inline[: cap])
        if off + nbytes > len(base):
            raise TiffError("IFD value offset out of bounds")
        raw = bytes(base[off : off + nbytes])
    return tag, np.frombuffer(raw, dtype=end + _VAL_DTYPE[fsize]).tolist()


def _walk_ifds(base: memoryview, end: str, big: bool, ifd_off: int):
    """Walk the IFD chain (classic or BigTIFF layout), yielding one tag
    dict per image; validates cycles, bounds, and truncation."""
    n = len(base)
    esize, csize, psize = (20, 8, 8) if big else (12, 2, 4)
    cfmt = end + ("Q" if big else "H")   # entry-count field
    pfmt = end + ("Q" if big else "I")   # next-IFD pointer
    seen = set()
    while ifd_off:
        if ifd_off in seen:
            raise TiffError("cyclic IFD chain")
        seen.add(ifd_off)
        if ifd_off + csize > n:
            raise TiffError("IFD offset out of bounds")
        (n_entries,) = struct.unpack(
            cfmt, bytes(base[ifd_off : ifd_off + csize]))
        pos = ifd_off + csize
        if pos + esize * n_entries + psize > n:
            raise TiffError("truncated IFD")
        tags: dict[int, list[int]] = {}
        for _ in range(n_entries):
            tag, vals = _read_val(end, bytes(base[pos : pos + esize]),
                                  base, big)
            if vals is not None:
                tags[tag] = vals
            pos += esize
        (ifd_off,) = struct.unpack(pfmt, bytes(base[pos : pos + psize]))
        yield tags


def read_tiff(src) -> TiffStack:
    """Parse a greyscale TIFF (bytes, path, or file object) into a TiffStack.

    Mirrors Grey_tif's reader: IFD chain walk, tag validation, strip
    contiguity check, and endian normalization of pixel data
    (Grey_tif.hpp:675-827); additionally accepts BigTIFF (magic 43).
    """
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        data = src.read()
    end, big, ifd_off = _parse_tiff_header(data)
    base = memoryview(data)
    stack = TiffStack()
    for tags in _walk_ifds(base, end, big, ifd_off):
        stack.images.append(_make_image(base, end, tags))
    if not stack.images:
        raise TiffError("TIFF contains no images")
    return stack


def _make_image(base: memoryview, end: str, tags: dict[int, list[int]],
                lazy: bool = False):
    def one(tag: int, default: int | None = None) -> int:
        if tag not in tags:
            if default is None:
                raise TiffError(f"missing required TIFF tag 0x{tag:04x}")
            return default
        return tags[tag][0]

    width = one(0x0100)
    height = one(0x0101)
    bits = one(0x0102, 8)
    if bits not in (8, 16, 32, 64):
        raise TiffError(f"unsupported BitsPerSample {bits} (Grey_tif.hpp:755-762)")
    if one(0x0103, 1) != 1:
        raise TiffError("compressed TIFF not supported (Grey_tif.hpp:763-766)")
    if one(0x0106, 1) > 1:
        raise TiffError("non-greyscale photometric (Grey_tif.hpp:767-770)")
    if one(0x0115, 1) != 1:
        raise TiffError("SamplesPerPixel != 1 (Grey_tif.hpp:784-787)")
    fmt = one(0x0153, 1)
    if (bits, fmt) not in _DTYPES:
        raise TiffError(f"unsupported SampleFormat {fmt} at {bits} bits")
    offsets = tags.get(0x0111)
    if not offsets:
        raise TiffError("missing StripOffsets")
    counts = tags.get(0x0117)
    nbytes = width * height * (bits // 8)
    if counts is None:
        # the reference tolerates a missing StripByteCounts for single-strip
        # files (it only uses counts for the contiguity check)
        counts = [nbytes]
    # strips must be contiguous in the file (Grey_tif.hpp:803-809)
    if len(offsets) > 1:
        run = offsets[0]
        for off, cnt in zip(offsets, counts):
            if off != run:
                raise TiffError("non-contiguous TIFF strips (Grey_tif.hpp:803-809)")
            run = off + cnt
    if sum(counts) < nbytes:
        raise TiffError("strip byte counts smaller than image")
    start = offsets[0]
    if start + nbytes > len(base):
        raise TiffError("pixel data out of bounds")
    dtype = _DTYPES[(bits, fmt)].newbyteorder(end)
    if lazy:
        return TiffFrameInfo(offset=start, width=width, height=height,
                             dtype=dtype)
    arr = np.frombuffer(base, dtype=dtype, count=width * height, offset=start)
    # normalize to native endianness like Grey_tif does in place
    # (Grey_tif.hpp:814-823)
    arr = arr.astype(dtype.newbyteorder("="), copy=True)
    return arr.reshape(height, width)


@dataclass(frozen=True)
class TiffFrameInfo:
    """Location of one image's pixels inside a TIFF file (for streaming)."""

    offset: int
    width: int
    height: int
    dtype: np.dtype  # byte order encoded in the dtype

    @property
    def nbytes(self) -> int:
        return self.width * self.height * self.dtype.itemsize


class TiffStream:
    """Memory-mapped TIFF stack reader: parses the IFD chain once, then
    serves frame ranges without loading the whole file — the ingest path
    for 10k+-frame movie stacks (the reference slurps whole files,
    Grey_tif.hpp:365-369)."""

    def __init__(self, path):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        end, big, ifd_off = _parse_tiff_header(self._mm[:16].tobytes())
        base = memoryview(self._mm)
        self.infos: list[TiffFrameInfo] = []
        for tags in _walk_ifds(base, end, big, ifd_off):
            self.infos.append(_make_image(base, end, tags, lazy=True))
        if not self.infos:
            raise TiffError("TIFF contains no images")

    def __len__(self) -> int:
        return len(self.infos)

    @property
    def dims(self) -> tuple[int, int]:
        return (self.infos[0].width, self.infos[0].height)

    def uniform(self) -> bool:
        f0 = self.infos[0]
        return all(
            (i.width, i.height, i.dtype) == (f0.width, f0.height, f0.dtype)
            for i in self.infos
        )

    def read(self, lo: int, hi: int) -> np.ndarray:
        """Load frames [lo, hi) -> (hi-lo, h, w) native-endian array.

        Native-endian files go through the native parallel gather (one
        OpenMP memcpy per frame — the serial per-frame numpy copy before
        it was ~1 ms/frame at 512², more than the encode itself in the
        e2e pipeline); foreign endianness falls back to per-frame numpy
        copies with byte-order conversion."""
        infos = self.infos[lo:hi]
        f0 = infos[0]
        for info in infos:
            if ((info.width, info.height, info.dtype)
                    != (f0.width, f0.height, f0.dtype)):
                raise TiffError("read() needs uniform frames "
                                "(use TiffStack.regularize for mixed)")
        out = np.empty((len(infos), f0.height, f0.width),
                       dtype=f0.dtype.newbyteorder("="))
        if f0.dtype == out.dtype:  # native order: memcpy == value copy
            try:
                from .. import native

                if native.available():
                    starts = np.array([i.offset for i in infos], np.int64)
                    native.gather_frames(
                        self._mm, starts, starts + f0.nbytes,
                        out.reshape(len(infos), -1).view(np.uint8))
                    return out
            except (OSError, RuntimeError):
                pass  # no compiler/library: numpy fallback below
        for k, info in enumerate(infos):
            src = np.frombuffer(
                self._mm, dtype=info.dtype,
                count=info.width * info.height, offset=info.offset,
            )
            out[k] = src.reshape(info.height, info.width)
        return out

    def iter_chunks(self, chunk_frames: int = 256):
        for lo in range(0, len(self.infos), chunk_frames):
            yield self.read(lo, min(len(self.infos), lo + chunk_frames))

    def close(self) -> None:
        del self._mm


def needs_bigtiff(total_pixel_bytes: int, n_images: int) -> bool:
    """True when a classic TIFF cannot safely hold the stack.

    The single source of truth for the BigTIFF switch: its margin
    (4096 bytes/image) dominates the writers' per-image overflow guard
    (``pos + nbytes + 4096``; real IFD overhead is ~104 bytes/image), so
    ``bigtiff="auto"``/streaming callers that consult it can never pick
    classic and then hit the guard mid-write.
    """
    return total_pixel_bytes + 4096 * n_images + 16 > 0xFFFFFFFF


def _ifd_entry(tag: int, ftype: int, value: int) -> bytes:
    """One 12-byte little-endian IFD entry, count 1 (Grey_tif.hpp:829-840)."""
    raw = struct.pack("<HHI", tag, ftype, 1)
    if ftype == 3:
        return raw + struct.pack("<HH", value, 0)
    return raw + struct.pack("<I", value)


def _ifd_entry_big(tag: int, ftype: int, value: int) -> bytes:
    """One 20-byte BigTIFF IFD entry, count 1 (value zero-padded to 8)."""
    raw = struct.pack("<HHQ", tag, ftype, 1)
    if ftype == 3:
        return raw + struct.pack("<HHI", value, 0, 0)
    if ftype == 4:
        return raw + struct.pack("<II", value, 0)
    return raw + struct.pack("<Q", value)  # 16 = LONG8


def _image_entries(w: int, h: int, bits: int, fmt: int, data_start: int,
                   nbytes: int, big: bool) -> list[bytes]:
    """The per-image IFD entry list shared by both writers; BigTIFF uses
    LONG8 for the strip offset/count so data may sit beyond 4 GiB."""
    e = _ifd_entry_big if big else _ifd_entry
    return [
        e(0x0100, 3 if w < 65536 else 4, w),
        e(0x0101, 3 if h < 65536 else 4, h),
        e(0x0102, 3, bits),
        e(0x0103, 3, 1),
        e(0x0106, 3, 1),
        e(0x0111, 16 if big else 4, data_start),
        e(0x0117, 16 if big else 4, nbytes),
        e(0x0153, 3, fmt),
    ]


def write_tiff(images, dst=None, *, bigtiff="auto") -> bytes | None:
    """Serialize image(s) to an uncompressed greyscale TIFF.

    ``images``: one 2-D array, a (F, h, w) array, a list of 2-D arrays, or a
    TiffStack. Written little-endian ("II") regardless of host byte order,
    data-first like the reference (header, pixels, IFD — Grey_tif.hpp:601-625,
    so pixels of image 0 start at byte 8). Returns the bytes, or writes to
    ``dst`` (path or file object) if given.

    ``bigtiff``: True → BigTIFF (magic 43, 64-bit offsets); False →
    classic (raises past the 4 GiB cap); "auto" (default) → classic
    unless the stack would overflow it.
    """
    if isinstance(images, TiffStack):
        imgs = images.images
    elif isinstance(images, np.ndarray):
        imgs = [images] if images.ndim == 2 else list(images)
    else:
        imgs = list(images)
    if not imgs:
        raise TiffError("no images to write")
    if bigtiff == "auto":
        total = sum(np.asarray(im).nbytes for im in imgs)
        big = needs_bigtiff(total, len(imgs))
    else:
        big = bool(bigtiff)

    # Zero-copy assembly: pixel data stays as memoryviews of the callers'
    # arrays (the bytearray += tobytes() version copied the payload three
    # times — tobytes, append, final write — which dominated prolix-CLI
    # e2e decode once the codec itself passed ~1,300 fps host-side).
    chunks: list = []       # bytes-like pieces, written in order
    pos = 0
    if big:
        hdr = bytearray(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
        patch_off = 8                  # first-IFD pointer in the header
    else:
        hdr = bytearray(b"II" + struct.pack("<HI", 42, 0))
        patch_off = 4  # next-IFD pointer (Grey_tif.hpp:339)
    pfmt = "<Q" if big else "<I"
    chunks.append(hdr)
    pos = len(hdr)
    patch_chunk = 0
    for img in imgs:
        img = np.ascontiguousarray(img)
        if img.ndim != 2:
            raise TiffError("each image must be 2-D (height, width)")
        if img.dtype.kind not in _SAMPLE_FORMAT:
            raise TiffError(f"unsupported dtype {img.dtype}")
        bits = img.dtype.itemsize * 8
        fmt = _SAMPLE_FORMAT[img.dtype.kind]
        if (bits, fmt) not in _DTYPES:
            raise TiffError(f"unsupported dtype {img.dtype}")
        h, w = img.shape
        data_start = pos
        if not big and pos + img.nbytes + 4096 > 0xFFFFFFFF:
            raise TiffError(
                "classic TIFF caps at 4 GiB (32-bit offsets; the "
                "reference reader/writer shares the limit) — pass "
                "bigtiff=True or split the stack across files")
        le = np.ascontiguousarray(
            img.astype(img.dtype.newbyteorder("<"), copy=False))
        chunks.append(memoryview(le).cast("B"))
        nbytes = h * w * (bits // 8)
        pos += nbytes
        ifd = bytearray()
        if pos & 1:
            ifd += b"\x00"  # word-align the IFD (Grey_tif.hpp:608-611)
            pos += 1
        ifd_at = pos
        struct.pack_into(pfmt, chunks[patch_chunk], patch_off, ifd_at)
        entries = _image_entries(w, h, bits, fmt, data_start, nbytes, big)
        ifd += struct.pack("<Q" if big else "<H", len(entries))
        for e in entries:
            ifd += e
        patch_chunk = len(chunks)           # this ifd chunk, appended next
        patch_off = len(ifd)                # next-IFD pointer inside it
        ifd += struct.pack(pfmt, 0)
        chunks.append(ifd)
        pos = ifd_at + len(ifd) - (1 if ifd[:1] == b"\x00" else 0)

    if dst is None:
        return b"".join(chunks)
    if isinstance(dst, (str, os.PathLike)):
        with open(dst, "wb") as f:
            for c in chunks:
                f.write(c)
    else:
        for c in chunks:
            dst.write(c)
    return None


class TiffWriter:
    """Incremental greyscale-TIFF writer: append frames as they arrive.

    Produces byte-identical output to :func:`write_tiff` of the full
    stack (data-first, per-image chained IFDs), but with O(chunk)
    memory — the streaming-decode counterpart of :class:`TiffStream`.
    Requires a seekable destination (the previous image's next-IFD
    pointer is patched in place).

    ``bigtiff=True`` writes BigTIFF (magic 43, 64-bit offsets) for
    stacks past classic TIFF's 4 GiB cap; the format must be chosen up
    front because the header is emitted at construction (callers that
    know the decoded size — e.g. the streaming-decode CLI — compute it
    from frames × values × itemsize).
    """

    def __init__(self, dst, *, bigtiff: bool = False) -> None:
        self._own = isinstance(dst, (str, os.PathLike))
        self._big = bool(bigtiff)
        self.f = open(dst, "wb") if self._own else dst
        if self._big:
            self.f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
            self._patch_at = 8
            self._pos = 16
        else:
            self.f.write(b"II" + struct.pack("<HI", 42, 0))
            self._patch_at = 4  # file offset of the pointer to the next IFD
            self._pos = 8

    def append(self, frames: np.ndarray) -> None:
        """Append one 2-D image or an (F, h, w) stack."""
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        if frames.ndim != 3:
            raise TiffError("append() takes a 2-D image or (F, h, w) stack")
        for img in frames:
            img = np.ascontiguousarray(img)
            if img.dtype.kind not in _SAMPLE_FORMAT:
                raise TiffError(f"unsupported dtype {img.dtype}")
            bits = img.dtype.itemsize * 8
            fmt = _SAMPLE_FORMAT[img.dtype.kind]
            if (bits, fmt) not in _DTYPES:
                raise TiffError(f"unsupported dtype {img.dtype}")
            h, w = img.shape
            if not self._big and self._pos + img.nbytes + 4096 > 0xFFFFFFFF:
                raise TiffError(
                    "classic TIFF caps at 4 GiB (32-bit offsets; the "
                    "reference reader/writer shares the limit) — pass "
                    "bigtiff=True or split the stack across files")
            data_start = self._pos
            le = np.ascontiguousarray(
                img.astype(img.dtype.newbyteorder("<"), copy=False))
            self.f.write(memoryview(le).cast("B"))
            self._pos += img.nbytes
            ifd = bytearray()
            if self._pos & 1:
                ifd += b"\x00"
                self._pos += 1
            ifd_at = self._pos
            entries = _image_entries(w, h, bits, fmt, data_start,
                                     h * w * (bits // 8), self._big)
            pfmt = "<Q" if self._big else "<I"
            ifd += struct.pack("<Q" if self._big else "<H", len(entries))
            for e in entries:
                ifd += e
            pad = 1 if ifd[:1] == b"\x00" else 0
            next_ptr_at = ifd_at + len(ifd) - pad  # next-IFD ptr position
            ifd += struct.pack(pfmt, 0)
            self.f.write(ifd)
            end = self.f.tell()
            self.f.seek(self._patch_at)
            self.f.write(struct.pack(pfmt, ifd_at))
            self.f.seek(end)
            self._patch_at = next_ptr_at
            self._pos = end

    def close(self) -> None:
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
