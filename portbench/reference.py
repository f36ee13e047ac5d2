"""Plain TRPX reference: the benchmark's own encoder and decoder.

Written from ``docs/FORMAT.md`` alone. It imports nothing of the program
(``trpx_tpu_torch``) nor of the JAX package, and works out from the frames
everything the program derives from them: block widths, headers, bit
positions, frame sizes, the payload, the header element and the ``.idx``
sidecar.

The encoder is plain PyTorch, so it runs on whatever device holds the
frames (the card after a run's window, the CPU in the tests). Every field
of a frame's stream is at most 32 bits (a value of at most 32 bits, or a
header of at most 12), and no two fields share a bit, so each field is
added, shifted, into the two 32-bit words it can touch: a sum of fields
that share no bit is their OR. The decoder is a plain serial walk in
NumPy, for checking small archives.

Unsigned frames only: the benchmark's configurations are unsigned.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

#: values one encode pass holds (bounds the temporaries of a pass)
PASS_VALUES = 1 << 24

#: numpy dtype -> (signed view used to move it into torch, value mask)
_VIEWS = {
    np.dtype(np.uint8): (np.int8, 0xFF),
    np.dtype(np.uint16): (np.int16, 0xFFFF),
    np.dtype(np.uint32): (np.int32, 0xFFFFFFFF),
}


@dataclass
class Meta:
    """The header's attributes (FORMAT.md section 1)."""

    prolix_bits: int
    signed: bool
    block: int
    memory_size: int
    number_of_values: int
    dimensions: tuple
    number_of_frames: int


def header_bytes(meta: Meta) -> bytes:
    """The ``<Terse .../>`` element: fixed attribute order, ``signed`` as
    0/1, dimensions space-separated and only when known, no newline."""
    s = (f'<Terse prolix_bits="{meta.prolix_bits}"'
         f' signed="{1 if meta.signed else 0}"'
         f' block="{meta.block}"'
         f' memory_size="{meta.memory_size}"'
         f' number_of_values="{meta.number_of_values}"')
    if meta.dimensions:
        s += ' dimensions="' + " ".join(map(str, meta.dimensions)) + '"'
    s += f' number_of_frames="{meta.number_of_frames}"/>'
    return s.encode("ascii")


@dataclass
class Archive:
    """A reference archive: header attributes, payload and the frame
    table the encoder knows (byte offsets, per-block widths)."""

    meta: Meta
    payload: bytes
    frame_index: np.ndarray = field(repr=False)
    widths: np.ndarray = field(repr=False)

    def to_bytes(self) -> bytes:
        return header_bytes(self.meta) + self.payload


@dataclass
class Streams:
    """Each frame's stream of a set of frames, encoded once: frame ``i``
    is ``payload[offsets[i]:offsets[i + 1]]``. Frames are byte-aligned and
    independent (FORMAT.md section 3), so any choice of them concatenates
    into a valid archive (:meth:`archive`)."""

    payload: np.ndarray     # uint8
    offsets: np.ndarray     # (P + 1,) int64
    widths: np.ndarray      # (P, nb) uint8
    n: int
    block: int

    def archive(self, index, dimensions=()) -> Archive:
        """The archive of frames ``index`` (any order, repeats allowed)."""
        index = np.asarray(index, np.int64)
        lo, hi = self.offsets[index], self.offsets[index + 1]
        sizes = hi - lo
        payload = np.concatenate([self.payload[a:b] for a, b in zip(lo, hi)])
        offs = np.zeros(len(index), np.int64)
        np.cumsum(sizes[:-1], out=offs[1:])
        widths = self.widths[index]
        meta = Meta(prolix_bits=int(widths.max()), signed=False,
                    block=self.block, memory_size=int(sizes.sum()),
                    number_of_values=self.n, dimensions=tuple(dimensions),
                    number_of_frames=len(index))
        return Archive(meta, payload.tobytes(), offs, widths)


def to_torch(frames: np.ndarray, device) -> torch.Tensor:
    """(F, n) unsigned frames as an int64 tensor on ``device``."""
    frames = np.ascontiguousarray(frames)
    if frames.dtype not in _VIEWS:
        raise TypeError(f"the reference encodes uint8/16/32, not {frames.dtype}")
    view, mask = _VIEWS[frames.dtype]
    t = torch.from_numpy(frames.view(view)).to(device)
    return t.long() & mask


def bit_length(t: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values below 2**53 (0 for 0):
    frexp's exponent, exact for such values."""
    return torch.frexp(t.double())[1].long()


def block_widths(x: torch.Tensor, block: int) -> torch.Tensor:
    """(F, nb) widths of (F, n) int64 unsigned values: the bit length of
    each block's largest value (FORMAT.md section 3, step 1)."""
    F, n = x.shape
    nb = -(-n // block)
    if nb * block != n:
        x = torch.nn.functional.pad(x, (0, nb * block - n))
    return bit_length(x.view(F, nb, block).amax(-1))


def _headers(w: torch.Tensor):
    """(value, bits) of each block's header (FORMAT.md section 3, step 2):
    the previous width starts at 0 in each frame."""
    prev = torch.zeros_like(w)
    prev[:, 1:] = w[:, :-1]
    rep = w == prev
    bits = torch.where(rep, 1, torch.where(w < 7, 4, torch.where(w < 10, 6, 12)))
    val = torch.where(
        rep, 1, torch.where(
            w < 7, w << 1, torch.where(
                w < 10, 14 | ((w - 7) << 4), 14 | (3 << 4) | ((w - 10) << 6))))
    return val, bits


def _counts(n: int, block: int, device) -> torch.Tensor:
    """(nb,) values in each block: the last one may be partial."""
    nb = -(-n // block)
    c = torch.full((nb,), block, dtype=torch.int64, device=device)
    c[-1] = n - (nb - 1) * block
    return c


def _encode_pass(x: torch.Tensor, block: int):
    """Encode (F, n) int64 values -> (payload uint8, (F,) frame bytes,
    (F, nb) widths), all on the host."""
    F, n = x.shape
    dev = x.device
    nb = -(-n // block)
    w = block_widths(x, block)
    hval, hbits = _headers(w)
    bbits = hbits + w * _counts(n, block, dev)
    fbytes = 1 + bbits.sum(1) // 8
    # bit position of each frame, then of each block, then of each value
    fstart = torch.zeros(F, dtype=torch.int64, device=dev)
    fstart[1:] = torch.cumsum(fbytes, 0)[:-1] * 8
    bstart = fstart[:, None] + torch.cumsum(bbits, 1) - bbits
    j = torch.arange(block, device=dev)
    voff = (bstart + hbits)[:, :, None] + j * w[:, :, None]
    if nb * block != n:
        x = torch.nn.functional.pad(x, (0, nb * block - n))
    total = int(fbytes.sum())
    # values past n are 0: they add nothing, a few words past the end
    words = torch.zeros(total // 4 + 2 + block, dtype=torch.int64, device=dev)
    for off, val in ((bstart.reshape(-1), hval.reshape(-1)),
                     (voff.reshape(-1), x.reshape(-1))):
        shifted = val << (off & 31)
        k = off >> 5
        words.index_add_(0, k, shifted & 0xFFFFFFFF)
        words.index_add_(0, k + 1, shifted >> 32)
    payload = words.cpu().numpy().astype("<u4").view(np.uint8)[:total]
    return payload, fbytes.cpu().numpy(), w.to(torch.uint8).cpu().numpy()


def encode_streams(frames: np.ndarray, block: int, device="cpu") -> Streams:
    """Every frame's stream of (F, n) unsigned ``frames``, encoded on
    ``device`` in passes of at most :data:`PASS_VALUES` values."""
    frames = np.asarray(frames)
    F, n = frames.shape
    step = max(1, PASS_VALUES // n)
    payloads, sizes, widths = [], [], []
    for lo in range(0, F, step):
        p, s, w = _encode_pass(to_torch(frames[lo:lo + step], device), block)
        payloads.append(p)
        sizes.append(s)
        widths.append(w)
    sizes = np.concatenate(sizes)
    offsets = np.zeros(F + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return Streams(np.concatenate(payloads), offsets,
                   np.concatenate(widths), n, block)


def encode(frames: np.ndarray, block: int, dimensions=(),
           device="cpu") -> Archive:
    """The archive of (F, n) unsigned ``frames``."""
    return encode_streams(frames, block, device).archive(
        np.arange(len(frames)), dimensions)


def sidecar_bytes(archive: Archive) -> bytes:
    """The v2 ``.trpx.idx`` sidecar (FORMAT.md section 6): magic, frame
    count, payload size, blocks a frame, the offsets and the width table,
    all little-endian, then the CRC32 of all that, which the readers of
    the repo's ``.idx`` files require."""
    offs = np.ascontiguousarray(archive.frame_index, "<u8")
    wt = np.ascontiguousarray(archive.widths, np.uint8)
    blob = (b"TRPXIDX2"
            + struct.pack("<QQQ", len(offs), archive.meta.memory_size,
                          wt.shape[1])
            + offs.tobytes() + wt.tobytes())
    return blob + struct.pack("<I", zlib.crc32(blob))


# ----------------------------------------------------------------- decode ---


def _field(bits: np.ndarray, pos: int, width: int) -> int:
    return int(bits[pos:pos + width].astype(np.int64)
               @ (1 << np.arange(width, dtype=np.int64)))


def decode(payload: bytes, frames: int, n: int, block: int,
           dtype) -> np.ndarray:
    """(frames, n) values of an unsigned stream, walked block by block
    (FORMAT.md section 4). Fields wider than ``dtype`` clamp to its
    largest value. Slow: for small archives."""
    dtype = np.dtype(dtype)
    top = np.iinfo(dtype).max
    bits = np.unpackbits(np.frombuffer(payload, np.uint8), bitorder="little")
    out = np.zeros((frames, n), dtype)
    start = 0
    for f in range(frames):
        pos, prev = start, 0
        for lo in range(0, n, block):
            cnt = min(block, n - lo)
            if bits[pos]:
                w = prev
                pos += 1
            else:
                w = _field(bits, pos + 1, 3)
                pos += 4
                if w == 7:
                    w += _field(bits, pos, 2)
                    pos += 2
                    if w == 10:
                        w += _field(bits, pos, 6)
                        pos += 6
                prev = w
            if w:
                f_bits = bits[pos:pos + w * cnt].reshape(cnt, w).astype(np.uint64)
                vals = f_bits @ (np.uint64(1) << np.arange(w, dtype=np.uint64))
                out[f, lo:lo + cnt] = np.minimum(vals, top)
                pos += w * cnt
        start += 8 * (1 + (pos - start) // 8)
    return out
