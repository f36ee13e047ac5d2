"""Device path of the PyTorch port: TRPX encode/decode of frame batches.

The counterpart of ``trpx_tpu/ops/coding.py``. Encode uploads a batch,
zero-padded to the block grid, through the calling thread's pinned bounce
buffers (``ops.staging.upload``), runs the pack kernel on the requested
device and assembles a byte-exact ``.trpx`` archive on the host. Decode
walks the archive's block headers and gathers its frames on the host
(``walk_chunks``), then runs the unpack kernel; ``decode`` of an archive
of one frame of at least ``WALK_ON_CARD_MIN_BLOCKS`` blocks uploads the
payload as it is and walks its headers on the card instead
(``cuda_walk.walk_frame``). Where the JAX package routes by
``pallas_ok`` and ``pallas_ok_decode``, this one routes by what an H100
measured (``route_sweep``): an encode of fewer than ``TILED_PACK_MAX_FRAMES``
frames of at least ``TILED_MIN_BLOCKS`` blocks each takes the tiled pack
(``cuda_pack.encode_batch_tiled``), as do blocks too large for the
one-pass kernel's shared memory, which the tiled pack has no limit on
(``FrameSpec.tiled_pack``), any other the one-pass pack
(``encode_batch``); a decode of fewer than ``TILED_MAX_FRAMES`` frames
takes the tiled unpack (``cuda_unpack.decode_batch_tiled``), as do blocks
the one-pass unpack cannot tile (``FrameSpec.tiled``), any other the
one-pass unpack (``decode_batch``). Each kernel wrapper launches the CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors. ``encode_dispatch`` and ``decode_dispatch`` count the frames of
each launch under the wrapper that took them (``runtime.metrics.count``:
``frames.encode_batch``, ``frames.encode_batch_tiled``,
``frames.decode_batch``, ``frames.decode_batch_tiled``), so every caller
leaves a record of the route its frames took.

Each layer of ``encode`` and ``decode`` runs in a span
(``runtime.metrics.span``: ``trpx.encode.h2d``, ``.kernel``, ``.d2h``,
``.assemble``; ``trpx.stream.buffer``, ``.walk``, ``.gather``;
``trpx.decode.h2d``, ``.walk``, ``.kernel``, ``.d2h``, ``.narrow``), so a
``torch.profiler`` window over ``compress``/``decompress`` times the path
by layer, and the spans count the host bytes they write and allocate.
``assemble`` opens in :func:`assemble_archive`, the buffer, walk and
gather spans in :func:`walk_chunks`, the one host walk of every device
decode, so every caller of those gets them. The kernel spans time the
launches only: the D2H spans wait for the kernels, whose device time the
profiler reports on its own.

Both are a dispatch half and a collect half (``encode_dispatch`` /
``encode_collect``, ``decode_dispatch`` / ``decode_collect``): dispatch
copies the inputs to the device, launches the kernel on the current
stream and starts the copies back; collect waits for them and does the
host work. ``encode`` and ``decode`` run one after the other; the stream
(``runtime.stream``) dispatches chunk k on a side CUDA stream before it
collects chunk k-1. ``decode`` on a card lends its result from torch's
caching host allocator, pinned, while the results that callers hold stay
within ``staging.PINNED_RESULT_BYTES``, and counts the path each result
took (``results.pinned``, ``results.pageable``).

The format, the archive object and the host walker are the port's own
``format`` and ``native`` packages, copies of the JAX package's that
``tests/test_torch_format.py`` holds to the same bytes. What the JAX
package sizes for TPU memory (capacity schedules, merge-tree rows, staging
widths) has no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .._fallback import warn_once
from ..format import pycodec
from ..format.header import TrpxMeta
from ..format.pycodec import TrpxArchive, walk_frame
from ..format.spec import DEFAULT_BLOCK, frame_nbytes
from ..native import codec as ncodec
from ..runtime.metrics import count, span
from . import cuda_walk, staging
from .cuda_pack import (
    encode_batch,
    encode_batch_tiled,
    pack_geometry,
)
from .cuda_unpack import (
    decode_batch,
    decode_batch_tiled,
    decoded_dtype,
    unpack_geometry,
)

#: device dtypes -> (signed, widest field incl. sign bit, torch dtype)
_DEVICE_DTYPES = {
    np.dtype(np.uint8): (False, 8, torch.uint8),
    np.dtype(np.uint16): (False, 16, torch.uint16),
    np.dtype(np.uint32): (False, 32, torch.uint32),
    np.dtype(np.int8): (True, 9, torch.int8),
    np.dtype(np.int16): (True, 17, torch.int16),
    np.dtype(np.int32): (True, 33, torch.int32),
}

#: Routes, from device times per call on an H100 80GB HBM3 at 700 W
#: (route_sweep, PERF.md section 6). Decodes of fewer than
#: TILED_MAX_FRAMES frames take the tiled unpack, whose tile offsets take
#: many CTAs a frame where the one-pass unpack's take one: it won at 1-64
#: frames of every class swept (512x512 and 1024x1024 u16, 2048x2048 and
#: 4096x4096 u32 in blocks of 12, 2048x2048 i32 in blocks of 1,024; 0.0140
#: against 0.0165 ms on one 512x512 frame, 0.2597 against 0.3923 on 32 of
#: 2048x2048), tied (512x512) or won at 128, lost at 192 on the u16
#: classes (512x512: 0.0883 against 0.0856) and won there on 2048x2048,
#: and lost at 256 on all (256 x 512x512: 0.1131 against 0.1062).
#: Encodes of fewer than TILED_PACK_MAX_FRAMES frames of at least
#: TILED_MIN_BLOCKS blocks take the tiled pack, whose tiles spread a frame
#: over the card: it won at 1-3 frames of 2048x2048 and 4096x4096 u32
#: (0.0288 against 0.0433 ms on one 2048x2048 frame) and lost from 4 on;
#: on 1024x1024 u16 it won by 4% on one frame only, on 512x512 never
TILED_MAX_FRAMES = 192
TILED_PACK_MAX_FRAMES = 4
TILED_MIN_BLOCKS = -(-2048 * 2048 // DEFAULT_BLOCK)  # a 2048x2048 frame

#: Single frames of at least this many blocks walk their headers on the
#: card (:func:`decode`): at the crossover of whole decodes of one frame
#: walked on the host and on the card at 8,192-bit parts on an H100 80GB
#: HBM3 at 700 W (``tools.walk_bench --card``, two sweeps, PERF.md section
#: 6): the card won from 21,846 blocks (512x512 u16: 1.37 against 1.45
#: ms; 1024x1024 u16 1.70 against 2.10; 4362x4148 u32 6.9 against 29.5)
#: and lost at 10,923 (256x512 u16: 1.35 against 1.13) and 1,366
#: (128x128 u16: 1.55 against 0.97)
WALK_ON_CARD_MIN_BLOCKS = 1 << 14


def _fits(geometry, spec) -> bool:
    """True if a one-pass kernel can tile ``spec``'s blocks (its
    ``geometry`` does not raise)."""
    try:
        geometry(spec)
    except ValueError:
        return False
    return True


@dataclass(frozen=True)
class FrameSpec:
    """Static description of one frame's encoding problem."""

    n: int          # values per frame
    block: int      # values per block
    signed: bool
    max_width: int  # widest possible field for the dtype (incl. sign bit)

    @property
    def nb(self) -> int:
        return -(-self.n // self.block)

    @property
    def n_padded(self) -> int:
        return self.nb * self.block

    @property
    def worst_bits(self) -> int:
        return self.n_padded * self.max_width + self.nb * 12

    @property
    def n_words(self) -> int:
        # +2 pad words so decode-side reads of words[W+1] stay in bounds
        return -(-self.worst_bits // 32) + 2

    @property
    def max_block_bits(self) -> int:
        return 12 + self.block * self.max_width

    def tiled(self, frames: int) -> bool:
        """True if a decode of `frames` such frames takes the tiled
        unpack: fewer than ``TILED_MAX_FRAMES`` frames, or blocks too
        large for the one-pass unpack."""
        return frames < TILED_MAX_FRAMES or not _fits(unpack_geometry, self)

    def tiled_pack(self, frames: int) -> bool:
        """True if an encode of `frames` such frames takes the tiled pack:
        fewer than ``TILED_PACK_MAX_FRAMES`` frames of at least
        ``TILED_MIN_BLOCKS`` blocks, or blocks too large for a 32-block
        tile of the one-pass pack in shared memory (hundreds of 32-bit
        values)."""
        return ((self.nb >= TILED_MIN_BLOCKS
                 and frames < TILED_PACK_MAX_FRAMES)
                or not _fits(pack_geometry, self))

    @property
    def torch_dtype(self) -> torch.dtype:
        """Element type of the frames the pack kernel takes."""
        for signed, max_width, tdt in _DEVICE_DTYPES.values():
            if (signed, max_width) == (self.signed, self.max_width):
                return tdt
        raise ValueError(f"no device dtype for {self}")

    @classmethod
    def for_dtype(cls, n: int, dtype,
                  block: int = DEFAULT_BLOCK) -> "FrameSpec":
        dtype = np.dtype(dtype)
        if dtype not in _DEVICE_DTYPES:
            raise TypeError(
                f"device path supports (u)int8/16/32, got {dtype}; "
                "use the host codec for 64-bit data"
            )
        signed, max_width, _ = _DEVICE_DTYPES[dtype]
        spec = cls(n=n, block=block, signed=signed, max_width=max_width)
        if spec.worst_bits >= 2**31:
            raise ValueError("frame too large for 32-bit bit offsets")
        return spec


def kernel_decodes(dtype, prolix_bits: int) -> bool:
    """True if the unpack kernels can decode a stream whose fields are at
    most ``prolix_bits`` wide into ``dtype``: a device dtype whose lanes
    hold that field (``FrameSpec.max_width``)."""
    dtype = np.dtype(dtype)
    return dtype in _DEVICE_DTYPES and prolix_bits <= _DEVICE_DTYPES[dtype][1]


def pack_kernel(spec: FrameSpec, frames: int):
    """The pack wrapper an encode of `frames` such frames takes:
    ``encode_batch_tiled`` when ``spec.tiled_pack(frames)``, else
    ``encode_batch``."""
    return encode_batch_tiled if spec.tiled_pack(frames) else encode_batch


def unpack_kernel(spec: FrameSpec, frames: int):
    """The unpack wrapper a decode of `frames` such frames takes:
    ``decode_batch_tiled`` when ``spec.tiled(frames)``, else
    ``decode_batch``."""
    return decode_batch_tiled if spec.tiled(frames) else decode_batch


#: each thread's host staging: its bounce buffers (pinned for a card) and
#: side streams are kept across that thread's encodes and never shared
#: with another thread's
_local = threading.local()


def _thread_staging() -> staging.Staging:
    if not hasattr(_local, "staging"):
        _local.staging = staging.Staging()
    return _local.staging


def encode(
    frames: np.ndarray,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
    *,
    device,
) -> TrpxArchive:
    """Encode frames on ``device`` and assemble a byte-exact ``.trpx``
    archive.

    ``frames``: (n,) one frame, (F, n) a batch of flat frames, or (F, h, w)
    a stack of images (dimensions inferred). 2-D always means a batch.
    """
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[None]
    elif frames.ndim == 3:
        if not dimensions:
            dimensions = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    elif frames.ndim != 2:
        raise ValueError("frames must be 1-D, 2-D (batch) or 3-D (image stack)")
    spec = FrameSpec.for_dtype(frames.shape[1], frames.dtype, block)
    x = staging.upload(_thread_staging(), "frames", frames, spec.n_padded,
                       spec.torch_dtype, torch.device(device),
                       name="trpx.encode.h2d")
    words, bits, maxw = encode_collect(encode_dispatch(spec, x))
    return assemble_archive(spec, words, bits, maxw, dimensions)


def _host_copy(t: torch.Tensor, pin: bool,
               into: torch.Tensor | None = None) -> torch.Tensor:
    """Start copying a device tensor to the host: into the host tensor
    ``into``, else into a new one (pinned when ``pin``); a CPU tensor is
    returned as it is."""
    if t.device.type == "cpu":
        return t
    if into is None:
        into = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return into.copy_(t, non_blocking=True)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for the CPU (None)."""
    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


@dataclass
class InFlight:
    """A batch dispatched to a device and not yet collected: the kernel's
    device output (words, or decoded values), the host copies started
    from the outputs, and the event recorded after both on ``stream``
    (None for CPU tensors, whose plain versions have finished when
    dispatch returns)."""

    out: torch.Tensor
    host: tuple
    pin: bool
    stream: torch.cuda.Stream | None
    done: torch.cuda.Event | None

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()


def _in_flight(out, host, pin, device) -> InFlight:
    if device.type == "cpu":
        return InFlight(out, host, pin, None, None)
    stream = torch.cuda.current_stream(device)
    done = torch.cuda.Event()
    done.record(stream)
    return InFlight(out, host, pin, stream, done)


def encode_dispatch(spec: FrameSpec, x: torch.Tensor,
                    pin: bool = False) -> InFlight:
    """Launch the pack kernel of the padded (F, n_padded) batch ``x`` on
    the current stream of its device (``encode_batch_tiled`` when
    ``spec.tiled_pack(F)``, else ``encode_batch``), counting its F frames
    in ``frames.<wrapper>``, and start copying the frame bit counts and
    widths back (into pinned memory when ``pin``). Returns without waiting
    for the device."""
    kernel = pack_kernel(spec, len(x))
    count("frames." + kernel.__name__, len(x))
    with span("trpx.encode.kernel"):
        words, bits, maxw = kernel(spec, x)
    with span("trpx.encode.d2h"):
        host = (_host_copy(bits, pin), _host_copy(maxw, pin))
        return _in_flight(words, host, pin, x.device)


def encode_collect(p: InFlight):
    """Wait for an :func:`encode_dispatch` and copy the words that hold
    some frame's bytes to the host: (words (F, W) uint32, bits, maxw)
    numpy arrays. The words' copy runs on the dispatch's stream, which
    owns them; into pageable memory (not ``pin``), it counts as fresh
    bytes of ``trpx.encode.d2h``."""
    with span("trpx.encode.d2h") as s:
        p.wait()
        bits, maxw = (t.numpy() for t in p.host)
        used = -(-frame_nbytes(int(bits.max())) // 4)
        with _on(p.stream):
            words = _host_copy(p.out[:, :used], p.pin)
            if p.stream is not None:
                p.stream.synchronize()
        if p.out.device.type != "cpu" and not p.pin:
            s.fresh(words.nbytes)
        return words.numpy().view(np.uint32), bits, maxw


def assemble_archive(
    spec: FrameSpec,
    words: np.ndarray,
    bits: np.ndarray,
    maxw: np.ndarray,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Concatenate per-frame word buffers into the final byte stream
    (frames are byte-aligned with a terminal byte each — Terse.hpp:547),
    in the span ``trpx.encode.assemble``, which counts the payload's two
    copies: the array the frames are packed into and its ``bytes``."""
    with span("trpx.encode.assemble") as s:
        F = words.shape[0]
        nbytes = [frame_nbytes(int(b)) for b in bits]
        total = int(np.sum(nbytes))
        payload = np.zeros(total, dtype=np.uint8)
        pos = 0
        packed = np.ascontiguousarray(words)
        if packed is not words:
            # a CPU device's words are a slice of its output
            s.fresh(packed.nbytes)
            s.host(packed.nbytes)
        byte_view = packed.view(np.uint8).reshape(F, -1)
        for f in range(F):
            payload[pos : pos + nbytes[f]] = byte_view[f, : nbytes[f]]
            pos += nbytes[f]
        meta = TrpxMeta(
            prolix_bits=int(np.max(maxw)),
            signed=spec.signed,
            block=spec.block,
            memory_size=total,
            number_of_values=spec.n,
            dimensions=tuple(dimensions),
            number_of_frames=F,
        )
        # the encoder knows every frame's offset: later decodes walk frames
        # in parallel, and a .trpx.idx sidecar can be written without a walk
        offsets = np.zeros(F, dtype=np.int64)
        np.cumsum(nbytes[:-1], out=offsets[1:])
        s.fresh(2 * total)
        s.host(2 * total)
        return TrpxArchive(meta=meta, payload=payload.tobytes(),
                           frame_index=offsets)


# ---------------------------------------------------------------- decode ---


def narrow_values(vals: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Narrow decoded lanes into the target dtype with the reference's
    CLAMP semantics (Bit_pointer.hpp:747-762: fields wider than the target
    saturate at its range instead of wrapping). Values already within
    range pass through unchanged."""
    dtype = np.dtype(dtype)
    if vals.dtype == dtype:
        return vals
    if vals.dtype == np.uint16:
        return np.minimum(
            vals, np.uint16(min(65535, np.iinfo(dtype).max))
        ).astype(dtype)
    if dtype == np.int32:
        return vals
    if dtype.kind == "u":
        u = vals.view(np.uint32)
        if dtype == np.uint32:
            return u
        return np.minimum(u, np.uint32(np.iinfo(dtype).max)).astype(dtype)
    info = np.iinfo(dtype)
    return np.clip(vals, info.min, info.max).astype(dtype)


def validate_tables(spec: FrameSpec, meta, wtab: np.ndarray,
                    starts: np.ndarray, ends: np.ndarray) -> None:
    """Prove sidecar width tables against the header before trusting them
    for a walk-free decode (a CRC-valid sidecar can still be stale or
    crafted):

    - every width within the header's prolix_bits claim (Terse.hpp:516);
    - frame offsets a contiguous partition of the payload;
    - each frame's byte length exactly the one its width table implies
      (1 + total_bits // 8, Terse.hpp:547).

    Raises ValueError on any mismatch.
    """
    if wtab.shape[0] == 0:
        return
    w = np.asarray(wtab)
    if w.size and int(w.max()) > meta.prolix_bits:
        raise ValueError(
            f"sidecar width {int(w.max())} exceeds the header's "
            f"prolix_bits={meta.prolix_bits}")
    if w.dtype.kind == "i" and w.size and int(w.min()) < 0:
        raise ValueError("sidecar width table holds negative widths")
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    sizes = ends - starts
    if (int(starts[0]) != 0 or bool(np.any(sizes <= 0))
            or int(ends[-1]) != meta.memory_size
            or bool(np.any(starts[1:] != ends[:-1]))):
        raise ValueError(
            "sidecar frame offsets are not a contiguous partition of "
            "the payload")
    Tb = min(32768, 1 << max(0, int(spec.nb - 1).bit_length()))
    tile_bits, _ = native.tile_tables(np.ascontiguousarray(w, np.int32),
                                      spec.n, spec.block, Tb)
    if not np.array_equal(1 + tile_bits.sum(axis=1) // 8, sizes):
        raise ValueError(
            "sidecar width tables disagree with the frame byte ranges "
            "(stale or crafted sidecar)")


#: the walk that replaces a rejected sidecar table, by warning site
_REWALK = {"ops.sidecar_tables": "revalidating header walk",
           "stream.sidecar_tables": "revalidating chunked header walk"}


def walk_chunks(archive: TrpxArchive, spec: FrameSpec, C: int, pin: bool,
                site: str = "ops.sidecar_tables"):
    """The host half of every device decode: yields (nf, words, widths)
    host tensors for consecutive runs of at most ``C`` frames. ``words``
    (nf, W) int32 holds each frame's stream and at least two zero words
    past it (the unpack reads the word after each field's first),
    ``widths`` (nf, nb) uint8 its block widths; both pinned when ``pin``,
    else ``widths`` is a view of the archive's width table.

    The payload's padded copy (the bit reader's slack) is made once, in
    the span ``trpx.stream.buffer``, and kept on the archive. Tables that
    :func:`validate_tables` proves are sliced, not walked; a rejected one
    warns once at ``site`` and both tables are distrusted. Else each run
    is walked in the span ``trpx.stream.walk``: natively over the
    archive's frame offsets in parallel where it has them, natively from
    where the last run ended where not, by the pure-Python walk without
    the native library. The walk's int32 rows are narrowed into one
    (F, nb) uint8 table, left on the archive with the frame starts
    (``width_table``, ``frame_index``) once the last run is walked. Each
    run's frames are gathered in ``trpx.stream.gather``. Each span counts
    the host bytes it writes and allocates.
    """
    meta = archive.meta
    F, nb = meta.number_of_frames, spec.nb
    have_native = native.available()
    buf = getattr(archive, "_padded_buf", None)
    if buf is None:
        with span("trpx.stream.buffer") as s:
            buf = archive._padded_buf = native.padded_buffer(archive.payload)
            if buf is not archive.payload:
                s.fresh(buf.nbytes)
                s.host(len(archive.payload))
    plen = buf.shape[0] - native.SLACK
    table = getattr(archive, "width_table", None)
    starts = getattr(archive, "frame_index", None)
    if starts is not None:
        starts = np.asarray(starts, np.int64)
        ends = np.append(starts[1:], meta.memory_size)
    if table is not None and starts is not None and table.shape == (F, nb):
        try:
            validate_tables(spec, meta, table, starts, ends)
        except ValueError as e:
            # stale or crafted: distrust both tables and walk the stream
            warn_once(site, e, _REWALK[site])
            table = starts = None
    else:
        table = None
    walked = table is None
    indexed = walked and have_native and starts is not None
    if walked and not indexed:
        starts, ends = np.empty(F, np.int64), np.empty(F, np.int64)
    pos = 0
    for lo in range(0, F, C):
        hi = min(F, lo + C)
        with span("trpx.stream.walk") as s:
            if lo == 0 and walked:
                table = np.empty((F, nb), np.uint8)
                s.fresh(table.nbytes)
            elif lo == 0:
                # torch views writable memory only: a read-only sidecar
                # table is copied
                given, table = table, np.require(table, np.uint8, "CW")
                if table is not given:
                    s.fresh(table.nbytes)
                    s.host(table.nbytes)
            if indexed:
                rows, _ = native.walk_indexed(
                    buf, starts[lo:hi], spec.n, spec.block,
                    want_poffs=False, max_width=meta.prolix_bits)
            elif walked and have_native:
                rows, _, fst = native.walk_chunk(
                    buf, pos, hi - lo, spec.n, spec.block,
                    max_width=meta.prolix_bits)
                starts[lo:hi], ends[lo:hi] = pos + fst[:-1], pos + fst[1:]
                pos = int(ends[hi - 1])
            elif walked:
                rows = np.empty((hi - lo, nb), np.int32)
                for f in range(lo, hi):
                    rows[f - lo], _, nxt = walk_frame(
                        archive.payload, pos, spec.n, spec.block)
                    starts[f], ends[f], pos = pos, nxt, nxt
                # the native walkers' check of the widest block
                native._check_width(int(rows.max()), meta.prolix_bits)
            if walked:
                # every branch proved the rows within prolix_bits
                table[lo:hi] = rows
                s.fresh(rows.nbytes)
                s.host(rows.nbytes + rows.size)
        with span("trpx.stream.gather") as s:
            st, en = starts[lo:hi], ends[lo:hi]
            cap_words = -(-(int((en - st).max()) + 8) // 4)
            words = torch.empty((hi - lo, cap_words), dtype=torch.int32,
                                pin_memory=pin)
            byte_rows = words.numpy().view(np.uint8)
            en = np.minimum(en, plen)
            if have_native:
                native.gather_frames(buf, st, en, byte_rows)
            else:
                for row, a, b in zip(byte_rows, st, en):
                    row[: b - a] = buf[a:b]
                    row[b - a :] = 0
            widths = torch.from_numpy(table[lo:hi])
            if pin:
                widths = widths.pin_memory()
            gathered = words.nbytes + (widths.nbytes if pin else 0)
            s.host(gathered)
            if not pin:
                s.fresh(gathered)
        yield hi - lo, words, widths
    if walked:
        archive.width_table, archive.frame_index = table, starts


def walk_archive(archive: TrpxArchive, spec: FrameSpec):
    """The whole archive as one run of :func:`walk_chunks`: (widths
    (F, nb) uint8, words (F, W) uint32) numpy arrays, unpinned. The
    widths are the archive's width table itself, not a copy."""
    (_, words, widths), = walk_chunks(archive, spec,
                                      archive.meta.number_of_frames, False)
    return widths.numpy(), words.numpy().view(np.uint32)


def decode(archive: TrpxArchive, dtype, *, device) -> np.ndarray:
    """Header walk + unpack on ``device``. Returns (F, n) of ``dtype``.

    The walk is the host's (:func:`walk_chunks`, one run), or the card's
    for an archive of one frame of at least ``WALK_ON_CARD_MIN_BLOCKS``
    blocks that carries no width table (:func:`walks_on_card`).

    On a card the result may be page-locked memory, lent from torch's
    caching host allocator while the results that callers hold stay
    within ``staging.PINNED_RESULT_BYTES``: the card copies the pixels
    straight into it, and its block goes back to torch's cache when the
    result and every view of it have died. Beyond that budget, and where
    narrowing into ``dtype`` copies, the result is pageable memory."""
    dtype = np.dtype(dtype)
    meta = archive.meta
    spec = FrameSpec.for_dtype(meta.number_of_values, dtype, meta.block)
    if not kernel_decodes(dtype, meta.prolix_bits):
        # stream fields wider than the target's lanes: the host codec
        # implements the reference's clamp semantics at C speed
        if native.available():
            return ncodec.decode(archive, dtype)
        return pycodec.decode(archive, dtype)
    device = torch.device(device)
    if walks_on_card(archive, spec):
        out = _decode_walked_on_card(archive, spec, dtype, device)
        if out is not None:
            return out
    (_, words, widths), = walk_chunks(archive, spec, meta.number_of_frames,
                                      False)
    p = decode_dispatch(spec, words, widths, device, lend=True)
    return decode_collect(p, dtype)


def walks_on_card(archive: TrpxArchive, spec: FrameSpec) -> bool:
    """True if :func:`decode` walks ``archive``'s headers on the card: one
    frame, which starts at byte 0, of at least ``WALK_ON_CARD_MIN_BLOCKS``
    blocks of at most ``cuda_walk.MAX_BLOCK`` values, and no width table
    and frame index offered (tables offered are :func:`walk_chunks`' to
    prove, or to warn of and walk)."""
    table = getattr(archive, "width_table", None)
    return (archive.meta.number_of_frames == 1
            and spec.nb >= WALK_ON_CARD_MIN_BLOCKS
            and spec.block <= cuda_walk.MAX_BLOCK
            and (table is None
                 or getattr(archive, "frame_index", None) is None
                 or table.shape != (1, spec.nb)))


def _decode_walked_on_card(archive: TrpxArchive, spec: FrameSpec, dtype,
                           device: torch.device) -> np.ndarray | None:
    """:func:`decode` of a one-frame archive whose headers the card walks:
    the payload's pageable upload (``trpx.decode.h2d``), the walk's
    launches and round checks and the host's check of its outcome, which
    raises as the host walk raises (``trpx.decode.walk``), the unpack and
    the pixels' copy back (:func:`decode_dispatch`), then the widths',
    behind the pixels, into a pinned block of torch's caching host
    allocator; the archive's ``width_table`` and ``frame_index`` are left
    as :func:`walk_chunks` leaves them. Counts ``walks.card`` for a frame
    walked, ``walks.sync_rounds`` for the rounds after the speculative
    one, and ``walks.unsynced`` for a walk still unsynchronised at
    ``cuda_walk.WALK_ROUND_CAP`` rounds, which returns None for the host
    to walk the frame."""
    meta = archive.meta
    with span("trpx.decode.h2d"):
        words = cuda_walk.upload_stream(archive.payload, device)
    with span("trpx.decode.walk"):
        walk = cuda_walk.walk_frame(spec, words, meta.memory_size)
        if walk.rounds is None:
            count("walks.sync_rounds", cuda_walk.WALK_ROUND_CAP)
            count("walks.unsynced")
            return None
        count("walks.sync_rounds", walk.rounds)
        count("walks.card")
        cuda_walk.check_walk(walk, spec.nb, meta.memory_size,
                             meta.prolix_bits)
    p = decode_dispatch(spec, words[None], walk.widths, device, lend=True)
    done = None
    with span("trpx.decode.d2h") as s:
        if device.type == "cpu":
            table = walk.widths
        else:
            before = staging.pinned_total()
            table = _host_copy(walk.widths, True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            s.pinned(staging.pinned_total() - before)
    out = decode_collect(p, dtype)
    if done is not None:
        with span("trpx.decode.d2h"):
            done.synchronize()
    archive.width_table = table.numpy()
    archive.frame_index = np.zeros(1, np.int64)
    return out


def decode_dispatch(spec: FrameSpec, words: torch.Tensor,
                    widths: torch.Tensor, device: torch.device,
                    fetch: bool = True, pin: bool = False,
                    lend: bool = False) -> InFlight:
    """Copy host ``words`` (F, W) int32 and ``widths`` (F, nb) uint8 to
    ``device`` and launch the unpack kernel there on the current stream
    (``decode_batch_tiled`` when ``spec.tiled(F)``, else
    ``decode_batch``), counting its F frames in ``frames.<wrapper>``;
    with ``fetch``, start copying the (F, n) output back: into pinned
    memory when ``pin``; with ``lend`` on a card, into a pinned tensor
    lent to the caller (``staging.RESULTS``) while the results lent stay
    within ``staging.PINNED_RESULT_BYTES`` (counted in
    ``results.pinned``), else into pageable memory
    (``results.pageable``). A pinned copy counts the bytes torch had to
    pin anew for it as ``pinned_bytes.trpx.decode.d2h``, a pageable one
    its bytes as fresh. Returns without waiting for the device. From
    pinned host tensors the input copies are asynchronous too."""
    with span("trpx.decode.h2d"):
        x = words.to(device, non_blocking=True)
        w = widths.to(device, non_blocking=True)
    kernel = unpack_kernel(spec, len(x))
    count("frames." + kernel.__name__, len(x))
    with span("trpx.decode.kernel"):
        out = kernel(spec, x, w, decoded_dtype(spec))
    with span("trpx.decode.d2h") as s:
        host = ()
        if fetch and device.type == "cpu":
            host = (out,)
        elif fetch:
            before = staging.pinned_total()
            into = None
            if lend:
                into = staging.RESULTS.take(out.shape, out.dtype, True,
                                            staging.PINNED_RESULT_BYTES)
                count("results.pageable" if into is None
                      else "results.pinned")
            host = (_host_copy(out, pin, into),)
            if pin or into is not None:
                s.pinned(staging.pinned_total() - before)
            else:
                s.fresh(out.nbytes)
        return _in_flight(out, host, pin, device)


def decode_collect(p: InFlight, dtype) -> np.ndarray:
    """Wait for a :func:`decode_dispatch` with ``fetch`` and narrow its
    output on the host: (F, n) of ``dtype``. The result is a view of the
    dispatch's host buffer where the narrowing copies nothing (the same
    lanes, or int32 lanes read as uint32), and nothing reuses that
    buffer while the result or any view of it lives: a pinned one lent
    by ``staging.RESULTS`` goes back to torch's cache only then."""
    with span("trpx.decode.d2h"):
        p.wait()
        out = p.host[0].numpy()
    return narrow(out, dtype)


def narrow(vals: np.ndarray, dtype) -> np.ndarray:
    """:func:`narrow_values` in the span ``trpx.decode.narrow``, which
    counts the clamp's temporary and the new array when it copies."""
    with span("trpx.decode.narrow") as s:
        out = narrow_values(vals, dtype)
        if out is not vals and out.flags.owndata:
            s.fresh(vals.nbytes + out.nbytes)
            s.host(vals.nbytes + out.nbytes)
        return out
