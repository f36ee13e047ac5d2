"""Device path of the PyTorch port: TRPX encode/decode of frame batches.

The counterpart of ``trpx_tpu/ops/coding.py``. Encode pads a batch to the
block grid, runs the pack kernel on the requested device and assembles a
byte-exact ``.trpx`` archive on the host. Decode walks the archive's block
headers on the host (the native walker, serial by nature), then runs the
unpack kernel. Where the JAX package routes by ``pallas_ok`` and
``pallas_ok_decode``, this one routes by what an H100 measured
(``route_sweep``): an encode of fewer than ``TILED_PACK_MAX_FRAMES``
frames of at least ``TILED_MIN_BLOCKS`` blocks each takes the tiled pack
(``cuda_pack.encode_batch_tiled``), as do blocks too large for the
one-pass kernel's shared memory, which the tiled pack has no limit on
(``FrameSpec.tiled_pack``), any other the one-pass pack
(``encode_batch``); a decode of fewer than ``TILED_MAX_FRAMES`` frames
takes the tiled unpack (``cuda_unpack.decode_batch_tiled``), as do blocks
the one-pass unpack cannot tile (``FrameSpec.tiled``), any other the
one-pass unpack (``decode_batch``). Each kernel wrapper launches the CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors.

Each layer of ``encode`` and ``decode`` runs in a ``record_function``
range (``trpx.encode.pad``, ``.h2d``, ``.kernel``, ``.d2h``, ``.assemble``;
``trpx.decode.walk``, ``.h2d``, ``.kernel``, ``.d2h``, ``.narrow``), so a
``torch.profiler`` window over ``compress``/``decompress`` times the path
by layer. The kernel ranges time the launches only: the D2H ranges wait
for the kernels, whose device time the profiler reports on its own.

Both are a dispatch half and a collect half (``encode_dispatch`` /
``encode_collect``, ``decode_dispatch`` / ``decode_collect``): dispatch
copies the inputs to the device, launches the kernel on the current
stream and starts the copies back; collect waits for them and does the
host work. ``encode`` and ``decode`` run one after the other; the stream
(``runtime.stream``) dispatches chunk k on a side CUDA stream before it
collects chunk k-1.

The format, the archive object and the host walker are the port's own
``format`` and ``native`` packages, copies of the JAX package's that
``tests/test_torch_format.py`` holds to the same bytes. What the JAX
package sizes for TPU memory (capacity schedules, merge-tree rows, staging
widths) has no counterpart here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..format import pycodec
from ..format.header import TrpxMeta
from ..format.pycodec import TrpxArchive, walk_frame
from ..format.spec import DEFAULT_BLOCK, frame_nbytes
from ..native import codec as ncodec
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


def _pad_batch(frames: np.ndarray, spec: FrameSpec) -> np.ndarray:
    """Zero-pad each frame to the block grid (n_padded values)."""
    if frames.shape[1] == spec.n_padded:
        return np.ascontiguousarray(frames)
    out = np.zeros((frames.shape[0], spec.n_padded), dtype=frames.dtype)
    out[:, : spec.n] = frames
    return out


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
    with record_function("trpx.encode.pad"):
        padded = _pad_batch(frames, spec)
    with record_function("trpx.encode.h2d"):
        x = torch.from_numpy(padded).to(device)
    del padded
    words, bits, maxw = encode_collect(encode_dispatch(spec, x))
    with record_function("trpx.encode.assemble"):
        return assemble_archive(spec, words, bits, maxw, dimensions)


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """Start copying a device tensor to the host (into pinned memory when
    ``pin``); a CPU tensor is returned as it is."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return out.copy_(t, non_blocking=True)


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
    ``spec.tiled_pack(F)``, else ``encode_batch``) and start copying the frame
    bit counts and widths back (into pinned memory when ``pin``). Returns
    without waiting for the device."""
    with record_function("trpx.encode.kernel"):
        words, bits, maxw = pack_kernel(spec, len(x))(spec, x)
    with record_function("trpx.encode.d2h"):
        host = (_host_copy(bits, pin), _host_copy(maxw, pin))
        return _in_flight(words, host, pin, x.device)


def encode_collect(p: InFlight):
    """Wait for an :func:`encode_dispatch` and copy the words that hold
    some frame's bytes to the host: (words (F, W) uint32, bits, maxw)
    numpy arrays. The words' copy runs on the dispatch's stream, which
    owns them."""
    with record_function("trpx.encode.d2h"):
        p.wait()
        bits, maxw = (t.numpy() for t in p.host)
        used = -(-frame_nbytes(int(bits.max())) // 4)
        with _on(p.stream):
            words = _host_copy(p.out[:, :used], p.pin)
            if p.stream is not None:
                p.stream.synchronize()
        return words.numpy().view(np.uint32), bits, maxw


def assemble_archive(
    spec: FrameSpec,
    words: np.ndarray,
    bits: np.ndarray,
    maxw: np.ndarray,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Concatenate per-frame word buffers into the final byte stream
    (frames are byte-aligned with a terminal byte each — Terse.hpp:547)."""
    F = words.shape[0]
    nbytes = [frame_nbytes(int(b)) for b in bits]
    total = int(np.sum(nbytes))
    payload = np.zeros(total, dtype=np.uint8)
    pos = 0
    byte_view = np.ascontiguousarray(words).view(np.uint8).reshape(F, -1)
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
    # the encoder knows every frame's offset: later decodes walk frames in
    # parallel, and a .trpx.idx sidecar can be written without a walk
    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(nbytes[:-1], out=offsets[1:])
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


def walk_archive(archive: TrpxArchive, spec: FrameSpec):
    """Serial decode prepass for a whole archive: per-block width tables
    and per-frame uint32 word buffers.

    Uses the native C++ walker when available, else the pure-Python walk.
    A sidecar width table that passes :func:`validate_tables` skips the
    walk. Returns (widths (F, nb) int32, words (F, W) uint32), where every
    row keeps at least two zero words after its stream: the unpack reads
    the word after each field's first word. The walk is cached on the
    archive (``width_table``, ``frame_index``), so a repeat decode of the
    same object is walk-free.
    """
    meta = archive.meta
    F, nb = meta.number_of_frames, spec.nb
    payload = archive.payload
    widths = np.empty((F, nb), dtype=np.int32)
    have_native = native.available()
    if have_native:
        # the padded copy of the payload (bit-reader slack) is a full
        # memcpy: cache it on the archive across walks
        buf = getattr(archive, "_padded_buf", None)
        if buf is None:
            buf = native.padded_buffer(payload)
            archive._padded_buf = buf
    wtab = getattr(archive, "width_table", None)
    fidx0 = getattr(archive, "frame_index", None)
    if wtab is not None and fidx0 is not None and wtab.shape == (F, nb):
        starts = np.asarray(fidx0, dtype=np.int64)
        ends = np.concatenate([starts[1:], [meta.memory_size]])
        try:
            validate_tables(spec, meta, wtab, starts, ends)
        except ValueError:
            # distrust both tables and walk the stream instead
            wtab = fidx0 = None
    else:
        wtab = None
    if wtab is not None:
        widths[:] = wtab
    elif have_native and fidx0 is not None:
        starts = np.asarray(fidx0, dtype=np.int64)
        native.walk_indexed(buf, starts, meta.number_of_values, meta.block,
                            want_poffs=False, out_widths=widths,
                            max_width=meta.prolix_bits)
        ends = np.concatenate([starts[1:], [meta.memory_size]])
    elif have_native:
        _w, _o, fstarts = native.walk(buf, F, meta.number_of_values,
                                      meta.block, want_poffs=False,
                                      out_widths=widths,
                                      max_width=meta.prolix_bits)
        starts, ends = fstarts[:-1], fstarts[1:]
    else:
        starts = np.zeros(F, dtype=np.int64)
        ends = np.zeros(F, dtype=np.int64)
        pos = 0
        for f in range(F):
            w, _o, nxt = walk_frame(payload, pos, meta.number_of_values,
                                    meta.block)
            widths[f] = w
            starts[f], ends[f] = pos, nxt
            pos = nxt
        if F and int(widths.max()) > meta.prolix_bits:
            raise ValueError(
                f"corrupt TRPX payload: block width {int(widths.max())}"
                f" exceeds the header's prolix_bits={meta.prolix_bits}")
    if wtab is None:
        # every branch above proved widths <= prolix_bits
        archive.width_table = widths.astype(np.uint8)
        archive.frame_index = np.asarray(starts, dtype=np.int64)
    max_bytes = int(np.max(ends - starts)) if F else 1
    cap_words = -(-(max_bytes + 8) // 4)
    if have_native:
        # the C gather copies each frame and zeroes the rest of its row
        words = np.empty((F, cap_words), dtype=np.uint32)
        byte_view = words.view(np.uint8)
        native.gather_frames(buf, starts, ends, byte_view)
    else:
        words = np.zeros((F, cap_words), dtype=np.uint32)
        byte_view = words.view(np.uint8)
        raw = np.frombuffer(payload, dtype=np.uint8)
        for f in range(F):
            chunk = raw[starts[f] : ends[f]]
            byte_view[f, : len(chunk)] = chunk
    return widths, words


def decode(archive: TrpxArchive, dtype, *, device) -> np.ndarray:
    """Host header walk + unpack on ``device``. Returns (F, n) of
    ``dtype``."""
    dtype = np.dtype(dtype)
    meta = archive.meta
    spec = FrameSpec.for_dtype(meta.number_of_values, dtype, meta.block)
    if meta.prolix_bits > spec.max_width:
        # stream fields wider than the target's lanes: the host codec
        # implements the reference's clamp semantics at C speed
        if native.available():
            return ncodec.decode(archive, dtype)
        return pycodec.decode(archive, dtype)
    with record_function("trpx.decode.walk"):
        widths, words = walk_archive(archive, spec)
        widths = widths.astype(np.uint8)
    p = decode_dispatch(spec, torch.from_numpy(words.view(np.int32)),
                        torch.from_numpy(widths), torch.device(device))
    return decode_collect(p, dtype)


def decode_dispatch(spec: FrameSpec, words: torch.Tensor,
                    widths: torch.Tensor, device: torch.device,
                    fetch: bool = True, pin: bool = False) -> InFlight:
    """Copy host ``words`` (F, W) int32 and ``widths`` (F, nb) uint8 to
    ``device`` and launch the unpack kernel there on the current stream
    (``decode_batch_tiled`` when ``spec.tiled(F)``, else
    ``decode_batch``); with ``fetch``, start copying the (F, n) output
    back (into pinned memory when ``pin``). Returns without waiting for
    the device. From pinned host tensors the input copies are
    asynchronous too."""
    with record_function("trpx.decode.h2d"):
        x = words.to(device, non_blocking=True)
        w = widths.to(device, non_blocking=True)
    with record_function("trpx.decode.kernel"):
        out = unpack_kernel(spec, len(x))(spec, x, w, decoded_dtype(spec))
    with record_function("trpx.decode.d2h"):
        host = (_host_copy(out, pin),) if fetch else ()
        return _in_flight(out, host, pin, device)


def decode_collect(p: InFlight, dtype) -> np.ndarray:
    """Wait for a :func:`decode_dispatch` with ``fetch`` and narrow its
    output on the host: (F, n) of ``dtype``. The result may share memory
    with the dispatch's host buffer, which nothing else reuses while the
    result lives."""
    with record_function("trpx.decode.d2h"):
        p.wait()
        out = p.host[0].numpy()
    with record_function("trpx.decode.narrow"):
        return narrow_values(out, dtype)
