"""Streaming encode of long movie stacks, with resume, and pipelined
chunked decode: the counterpart of ``trpx_tpu/runtime/stream.py``.

``StreamingEncoder`` encodes fixed-size chunks of frames, appends their
bytes to a ``.part`` file and their frame offsets to ``.part.idx``, and
checkpoints a JSON manifest after each chunk, so a run resumes at chunk
granularity. The on-disk state is the JAX package's, field for field, so a
run begun by either package resumes in the other. ``finalize`` writes
``header + payload`` to the real path, validates it with one indexed walk
(optional, and shared with the ``.trpx.idx`` sidecar), and only then
removes the temporaries.

On a CUDA device both directions overlap the host with the card, as the
JAX package does by asynchronous dispatch: each chunk goes through one of
two pinned staging buffers (the copy into it zeroes the pad to the block
grid), its copy to the card and its kernel run on a side CUDA stream,
and events say when a buffer may be reused and when results have
landed. ``add_frames`` dispatches chunk k before it writes chunk k-1;
``iter_decode`` walks and dispatches chunk k+1 before it yields chunk k.

Not ported, because they size TPU memory or bound XLA recompiles: the
capacity modes and the overflow re-encode (the CUDA pack is exact at
worst-case size), the pow2 word-capacity buckets, the zero-padding of the
last chunk to the chunk size, the joined schedules and ``tile_prepass``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import api as _api
from .. import native
from ..format.header import TrpxMeta, emit_header
from ..format.spec import DEFAULT_BLOCK, frame_nbytes
from ..io.trpx import write_index
from ..ops.coding import (
    FrameSpec,
    _on,
    decode_collect,
    decode_dispatch,
    encode_collect,
    encode_dispatch,
    kernel_decodes,
    walk_chunks,
)
from ..ops.staging import Staging
from .metrics import span


@dataclass
class _Manifest:
    dtype: str
    nvalues: int
    block: int
    signed: bool
    dimensions: list
    frames_done: int
    payload_bytes: int
    prolix_bits: int

    @classmethod
    def load(cls, path: Path) -> "_Manifest":
        return cls(**json.loads(path.read_text()))

    def save(self, path: Path) -> None:
        # x.trpx.manifest -> x.trpx.tmp, the name finalize also writes;
        # the two writes never overlap (finalize saves no manifest)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.__dict__))
        os.replace(tmp, path)


class StreamingEncoder:
    """Chunked encode -> append-only payload file + manifest.

    Usage::

        enc = StreamingEncoder("movie.trpx", nvalues=512*512,
                               dtype=np.uint16, dimensions=(512, 512))
        for chunk in chunks:          # (F_chunk, nvalues) arrays
            enc.add_frames(chunk)
        enc.finalize()

    If the process dies, an encoder made on the same path resumes after
    the last checkpointed chunk (``frames_done`` says where the caller's
    input restarts).

    ``backend="device"`` encodes on the torch ``device``, resolved as
    ``api.compress`` resolves it: None (the default) and True mean the
    card and raise RuntimeError without one, a torch device or its name
    runs there (``"cpu"``: the kernels' plain versions); ``device=False``
    is the host codec, which ``backend="host"`` selects. ``backend="host"``
    encodes with the native C++ codec and any integer dtype.
    """

    def __init__(
        self,
        path,
        nvalues: int,
        dtype,
        block: int = DEFAULT_BLOCK,
        dimensions: tuple[int, ...] = (),
        sync_every_chunk: bool = True,
        backend: str = "device",
        device=None,
    ) -> None:
        if backend not in ("device", "host"):
            raise ValueError(f"backend must be 'device' or 'host', got {backend!r}")
        self.backend = backend
        self.path = Path(path)
        self.part = self.path.with_name(self.path.name + ".part")
        self.part_idx = self.path.with_name(self.path.name + ".part.idx")
        self.manifest_path = self.path.with_name(self.path.name + ".manifest")
        self.dtype = np.dtype(dtype)
        self.nvalues = nvalues
        self.block = block
        self.sync_every_chunk = sync_every_chunk
        self.spec = self.device = self._stream = None
        if backend == "device":
            self.spec = FrameSpec.for_dtype(nvalues, self.dtype, block)
            self.device = _api._torch_device(device)
            if self.device is None:
                raise ValueError("device=False is the host codec: pass "
                                 "backend='host'")
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
        #: two staging buffers, turns 0 and 1 (pinned on CUDA)
        self._staging = Staging()
        self._turn = 0
        self._pending = None
        if self.manifest_path.exists():
            m = _Manifest.load(self.manifest_path)
            if (m.dtype, m.nvalues, m.block) != (self.dtype.str, nvalues,
                                                 block):
                raise ValueError(
                    "existing manifest does not match this configuration"
                )
            self.m = m
            # the .part files must still hold the checkpointed bytes: 'ab'
            # would recreate a deleted file and truncate() zero-extend it,
            # and an all-zero prefix walks as valid width-0 headers
            for p, need in ((self.part, m.payload_bytes),
                            (self.part_idx, 8 * m.frames_done)):
                have = p.stat().st_size if p.exists() else -1
                if have < need:
                    raise FileNotFoundError(
                        f"manifest checkpoints {need} bytes but {p} "
                        f"{'is missing' if have < 0 else f'holds {have}'}; "
                        "remove the manifest to restart from scratch"
                    )
            # truncate a torn tail back to the checkpoint
            with open(self.part, "ab") as f:
                f.truncate(m.payload_bytes)
            with open(self.part_idx, "ab") as f:
                f.truncate(8 * m.frames_done)
        else:
            self.m = _Manifest(
                dtype=self.dtype.str,
                nvalues=nvalues,
                block=block,
                signed=self.dtype.kind == "i",
                dimensions=list(dimensions),
                frames_done=0,
                payload_bytes=0,
                prolix_bits=0,
            )
            with open(self.part, "wb"):
                pass
            with open(self.part_idx, "wb"):
                pass
            self.m.save(self.manifest_path)

    @property
    def frames_done(self) -> int:
        return self.m.frames_done

    def add_frames(self, frames: np.ndarray) -> None:
        """Encode one chunk of (F, nvalues) frames and append its bytes.

        Double-buffered: the chunk is staged, copied to the device and
        packed on the side stream, and only then is the previous chunk
        collected and written, so the host's staging and writing overlap
        the device. The manifest therefore lags one chunk behind until
        :meth:`flush`/:meth:`finalize`; a crash loses at most the chunk in
        flight, which a resume from ``frames_done`` encodes again.
        """
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames.reshape(frames.shape[0], -1)
        F, n = frames.shape
        if n != self.nvalues or frames.dtype != self.dtype:
            raise ValueError("chunk shape/dtype does not match the stream")
        if F == 0:
            return
        if self.backend == "host":
            self._write_host_chunk(frames)
            return
        with span("trpx.stream.stage"):
            k, staged = self._stage(frames)
        with _on(self._stream):
            with span("trpx.stream.h2d"):
                x = staged.to(self.device, non_blocking=True)
                self._staging.used(k, self._stream)
            out = encode_dispatch(self.spec, x, pin=self._stream is not None)
        prev, self._pending = self._pending, (out, F)
        if prev is not None:
            self._write_chunk(prev)

    def _stage(self, frames: np.ndarray):
        """Copy a chunk into the next staging buffer, once the copy to the
        device that last read that buffer has completed, and zero the
        columns past ``nvalues``: the pad."""
        k, self._turn = self._turn, self._turn ^ 1
        return k, self._staging.rows(k, frames, self.spec.n_padded,
                                     self.spec.torch_dtype,
                                     pin=self._stream is not None)

    def _write_host_chunk(self, frames: np.ndarray) -> None:
        """host backend: native C++ encode of the chunk, one contiguous
        append (the spec-as-code codec where the native one did not
        build)."""
        if native.available():
            payload, fstarts, prolix = native.encode_frames(
                frames, self.block, self.dtype.kind == "i")
            sizes = np.diff(fstarts)
        else:
            from ..format import pycodec

            arch = pycodec.encode(list(frames), block=self.block)
            payload = arch.payload
            sizes = np.diff(np.append(pycodec.frame_offsets(arch),
                                      arch.meta.memory_size))
            prolix = arch.meta.prolix_bits
        offs = self.m.payload_bytes + np.concatenate(
            [[0], np.cumsum(sizes[:-1])]).astype("<u8")
        self._append(payload, offs)
        self._checkpoint(frames.shape[0], int(sizes.sum()), int(prolix))

    def flush(self) -> None:
        """Collect the chunk in flight and checkpoint it."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._write_chunk(pending)

    def _write_chunk(self, pending) -> None:
        p, F = pending
        words, bits, maxw = encode_collect(p)
        byte_view = np.ascontiguousarray(words).view(np.uint8).reshape(F, -1)
        nbytes = np.array([frame_nbytes(int(b)) for b in bits], np.int64)
        offs = (self.m.payload_bytes
                + np.concatenate([[0], np.cumsum(nbytes[:-1])])).astype("<u8")
        with span("trpx.stream.write"):
            self._append([byte_view[f, : nbytes[f]] for f in range(F)], offs)
            self._checkpoint(F, int(nbytes.sum()), int(np.max(maxw)))

    def _append(self, payload, offs: np.ndarray) -> None:
        """Write a chunk's bytes (one buffer, or one per frame) at the
        checkpointed end of ``.part`` and its frame offsets at the end of
        ``.part.idx``."""
        with open(self.part, "r+b") as f:
            f.seek(self.m.payload_bytes)
            for piece in (payload if isinstance(payload, list) else [payload]):
                f.write(piece)
            if self.sync_every_chunk:
                f.flush()
                os.fsync(f.fileno())
        with open(self.part_idx, "r+b") as f:
            f.seek(8 * self.m.frames_done)
            f.write(offs.astype("<u8").tobytes())
            if self.sync_every_chunk:
                f.flush()
                os.fsync(f.fileno())

    def _checkpoint(self, frames: int, nbytes: int, prolix: int) -> None:
        self.m.payload_bytes += nbytes
        self.m.frames_done += frames
        self.m.prolix_bits = max(self.m.prolix_bits, prolix)
        self.m.save(self.manifest_path)

    def meta(self) -> TrpxMeta:
        return TrpxMeta(
            prolix_bits=self.m.prolix_bits,
            signed=self.m.signed,
            block=self.m.block,
            memory_size=self.m.payload_bytes,
            number_of_values=self.m.nvalues,
            dimensions=tuple(self.m.dimensions),
            number_of_frames=self.m.frames_done,
        )

    def finalize(self, verify: bool = False, index: bool = False) -> Path:
        """Assemble header + payload into ``path``; ``verify`` re-walks
        every frame's headers, ``index=True`` writes the v2 ``.trpx.idx``
        sidecar; then drop the temporaries.

        ``verify`` and ``index`` share one indexed walk of the assembled
        payload (the offsets were written per chunk): it checks every
        block header against the manifest's prolix_bits and yields the
        width tables. A failure raises before the output is published.
        """
        self.flush()
        meta = self.meta()
        header = emit_header(meta)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "wb") as out, open(self.part, "rb") as part:
            out.write(header)
            while True:
                buf = part.read(1 << 22)
                if not buf:
                    break
                out.write(buf)
            out.flush()
            os.fsync(out.fileno())
        offs = widths = None
        if verify or index:
            plen = self.m.payload_bytes
            offs = np.fromfile(self.part_idx, dtype="<u8").astype(np.int64)
            if offs.shape[0] != self.m.frames_done or (offs.size and not (
                    offs[0] == 0 and (np.diff(offs) > 0).all()
                    and int(offs[-1]) < plen)):
                raise ValueError(
                    "corrupt stream state: frame offset table inconsistent "
                    "with the manifest")
            if offs.size:
                widths = self._walk_assembled(tmp, len(header), offs, meta)
        os.replace(tmp, self.path)
        if index and offs is not None:
            write_index(self.path, offs, self.m.payload_bytes, widths=widths)
        self.part.unlink(missing_ok=True)
        self.part_idx.unlink(missing_ok=True)
        self.manifest_path.unlink(missing_ok=True)
        return self.path

    def _walk_assembled(self, tmp: Path, header_len: int,
                        offs: np.ndarray, meta) -> np.ndarray:
        """Validating header walk of the assembled file -> (F, nb) u8
        width tables: the native parallel indexed walk over one padded
        copy of the payload (read straight into it), else the serial
        spec-as-code walk, which also checks each offset."""
        plen = self.m.payload_bytes
        if native.available():
            buf = np.empty(plen + native.SLACK, np.uint8)
            with open(tmp, "rb") as f:
                f.seek(header_len)
                if f.readinto(memoryview(buf)[:plen]) != plen:
                    raise ValueError("short read of the assembled payload")
            buf[plen:] = 0
            w, _ = native.walk_indexed(
                buf, offs, self.m.nvalues, self.m.block,
                want_poffs=False, max_width=meta.prolix_bits,
            )
            return w.astype(np.uint8)
        from ..format.pycodec import walk_frame

        with open(tmp, "rb") as f:
            f.seek(header_len)
            payload = f.read(plen)
        nb = -(-self.m.nvalues // self.m.block)
        widths = np.zeros((offs.shape[0], nb), np.uint8)
        pos = 0
        for k in range(offs.shape[0]):
            if pos != int(offs[k]):
                raise ValueError(
                    f"frame {k} starts at byte {pos}, offset table "
                    f"says {int(offs[k])}")
            w, _o, pos = walk_frame(payload, pos, self.m.nvalues,
                                    self.m.block)
            widths[k] = w
        if widths.size and int(widths.max()) > meta.prolix_bits:
            raise ValueError(
                f"corrupt TRPX payload: block width {int(widths.max())} "
                f"exceeds the header's prolix_bits={meta.prolix_bits}")
        return widths


def iter_decode(archive, dtype, chunk_frames: int = 256, device=None,
                fetch: bool = True):
    """Decode an archive (or a path, read with its sidecar) in chunks of
    ``chunk_frames`` frames: yields (nf, n) arrays of ``dtype``.

    ``archive``: an archive of this package, ``.trpx`` bytes, a path (read
    with its sidecar) or a file object. ``device``: as ``api.decompress``
    takes it. None and True mean ``"cuda"`` and raise without a card; a
    torch device or its name runs the pipeline there (``"cpu"`` with the
    kernels' plain versions); False decodes chunk by chunk with the native
    codec (one ``api.decompress`` per chunk), as does None for a target
    the kernels cannot hold.

    Pipelined: chunk k+1 is walked and gathered (``ops.walk_chunks``,
    into pinned memory on CUDA), copied to the device and unpacked on a
    side stream, and its copy back into pinned memory started, before
    chunk k is yielded, so the host walk overlaps the device. Each archive
    is walked once: when it had no usable tables, the walk's tables are
    left on it as ``width_table`` and ``frame_index`` when the loop ends.

    ``fetch=False`` (pipeline only; raises ValueError on the host branch)
    yields ``(out, nf)`` pairs instead: ``out`` the (nf, n) decode on the
    device, in the unpack's output type (``ops.decoded_dtype``), not
    narrowed to ``dtype``, usable on the caller's current stream. The JAX
    package pads the last chunk to ``chunk_frames`` rows; here no rows
    past ``nf`` exist, so slicing ``out[:nf]`` means the same in both.
    """
    archive = _api._as_archive(archive)
    dtype = np.dtype(dtype)
    meta = archive.meta
    F, n = meta.number_of_frames, meta.number_of_values
    C = min(chunk_frames, F)
    kernel_ok = kernel_decodes(dtype, meta.prolix_bits)
    dev = _api._route(device, kernel_ok)
    if dev is None:
        if not fetch:
            raise ValueError("fetch=False requires the device pipeline "
                             "(a torch device, or an attached card)")
        for lo in range(0, F, C):
            out = _api.decompress(archive, dtype=dtype, device=False,
                                  frames=slice(lo, min(F, lo + C)))
            yield np.asarray(out).reshape(-1, n)
        return
    spec = FrameSpec.for_dtype(n, dtype, meta.block)
    if not kernel_ok:
        raise ValueError(
            f"device decode unavailable for dtype {dtype} with "
            f"prolix_bits={meta.prolix_bits}")
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    chunks = walk_chunks(archive, spec, C, pin=stream is not None,
                         site="stream.sidecar_tables")

    def drain(pending):
        p, nf, _inputs = pending
        if fetch:
            return decode_collect(p, dtype)
        out = p.out
        if p.stream is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(p.done)
            out.record_stream(cur)
        return out, nf

    pending = None
    for nf, words, widths in chunks:
        with _on(stream):
            p = decode_dispatch(spec, words, widths, dev, fetch=fetch,
                                pin=stream is not None)
        if pending is not None:
            yield drain(pending)
        # the host inputs stay referenced until the chunk is drained, by
        # which time its copies to the device have completed
        pending = (p, nf, (words, widths))
    if pending is not None:
        yield drain(pending)
