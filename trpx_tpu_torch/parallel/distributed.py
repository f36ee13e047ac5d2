"""Multi-process runtime: process-group init from the environment, per-rank
shard file writing, chunked streaming across ranks and shard recovery;
the counterpart of ``trpx_tpu/parallel/distributed.py``.

N processes encode disjoint frame ranges; the per-frame size table is
all-gathered over gloo (``parallel/codec.ShardedCodec.encode_shards``),
and because every process then holds the replicated offset/total tables,
each ``pwrite``s its frames' compressed bytes into the shared output file
at their absolute offsets: no data moves between processes, and the file
is byte-identical to the single-process encoder's.

Recovery follows from statelessness: a failed rank's frame range is
re-encoded from the run manifest alone (``recover_shard``), and the
chunked ``StreamingShardEncoder`` resumes from its manifest, which is
``runtime.stream``'s, so a run begun by either package resumes in the
other.

Collectives and barriers run on the gloo process group: its timeout is
finite (``init_from_env``), and a failed barrier raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..format.header import TrpxMeta, emit_header
from ..format.pycodec import TrpxArchive
from ..ops.coding import FrameSpec
from .codec import ShardedCodec, _world

#: seconds a collective or barrier waits for a peer before it raises
#: (gloo's own default is 30 minutes)
DEFAULT_TIMEOUT_S = 120.0


def init_from_env(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize ``torch.distributed`` on the gloo backend from torch's
    environment variables ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``, with a finite timeout of `timeout_s` seconds, so that
    a dead peer raises instead of hanging. Returns True if a process group
    is initialized (now or before), False when those variables are
    absent."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return True
    keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    if not all(os.environ.get(k) for k in keys):
        return False
    dist.init_process_group(
        "gloo", init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclass
class ShardResult:
    """One process's share of a sharded encode, plus replicated tables."""

    frame_lo: int              # first global frame index owned by this rank
    frame_hi: int              # one past the last
    words: np.ndarray          # (frame_hi-frame_lo, n_words) uint32
    nbytes: np.ndarray         # (F_global,) replicated per-frame byte counts
    offsets: np.ndarray        # (F_global,) replicated absolute byte offsets
    total_bytes: int           # replicated payload size
    prolix_bits: int           # replicated width max


def meta_for(
    spec: FrameSpec,
    n_frames: int,
    total_bytes: int,
    prolix_bits: int,
    dimensions: tuple[int, ...] = (),
) -> TrpxMeta:
    return TrpxMeta(
        prolix_bits=prolix_bits,
        signed=spec.signed,
        block=spec.block,
        memory_size=total_bytes,
        number_of_values=spec.n,
        dimensions=tuple(dimensions),
        number_of_frames=n_frames,
    )


def _byte_rows(words: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words)
    return words.view(np.uint8).reshape(words.shape[0], -1)


def write_shard_file(
    path,
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
    is_coordinator: bool | None = None,
) -> None:
    """Write this rank's frames into the shared ``.trpx`` file at their
    absolute offsets (the coordinator, rank 0 by default, also writes the
    header), each frame's first ``nbytes`` bytes only.

    All ranks compute the identical header from the replicated tables, so
    the header length, and hence every payload offset, agrees everywhere.
    The file must live on a filesystem every rank sees.
    """
    total = _real_total(result, n_frames)
    meta = meta_for(spec, n_frames, total, result.prolix_bits, dimensions)
    header = emit_header(meta)
    if is_coordinator is None:
        is_coordinator = _world()[0] == 0
    size = len(header) + total
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        os.truncate(fd, size)
        if is_coordinator:
            os.pwrite(fd, header, 0)
        byte_view = _byte_rows(result.words)
        for i, f in enumerate(range(result.frame_lo,
                                    min(result.frame_hi, n_frames))):
            nb = int(result.nbytes[f])
            os.pwrite(
                fd,
                byte_view[i, :nb].tobytes(),
                len(header) + int(result.offsets[f]),
            )
        os.fsync(fd)
    finally:
        os.close(fd)


def local_archive(
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Assemble a full in-memory archive from a single-process ShardResult
    (requires the process to own all frames)."""
    if not (result.frame_lo == 0 and result.frame_hi >= n_frames):
        raise ValueError("local_archive needs every frame on this host")
    total = _real_total(result, n_frames)
    payload = np.zeros(total, dtype=np.uint8)
    byte_view = _byte_rows(result.words)
    for f in range(n_frames):
        off, nb = int(result.offsets[f]), int(result.nbytes[f])
        payload[off : off + nb] = byte_view[f, :nb]
    meta = meta_for(spec, n_frames, total, result.prolix_bits, dimensions)
    return TrpxArchive(meta=meta, payload=bytes(payload.tobytes()))


def _real_total(result: ShardResult, n_frames: int) -> int:
    """Payload size of the first `n_frames` frames."""
    return int(result.offsets[n_frames - 1] + result.nbytes[n_frames - 1])


# ------------------------------------------- streaming x distributed ---


class StreamingShardEncoder:
    """Multi-process CHUNKED encode into one shared ``.trpx``: the
    streaming layer (``runtime.stream.StreamingEncoder``: chunked append +
    manifest resume) composed with the distributed layer
    (``ShardedCodec.encode_shards``: gathered size tables + per-rank
    pwrite).

    Every process feeds its slice of each chunk to :meth:`add_chunk`
    (collective: all processes call it the same number of times; local
    frame counts may differ). The replicated size table places each
    frame's bytes at absolute offsets in the shared ``.part`` file; each
    rank pwrites only its own frames. The coordinator (rank 0 of the
    codec's group) checkpoints a manifest only AFTER a barrier confirms
    every rank's writes of the chunk are durable, and a failed barrier
    raises, so a crash at ANY point loses at most the un-checkpointed
    chunk: re-encoding it is idempotent (same bytes at the same offsets).

    Resume: reconstruct on the same path in every process and restart
    feeding from ``frames_done``. Finalize (coordinator) assembles header
    + payload and removes the temporaries.
    """

    def __init__(self, path, codec: ShardedCodec, dtype,
                 dimensions: tuple[int, ...] = (),
                 sync_every_chunk: bool = True) -> None:
        from pathlib import Path

        from ..runtime.stream import _Manifest

        self.codec = codec
        self.dtype = np.dtype(dtype)
        self.path = Path(path)
        self.part = self.path.with_name(self.path.name + ".part")
        self.part_idx = self.path.with_name(self.path.name + ".part.idx")
        self.manifest_path = self.path.with_name(self.path.name + ".manifest")
        self.sync_every_chunk = sync_every_chunk
        self.dimensions = tuple(dimensions)
        self.is_coordinator = _world(codec.group)[0] == 0
        spec = codec.spec
        if self.manifest_path.exists():
            m = _Manifest.load(self.manifest_path)
            if (m.dtype, m.nvalues, m.block) != (self.dtype.str, spec.n,
                                                 spec.block):
                raise ValueError(
                    "existing manifest does not match this configuration")
            self.m = m
            if self.is_coordinator:
                # bytes past the checkpoint are a torn tail: the pwrites
                # of the re-encoded chunk overwrite them at the same offsets
                for p, need in ((self.part, m.payload_bytes),
                                (self.part_idx, 8 * m.frames_done)):
                    if not p.exists() or p.stat().st_size < need:
                        raise FileNotFoundError(
                            f"manifest checkpoints {need} bytes but {p} is "
                            "missing/short; remove the manifest to restart")
        else:
            self.m = _Manifest(
                dtype=self.dtype.str, nvalues=spec.n, block=spec.block,
                signed=spec.signed, dimensions=list(self.dimensions),
                frames_done=0, payload_bytes=0, prolix_bits=0,
            )
            if self.is_coordinator:
                for p in (self.part, self.part_idx):
                    with open(p, "wb"):
                        pass
                self.m.save(self.manifest_path)
        self._barrier()

    def _barrier(self) -> None:
        """``torch.distributed.barrier`` of the codec's group; nothing for
        a single process. A FAILURE raises (a dead peer, or the group's
        timeout): checkpointing a chunk whose peers' writes are
        unconfirmed would let a later resume skip frames that never
        became durable."""
        if _world(self.codec.group)[1] > 1:
            import torch.distributed as dist

            dist.barrier(group=self.codec.group)

    @property
    def frames_done(self) -> int:
        return self.m.frames_done

    def add_chunk(self, frames_local: np.ndarray, n_frames_chunk: int) -> None:
        """Collective: encode one global chunk (this process contributes
        ``frames_local``, its contiguous slice in global frame order) and
        pwrite this rank's frames into the shared part file."""
        res = self.codec.encode_shards(frames_local, n_frames_chunk)
        base = self.m.payload_bytes
        total = _real_total(res, n_frames_chunk)
        byte_view = _byte_rows(res.words)
        fd = os.open(self.part, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            for i, f in enumerate(range(res.frame_lo,
                                        min(res.frame_hi, n_frames_chunk))):
                nb = int(res.nbytes[f])
                os.pwrite(fd, byte_view[i, :nb].tobytes(),
                          base + int(res.offsets[f]))
            if self.sync_every_chunk:
                os.fsync(fd)
        finally:
            os.close(fd)
        # every rank's bytes must be durable BEFORE the checkpoint claims
        # the chunk done (a crash after the barrier re-encodes nothing; a
        # crash before it re-encodes the whole chunk idempotently)
        self._barrier()
        if self.is_coordinator:
            offs = (base + res.offsets[:n_frames_chunk]).astype("<u8")
            with open(self.part_idx, "r+b") as f:
                f.seek(8 * self.m.frames_done)
                f.write(offs.tobytes())
                if self.sync_every_chunk:
                    f.flush()
                    os.fsync(f.fileno())
        self.m.frames_done += n_frames_chunk
        self.m.payload_bytes += total
        self.m.prolix_bits = max(self.m.prolix_bits, int(res.prolix_bits))
        if self.is_coordinator:
            self.m.save(self.manifest_path)
        self._barrier()

    def meta(self) -> TrpxMeta:
        return meta_for(
            self.codec.spec, self.m.frames_done, self.m.payload_bytes,
            self.m.prolix_bits, tuple(self.m.dimensions))

    def finalize(self):
        """Coordinator: assemble header + payload into ``path`` and drop
        the temporaries; other processes just barrier. Returns the path."""
        self._barrier()
        if self.is_coordinator:
            header = emit_header(self.meta())
            tmp = self.path.with_name(self.path.name + ".tmp")
            with open(tmp, "wb") as out, open(self.part, "rb") as part:
                out.write(header)
                remaining = self.m.payload_bytes
                while remaining:
                    buf = part.read(min(remaining, 1 << 24))
                    if not buf:
                        raise OSError("part file shorter than the manifest")
                    out.write(buf[:remaining])
                    remaining -= min(len(buf), remaining)
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, self.path)
            for p in (self.part, self.part_idx, self.manifest_path):
                try:
                    p.unlink()
                except OSError:
                    pass
        self._barrier()
        return self.path


# ------------------------------------------------------- elastic recovery ---


def write_run_manifest(
    path,
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
    dtype=None,
) -> None:
    """Persist the replicated size table next to the shared output file
    (the coordinator, typically) as ``<path>.runmanifest``, the JAX
    package's file byte for byte. Encode is deterministic and stateless
    per frame, so this manifest is everything a restarted rank needs to
    re-encode and re-write its shard WITHOUT any collective.

    ``dtype``: the pixel dtype of the original run, stored so recovery
    rebuilds the same FrameSpec."""
    import json

    m = {
        "nbytes": [int(v) for v in result.nbytes[:n_frames]],
        "prolix_bits": int(result.prolix_bits),
        "n_frames": int(n_frames),
        "nvalues": int(spec.n),
        "block": int(spec.block),
        "signed": bool(spec.signed),
        "max_width": int(spec.max_width),
        "dimensions": list(dimensions),
    }
    if dtype is not None:
        m["dtype"] = np.dtype(dtype).str
    mp = str(path) + ".runmanifest"
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump(m, f)
    os.replace(tmp, mp)


def recover_shard(path, frames_local: np.ndarray, frame_lo: int,
                  device=None) -> None:
    """Re-encode one failed rank's frame range on ``device`` and pwrite it
    into the shared file, using only the run manifest (no collective).

    ``device``: a torch device or its name; None and True mean the card
    and raise RuntimeError without one. Raises ValueError if the
    re-encoded per-frame sizes disagree with the manifest: the input
    frames differ from the original run."""
    import json

    with open(str(path) + ".runmanifest") as f:
        m = json.load(f)
    if "dtype" in m:
        dtype = np.dtype(m["dtype"])
    else:
        # manifests without a dtype field: rebuild it from max_width
        dtype_bits = m["max_width"] - (1 if m["signed"] else 0)
        dtype = np.dtype(
            ("i" if m["signed"] else "u") + str(max(1, dtype_bits // 8))
        )
    spec = FrameSpec.for_dtype(m["nvalues"], dtype, m["block"])
    frames_local = np.asarray(frames_local, dtype)
    F_local = frames_local.shape[0]
    words, bits, _ = ShardedCodec(spec, [device])._encode_local(frames_local)
    nbytes = 1 + bits // 8
    lo, hi = frame_lo, min(frame_lo + F_local, m["n_frames"])
    expect = np.asarray(m["nbytes"][lo:hi], np.int64)
    if not np.array_equal(nbytes[: hi - lo], expect):
        raise ValueError(
            "re-encoded shard sizes disagree with the run manifest: "
            "input frames differ from the original run"
        )
    offsets = np.zeros(m["n_frames"], np.int64)
    np.cumsum(m["nbytes"][:-1], out=offsets[1:])
    total = int(offsets[-1] + m["nbytes"][-1])
    res = ShardResult(
        frame_lo=lo, frame_hi=lo + F_local, words=words,
        nbytes=np.asarray(m["nbytes"], np.int64), offsets=offsets,
        total_bytes=total, prolix_bits=m["prolix_bits"],
    )
    write_shard_file(
        path, res, spec, m["n_frames"],
        dimensions=tuple(m["dimensions"]), is_coordinator=(lo == 0),
    )
