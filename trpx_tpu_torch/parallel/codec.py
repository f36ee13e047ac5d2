"""Frame-parallel TRPX codec over several devices and processes: the
counterpart of ``trpx_tpu/parallel/codec.py``.

Frames are the codec's data-parallel axis: each frame encodes alone, and
the only state shared across frames is the running ``prolix_bits`` max, an
associative reduction. So:

* a process splits its frames contiguously over its local devices (a list
  of torch devices; shards may be uneven) and dispatches every shard
  before it collects any. A shard goes to its device in chunks through
  two bounded host buffers of its own (``ops.staging``: pinned for a CUDA
  device, zeroed when allocated, so the columns past ``n`` are the pad,
  and kept on the codec across calls), without blocking the host; it is
  packed on the device's current stream, and its bit counts and widths
  start back into pinned memory, so the host returns from a dispatch
  while the device still works and stages the next shard meanwhile. The
  collect waits for each shard's tables, then starts every shard's words
  back into its rows of one pinned array, then waits for them all.
  Decode stages each shard's words and widths alike, dispatches every
  shard, and brings their pixels back together through bounded pinned
  buffers into one pageable array for the caller. CPU devices run the
  kernels' plain versions, which have finished when their dispatch
  returns, through plain (unpinned) buffers;
* across processes the only collective is the per-frame size table: a
  ``torch.distributed`` all-gather over **gloo** of host int64 tensors
  (the table is a host table anyway, and NCCL cannot put two ranks on one
  card), and an all-reduce (MAX) of the widest field. From the gathered
  table every process derives each frame's absolute byte offset with one
  exclusive int64 cumsum, so each writes its frames into the shared file
  on its own (``parallel/distributed.py``);
* decode is the host's serial header walk, then the unpack of each local
  device's frame shard.

Each host step runs in a span (``runtime.metrics.span``): the uploads
in ``trpx.stage.upload``, the collect in ``trpx.encode.d2h``, the
assembly in ``trpx.encode.assemble``, the walk in ``trpx.decode.walk``,
the pixels' way back in ``trpx.stage.fetch`` and their narrowing in
``trpx.decode.narrow``, as on one card.

Without an initialized process group the world is this process. What the
JAX package sizes for TPU memory or lane layout (measured capacity
schedules, the overflow re-encode, mesh padding of the frame count, the
``(F, S, 128)`` grid flatten, pair-packed u32 bitcasts) has no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import api as _api
from ..format.pycodec import TrpxArchive
from ..format.spec import DEFAULT_BLOCK, frame_nbytes
from ..ops import coding
from ..ops import staging
from ..ops.coding import FrameSpec, walk_archive
from ..ops.cuda_unpack import decoded_dtype
from ..runtime.metrics import span


def default_devices() -> list[torch.device]:
    """This process's cards: every visible CUDA device. Raises
    RuntimeError on a machine without one (it never falls to the CPU). A
    run that gives each process its own card sets ``CUDA_VISIBLE_DEVICES``
    per process."""
    _api._torch_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _world(group=None) -> tuple[int, int]:
    """(rank, world size) in `group`, or (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _split(F: int, k: int) -> list[tuple[int, int]]:
    """Contiguous (lo, hi) ranges of `F` frames over `k` devices, the
    first ``F % k`` one frame longer; empty ranges dropped."""
    q, r = divmod(F, k)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(k)])
    return [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])
            if hi > lo]


def _offsets_from_sizes(nbytes: np.ndarray) -> tuple[np.ndarray, int]:
    """Exclusive int64 cumsum of the per-frame byte sizes -> (offsets,
    total). Host-side, so archives over 2 GiB cannot wrap."""
    nbytes = np.asarray(nbytes, dtype=np.int64)
    offsets = np.zeros_like(nbytes)
    np.cumsum(nbytes[:-1], out=offsets[1:])
    total = int(offsets[-1] + nbytes[-1]) if nbytes.size else 0
    return offsets, total


class ShardedCodec:
    """Sharded encode/decode of one frame geometry over ``devices`` (torch
    devices or their names; None: :func:`default_devices`) and, across
    processes, the ``torch.distributed`` process group ``group`` (None:
    the default group, or this process alone without one)."""

    def __init__(self, spec: FrameSpec, devices=None, group=None) -> None:
        self.spec = spec
        if devices is None:
            devices = default_devices()
        self.devices = [_api._torch_device(d) for d in devices]
        if not self.devices or any(d is None for d in self.devices):
            raise ValueError("ShardedCodec needs one or more torch devices")
        self.group = group
        self._staging = staging.Staging()

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def _dispatch_local(self, frames: np.ndarray) -> list:
        """Stage, upload and pack each shard of this process's (F, n)
        frames on its device, and start its tables back, without waiting
        for any device -> [(lo, hi, InFlight)] in frame order."""
        F, n = frames.shape
        if n != self.spec.n:
            raise ValueError(f"frames have {n} values, spec says {self.spec.n}")
        want = self.spec.torch_dtype
        if torch.from_numpy(np.empty(0, frames.dtype)).dtype != want:
            raise TypeError(f"frames must be {want} for {self.spec}, got "
                            f"{frames.dtype}")
        flights = []
        for i, ((lo, hi), dev) in enumerate(zip(_split(F, self.ndev),
                                                self.devices)):
            x = staging.upload(self._staging, ("frames", i), frames[lo:hi],
                               self.spec.n_padded, want, dev)
            flights.append((lo, hi, coding.encode_dispatch(
                self.spec, x, pin=dev.type == "cuda")))
        return flights

    def _collect_local(self, flights: list):
        """Gather :meth:`_dispatch_local`'s shards -> (words (F, W)
        uint32, bits (F,) int64, maxw (F,) int64). Waits for every shard's
        tables (each lands right after its kernel, while the other cards'
        kernels run on), which give W, the words that hold some frame's
        bytes; then starts every shard's words into its rows of one new
        array (pinned if a device is a CUDA one), then waits for them all.
        Only each frame's first ``frame_nbytes(bits)`` bytes of words are
        defined. Runs in the span ``trpx.encode.d2h``, which counts pageable
        words as fresh bytes."""
        with span("trpx.encode.d2h") as s:
            F = flights[-1][1] if flights else 0
            bits = np.zeros(F, np.int64)
            maxw = np.zeros(F, np.int64)
            for lo, hi, p in flights:
                p.wait()
                bits[lo:hi], maxw[lo:hi] = (t.numpy() for t in p.host)
            W = -(-frame_nbytes(int(bits.max())) // 4) if F else 0
            pin = any(d.type == "cuda" for d in self.devices)
            words = torch.empty((F, W), dtype=torch.int32, pin_memory=pin)
            if not pin:
                s.fresh(words.nbytes)
            for lo, hi, p in flights:
                with coding._on(p.stream):
                    words[lo:hi].copy_(p.out[:, :W], non_blocking=True)
            for _, _, p in flights:
                if p.stream is not None:
                    p.stream.synchronize()
            return words.numpy().view(np.uint32), bits, maxw

    def _encode_local(self, frames: np.ndarray):
        """Pack this process's (F, n) frames, split over its devices ->
        (words (F, W) uint32, bits (F,) int64, maxw (F,) int64): every
        shard dispatched, then every shard collected."""
        return self._collect_local(self._dispatch_local(np.asarray(frames)))

    def encode(
        self, frames: np.ndarray, dimensions: tuple[int, ...] = ()
    ) -> TrpxArchive:
        """Encode this process's (F, n) frames over its devices into a
        byte-exact archive (no collective): the shards' frame streams
        concatenated in frame order (``ops.coding.assemble_archive``)."""
        words, bits, maxw = self._encode_local(np.asarray(frames))
        return coding.assemble_archive(self.spec, words, bits, maxw,
                                       dimensions)

    def encode_shards(self, frames_local: np.ndarray, n_frames: int):
        """Multi-process encode step: each process feeds its LOCAL frames,
        a contiguous slice in global frame order (local frame counts may
        differ between processes), and gets back its local words plus the
        replicated global size/offset tables (see
        ``parallel/distributed.py`` for the file-writing side).

        Collective over the group: every process must call it. The local
        frame counts are gathered first, then the per-frame byte counts,
        each row padded to the largest count (gloo's all-gather takes
        equal sizes); ``all_gather_object`` would pickle the same tables
        through byte tensors and lose the int64 dtype. Raises ValueError
        (in every process) if the counts do not sum to `n_frames`.
        """
        import torch.distributed as dist

        from .distributed import ShardResult

        frames_local = np.asarray(frames_local)
        F_local = frames_local.shape[0]
        words, bits, maxw = self._encode_local(frames_local)
        nbytes_local = 1 + bits // 8
        prolix = int(maxw.max()) if F_local else 0
        rank, world = _world(self.group)
        if world == 1:
            counts = [F_local]
            nbytes = nbytes_local
        else:
            mine = torch.tensor([F_local], dtype=torch.int64)
            got = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(got, mine, group=self.group)
            counts = [int(t.item()) for t in got]
            row = torch.zeros(max(counts), dtype=torch.int64)
            row[:F_local] = torch.from_numpy(nbytes_local)
            rows = [torch.empty_like(row) for _ in range(world)]
            dist.all_gather(rows, row, group=self.group)
            nbytes = np.concatenate(
                [r[:c].numpy() for r, c in zip(rows, counts)])
            top = torch.tensor([prolix], dtype=torch.int64)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=self.group)
            prolix = int(top.item())
        if sum(counts) != n_frames:
            raise ValueError(
                f"n_frames={n_frames} inconsistent with the local frame "
                f"counts {counts} of {world} processes")
        frame_lo = int(sum(counts[:rank]))
        offsets, total = _offsets_from_sizes(nbytes)
        return ShardResult(
            frame_lo=frame_lo,
            frame_hi=frame_lo + F_local,
            words=words,
            nbytes=np.asarray(nbytes, dtype=np.int64),
            offsets=offsets,
            total_bytes=total,
            prolix_bits=prolix,
        )

    # ------------------------------------------------------------ decode ---

    def decode(self, archive: TrpxArchive, dtype) -> np.ndarray:
        """Host header walk, then the unpack of each local device's frame
        shard -> (F, n) array of ``dtype``, narrowed as ``ops.decode``
        narrows (a stream wider than the target takes the host codec's
        clamp, as there). Every shard's words and widths are staged,
        uploaded and unpacked before any pixel is fetched; the pixels then
        come back together (``ops.staging.fetch``) into one pageable
        array."""
        dtype = np.dtype(dtype)
        meta = archive.meta
        if meta.prolix_bits > self.spec.max_width:
            return coding.decode(archive, dtype, device=self.devices[0])
        widths, words = walk_archive(archive, self.spec)
        W = words.shape[1]
        F = meta.number_of_frames
        parts = []
        for i, ((lo, hi), dev) in enumerate(zip(_split(F, self.ndev),
                                                self.devices)):
            wo = staging.upload(self._staging, ("words", i),
                                words[lo:hi].view(np.int32), W, torch.int32,
                                dev)
            wd = staging.upload(self._staging, ("widths", i), widths[lo:hi],
                                self.spec.nb, torch.uint8, dev)
            p = coding.decode_dispatch(self.spec, wo, wd, dev, fetch=False)
            parts.append((("pixels", i), lo, p.out))
        host = torch.empty((F, self.spec.n), dtype=decoded_dtype(self.spec))
        staging.fetch(self._staging, parts, host)
        return coding.narrow(host.numpy(), dtype)


def encode_sharded(
    frames: np.ndarray,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
    devices=None,
) -> TrpxArchive:
    """One-shot sharded encode of (F, n) or (F, h, w) frames over
    ``devices`` (None: :func:`default_devices`)."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        if not dimensions:
            dimensions = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    spec = FrameSpec.for_dtype(frames.shape[1], frames.dtype, block)
    return ShardedCodec(spec, devices).encode(frames, dimensions)


def decode_sharded(archive: TrpxArchive, dtype, devices=None) -> np.ndarray:
    """One-shot sharded decode -> (F, n) over ``devices`` (None:
    :func:`default_devices`)."""
    meta = archive.meta
    spec = FrameSpec.for_dtype(meta.number_of_values, np.dtype(dtype),
                               meta.block)
    return ShardedCodec(spec, devices).decode(archive, dtype)

