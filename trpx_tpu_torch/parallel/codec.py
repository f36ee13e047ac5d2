"""Frame-parallel TRPX codec over several devices and processes: the
counterpart of ``trpx_tpu/parallel/codec.py``.

Frames are the codec's data-parallel axis: each frame encodes alone, and
the only state shared across frames is the running ``prolix_bits`` max, an
associative reduction. So:

* a process splits its frames contiguously over its local devices (a list
  of torch devices; shards may be uneven) and dispatches every shard's
  pack kernel on its device's current stream before it collects any, so
  several local cards overlap;
* across processes the only collective is the per-frame size table: a
  ``torch.distributed`` all-gather over **gloo** of host int64 tensors
  (the table is a host table anyway, and NCCL cannot put two ranks on one
  card), and an all-reduce (MAX) of the widest field. From the gathered
  table every process derives each frame's absolute byte offset with one
  exclusive int64 cumsum, so each writes its frames into the shared file
  on its own (``parallel/distributed.py``);
* decode is the host's serial header walk, then the unpack of each local
  device's frame shard.

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
from ..format.spec import DEFAULT_BLOCK
from ..ops import coding
from ..ops.coding import FrameSpec, walk_archive


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

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def _encode_local(self, frames: np.ndarray):
        """Pack this process's (F, n) frames, split over its devices ->
        (words (F, W) uint32, bits (F,) int64, maxw (F,) int64). Only each
        frame's first ``frame_nbytes(bits)`` bytes of words are defined."""
        F, n = frames.shape
        if n != self.spec.n:
            raise ValueError(f"frames have {n} values, spec says {self.spec.n}")
        flights = []
        for (lo, hi), dev in zip(_split(F, self.ndev), self.devices):
            x = torch.from_numpy(coding._pad_batch(frames[lo:hi], self.spec))
            flights.append((lo, hi, coding.encode_dispatch(
                self.spec, x.to(dev, non_blocking=True))))
        bits = np.zeros(F, np.int64)
        maxw = np.zeros(F, np.int64)
        shards = []
        for lo, hi, p in flights:
            w, b, m = coding.encode_collect(p)
            bits[lo:hi], maxw[lo:hi] = b, m
            shards.append((lo, hi, w))
        W = max((w.shape[1] for _, _, w in shards), default=0)
        if len(shards) == 1 and shards[0][2].shape[0] == F:
            words = shards[0][2]
        else:
            words = np.zeros((F, W), np.uint32)
            for lo, hi, w in shards:
                words[lo:hi, : w.shape[1]] = w
        return words, bits, maxw

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
        clamp, as there)."""
        dtype = np.dtype(dtype)
        meta = archive.meta
        if meta.prolix_bits > self.spec.max_width:
            return coding.decode(archive, dtype, device=self.devices[0])
        widths, words = walk_archive(archive, self.spec)
        words = torch.from_numpy(words.view(np.int32))
        widths = torch.from_numpy(widths.astype(np.uint8))
        flights = [
            coding.decode_dispatch(self.spec, words[lo:hi], widths[lo:hi],
                                   dev)
            for (lo, hi), dev in zip(_split(meta.number_of_frames, self.ndev),
                                     self.devices)]
        out = [coding.decode_collect(p, dtype) for p in flights]
        return np.concatenate(out) if len(out) != 1 else out[0]


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

