"""Smoke run of trpx_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through ``trpx_tpu_torch.compress`` -> ``.trpx``
-> ``trpx_tpu_torch.decompress``, with ``device`` at its default (the
card): 256 seeded 512x512 uint16 diffraction-like frames (Poisson(3) with
hot pixels at 65535) through the one-pass CUDA pack and unpack kernels,
and big frames, 32 of 2048x2048 and 8 of 4096x4096 uint32 (Poisson(3)
with 200 hot pixels per frame at 2,000,000,000, the 2K/4K u32 batches of
``bench.py``), through the one-pass pack and the tiled unpack; 4 frames
of 2048x2048 int32 in blocks of 1,024 values through the tiled pack and
the tiled unpack. Phases, one line each (more for phases 5 and 6):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernels' build from ``trpx_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together, then a link; seconds), and beside it the
   bounds-checked build of phase 11(d);
3. each kernel against its plain PyTorch version on the card, exactly
   (lossless integer codec: tolerance 0; the one-pass pack on the words
   each frame defines, ``cuda_pack.defined_words``): the one-pass kernels
   at the 512x512 path's shape, on an all-zero frame, partial blocks,
   every other device dtype, every dtype at its worst case (all values at
   the dtype's extreme) and frames whose tile edges fall on a width change
   and on a repeated width; the tiled kernels (whose packs define the same
   words) at 64-block tiles on every device dtype (partial last tile and
   block, a constant frame, a zero first tile, the widest field at a
   tile's first and last value), and at their default tiles on 4 frames
   of 2048x2048 u32, on blocks larger than a tile (one-block tiles walked
   in chunks; the widest field at a chunk's edge, a zero block, a partial
   block) and on tiles of fewer than 32 bits (all-zero blocks of 1,024
   values, many tiles to a word); after every launch the thread's current
   device is the one it was (on one card this cannot fail: it guards
   against a device guard that throws, and is no evidence of the repair);
4. the 512x512 path: archive bytes equal the native host codec's, pixels
   round-trip exactly, a natively encoded ("foreign") archive decodes to
   the same pixels; the one-pass kernels' launch counters moved and the
   tiled ones did not;
5. the big-frame paths, the same checks with the counters of each path's
   route (``FrameSpec.tiled``, ``FrameSpec.tiled_pack``) moving and the
   others not, and all four kernels against their plain versions at each
   big shape, exactly; the wide-block path likewise, with the tiled pack
   and both unpacks against their plain versions at its shape; a
   breakdown of compress and decompress of 32 x 2048x2048 by layer from
   ``torch.profiler`` (the ``trpx.*`` ranges of ``ops.coding``, and the
   device time of each kernel and copy);
6. each kernel's times at the shape of a path that runs it (the one-pass
   kernels at 256 x 512x512 u16, the tiled pack on the wide-block path,
   the tiled unpack at 8 x 4096x4096 u32): device time per call
   (``runtime.metrics.device_ms``: calls queued behind a sleeping kernel,
   its fills included), the CUDA-event time of a loop of calls and its
   plain version's time, beside its bound (the bytes it
   must move over 3.35 TB/s), and the tiled kernels' three launches each
   from ``torch.profiler``; then the other routes at the 512x512 and
   big shapes (the tiled pack at 32 x 2048x2048 u32 beside the one-pass
   pack that the route gives that batch);
7. the stream path (``trpx_tpu_torch.runtime``), each step with the
   launch counters set to 0 just before and read just after:
   (a) ``StreamingEncoder`` on the card over 1,024 x 512x512 u16 in
   256-frame chunks, ``finalize(verify=True, index=True)``, bytes equal to
   the native codec's, and a crash-and-resume drill; (b) ``decompress``
   of that file through ``iter_decode``, indexed and foreign, lossless;
   (c) ``iter_decode(fetch=False)`` chunks on the card equal to the
   frames; (d) 64 x 2048x2048 u32 through ``StreamingEncoder`` (with the
   resume drill) and ``iter_decode`` in 32-frame chunks, on the one-pass
   pack and the tiled unpack; (e) ``Terse`` on the card: three
   ``push_back``s, ``write``, ``from_stream``, ``prolix`` of the first, a
   middle and the last frame (the one-pass pack, the tiled unpack).
   (a), (b) and (d) print host-clock frames/s beside the synchronous path
   over the same chunks;
8. the parallel path (``trpx_tpu_torch.parallel``): two worker processes
   (this script with ``--worker``, fresh interpreters started with
   ``subprocess``), both on ``cuda:0``, joined in a gloo process group on
   localhost at a free port (``init_from_env``): (a) 2 x 128 of 512x512
   u16 through ``ShardedCodec.encode_shards`` + ``write_shard_file`` into
   one file, equal to the native codec's bytes of the 256 frames; (b) 2 x
   2 of 2048x2048 u32 (each shard takes the tiled pack), likewise; (c)
   ``StreamingShardEncoder`` over the 256 frames in 64-frame chunks, rank
   1 killed (``os._exit(3)``) after chunk 2's checkpoint, a torn tail
   written at the checkpoint, a relaunch that resumes and finalizes, equal
   to the native bytes; then in this process on the card (d)
   ``recover_shard`` of a zeroed back half and (e) ``decode_sharded`` of
   both files, equal to the input. Each worker reports its launch counters
   per drive, checked against the route ``FrameSpec`` gives each shard.
   The two processes time-slice one card: their wall times are no scaling
   figure;
9. the CLI (``trpx_tpu_torch.cli.main.main``) in this process, default
   device: ``encode`` of a 64 x 512x512 u16 and a 4 x 2048x2048 u32 TIFF
   stack (written with the port's ``write_tiff``), equal to the native
   codec's bytes; ``decode`` back to the same pixels; the same through
   ``--stream``; ``verify``, ``info``; ``bench --frames 64 --e2e``. Each
   step's launch counters are checked against its routes;
10. the bench and the tools, each drive with the launch counters set to 0
   just before it and checked against its routes just after: (a)
   ``trpx_tpu_torch.bench`` at its full batches (512 x 512x512 u16, 32 x
   2048x2048 and 8 x 4096x4096 u32), with ``BENCH_DISTINCT`` resident
   batches and ``BENCH_REPS`` calls on each, its guards (archive bytes ==
   native codec, decode == frames) passing first; its JSON line, with the
   keys of ``bench.py``'s, beside the card line; (b) the differential
   campaign's smoke tier on the default device (the card): every row of
   ``SMOKE_TRIALS`` and ``ROUTE_TRIALS`` byte for byte against pycodec
   (rows of at most 3.2M values) and the native codec, each row's counters
   against the route ``FrameSpec`` gives it (the tiled pack on the 1-3
   frame 2048x2048/4096x4096 rows); (c) ``graft_entry.entry()``'s pack
   equal to ``encode_batch_plain`` on the words each frame defines, then
   ``dryrun_multichip(2)``, two ranks on ``cuda:0``, each reporting its
   counters; (d) ``tools.scaling`` on the card(s): the one-card rate and,
   with one card, a null scaling efficiency. The launches of (b) and (c)
   join the kernels line; those of (a) and (d), which repeat calls to time
   them, are checked against their routes and printed, but not counted;
11. the guarantees the JAX package keeps: (a) the hostile corpus of
   ``tests/test_fuzz_decode.py`` (the same seeds: 120 payload byte flips,
   46 truncations, 15 header tamperings, 64 corruption bursts, random
   garbage) of a 3 x 1,000 u16 archive (the tiled unpack) and of a
   256 x 4,096 one with hot pixels (the one-pass unpack), and the
   mutations past the first chunk of a 520 x 1,024 one (``pipeline_corpus``:
   the pipelined decode in chunks of 256, 256 and 8 frames, on the
   one-pass unpack and then the tiled; flips, streams that end inside
   chunk 2 or 3, bursts), through the public ``decompress`` at its
   default device, each outcome equal to ``decompress(blob,
   device="cpu")`` (the same clean error class or equal pixels;
   ``device=False`` where the default sends the stream to the host
   codec), the counts by outcome printed, the launches on the routes
   ``FrameSpec`` gives the decoded mutations; on the 520-frame base also
   (``pipeline_cases``) two crafted sidecars (exact pixels, one
   RuntimeWarning at ``stream.sidecar_tables`` each), ``iter_decode
   (fetch=False)`` through a stream that ends inside chunk 2 (the plain
   versions' exception class before any chunk: the walk of chunk k + 1
   precedes the yield of chunk k) and one that ends inside chunk 3 (chunk
   1 equal to the plain versions', then their exception class), and 20
   pipelines closed with chunk 2 in flight before a clean decode; then a
   synchronize and a clean 256 x 512x512 round trip show the context
   healthy; (b) the race drill: ``RACE_THREADS`` host threads launch at once, alternating
   both unpacks of u8/u16 and of i16/i32 batches, both packs of u8/u16
   frames and all four kernels on u32 frames in blocks of 3, 64 and 512
   values (kernel instances shared at different shared-memory sizes,
   some above 48 KB), every result exact; (c) BASELINE config 4, the acquisition pipeline of
   ``docs/DEPLOY.md``: 10,000 x 512x512 u16 (Poisson(3), 200 hot pixels a
   frame at 65535) drawn on the card in 256-frame chunks
   (``bench.synth``, a seed per chunk) into one 5.24 GB BigTIFF with
   ``TiffWriter``; the CLI in process, ``encode --stream --index`` at the
   default device and ``encode --stream --host`` (SHA-256 equal),
   ``decode --stream`` (a BigTIFF by ``needs_bigtiff``, held chunk by
   chunk through ``TiffStream`` against the frames drawn again) and
   ``verify``, each step's host-clock frames/s printed; (d) the
   bounds-checked build (``_build.select_checked``: every ``TRPX_CHECK``
   a device assert) in a child process (``--checked``), since a failed
   check poisons its context: the library's self-test trips its check in
   a grandchild (``--checked-selftest``), which must fail and name the
   line; then (a)'s three bases and cases, each outcome equal to the
   normal build's in this process, the hostile tables of
   ``tests/test_torch_cuda.py::test_unpack_kernels_on_hostile_tables``
   and (b)'s drill at ``CHECKED_RACE_CALLS`` calls a thread; the child
   must exit 0. The launches of (a), (b) and (d), which are not traffic,
   are checked but not counted; those of (c) join the kernels line;
12. the sharded path (``trpx_tpu_torch.parallel.ShardedCodec``), each drive
   with the launch counters set to 0 just before it and checked against
   the routes of its shards just after: (a) on any number of cards,
   ``ShardedCodec(spec, [cuda:0] * k)`` for k = 1, 2 and 4 over 256 x
   512x512 u16 and 32 x 2048x2048 u32 (drawn as in phase 5): ``encode``
   equal to the native codec's bytes, ``decode`` lossless; then, warm, the
   host ms of the dispatch loop (``_dispatch_local``), of the collect and
   of whole ``encode`` and ``decode`` calls, medians of ``SHARD_REPS``;
   and the overlap check: ``_dispatch_local`` of the 2048x2048 batch over
   two shards, queued behind a spin kernel of ``OVERLAP_SPIN_CYCLES``,
   returns while ``cuda:0``'s current stream still has work queued (no
   dispatch waited for its kernel); (b) on two or more
   cards (one line saying so, and no check, on one): ``ShardedCodec`` over
   every card, bytes and pixels as in (a); ``dryrun_multichip`` with one
   rank per card; two gloo workers with rank r on ``cuda:r`` writing
   phase 8's shared files (``--worker cards``), equal to the native
   codec's bytes; ``tools.scaling`` over 1, 2, 4, ... cards (fps(N) and
   the scaling efficiency); and, in a child ``pytest``, the card tests
   that need two cards (``test_launchers_leave_the_current_device``,
   ``test_sharded_codec_on_every_card``), which must pass. The launches of
   (a)'s first drives and of (b)'s codec, dry run and workers join the
   kernels line; those of the timing loops and of the scaling tool do
   not.

13. the header walk of one frame on the card (``csrc/walk.cu``,
   ``ops.cuda_walk``): (a) the kernels against their plain version on the
   card (rounds, header count, widths, end, widest block) and against the
   host walk (``native.walk_chunk``) at the shape of an EIGER2 X 16M image
   (4362x4148 u32 on its module grid, ``tools.walk_bench.gapped_image``)
   and at 2048x2048 u32, at 2,048-bit parts and at ``WALK_BITS``; (b)
   phase 11(a)'s hostile corpus rebuilt on one u16 frame of
   ``WALK_ON_CARD_MIN_BLOCKS`` blocks and more (``WALK_CORPUS_VALUES``),
   through ``decompress`` on the card, each outcome (pixels, or the error
   class and message) and each archive's tables equal to those of the same
   decode walked on the host (the constant raised), no fallback warning;
   (c) the walk's kernels' device time per call (``torch.profiler``) at the
   image's shape beside its bound (payload in, a byte a block out, over
   3.35 TB/s) and its plain version's time; (d) ``WALK_IMAGES`` such
   images through ``decompress``: each walked on the card
   (``walks.card``), none at the round cap (``walks.unsynced``), the
   rounds an image (``walks.sync_rounds``) and the most an image took
   beside ``WALK_ROUND_CAP``, the pixels exact, the launch counters set to
   0 just before and read just after: one tiled unpack an image, and at
   least one walk launch (a batch of rounds) an image. The launches of (a)
   to (c) are checks, not traffic, and are not counted: the kernels line's
   walk entry gives (d)'s walk launches and (a)'s largest difference of
   the kernels' widths from the plain version's and the host walk's, and
   (d)'s tiled unpacks join ``unpack_tiled``'s.

14. a Gatan K3 counting-mode movie (``K3_MOVIE``: 40 fractions of
   5760x4092 u8, Poisson(0.86) counts drawn on the card): ``decompress
   (dtype=np.uint8)`` of the native codec's archive at the default device,
   the pixels exact; every frame on ``decode_batch_tiled``
   (``frames.decode_batch_tiled``) in one launch, the u8 lanes' bytes
   (``unpack_out_bytes.trpx.decode.kernel``, one a pixel) and a pinned
   result (``results.pinned``, no ``results.pageable``); then three
   movies decoded while the two before are held, every one pinned; the
   host-clock ms of a decode, and the tiled unpack's device ms in u8 lanes
   beside u16 lanes of the same movie. The first decode's launch joins the
   kernels line.

``python3 chip_smoke.py --sharded [a|b]`` builds the kernels and runs
phase 12 alone (or only its part a or b); ``--walk`` builds them and runs
phase 13 alone; ``--counted`` builds them and runs phase 14 alone.

It then prints the card line, a JSON line of per-kernel results and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; so does a machine without CUDA. Imports nothing of JAX or of the JAX
package: the byte oracle is the port's own native host codec
(``trpx_tpu_torch.native``), independent of the CUDA kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F_MAIN = 256
SIDE = 512
SEED = 0
#: (side, frames) of the big-frame path: bench.py's 2K and 4K u32 batches
BIG = ((2048, 32), (4096, 8))
HOT_U32 = 2_000_000_000
#: values per block of the wide-block path (4 x 2048x2048 int32): too many
#: for a tile of the one-pass pack, so it takes the tiled pack
WIDE_BLOCK = 1024
SMALL_TILE = 64
#: values per block larger than a tile of the tiled kernels (their
#: TILE_VALUES, 8,192)
BIG_BLOCK = 9000
#: (frames, side, chunk frames) of the stream phase: 1,024 x 512x512 u16
#: in 256-frame chunks, 64 x 2048x2048 u32 in 32-frame chunks (both on the
#: one-pass kernels)
STREAM_MAIN = (1024, 512, 256)
STREAM_BIG = (64, 2048, 32)
#: phase 8: ranks, frames of 512x512 u16 and of 2048x2048 u32 across them,
#: stream chunk frames, and the gloo timeout (seconds) of their group
WORLD = 2
PAR_MAIN = 256
PAR_BIG = 4
PAR_CHUNK = 64
WORKER_TIMEOUT_S = 120.0
#: phase 10(a): distinct resident batches of each bench configuration and
#: timed calls on each (``python -m trpx_tpu_torch.bench`` alone keeps
#: ``bench.py``'s 9 / 5 batches and 7 reps)
BENCH_DISTINCT = 3
BENCH_REPS = 3
#: phase 11(a): (frames, values) of the hostile corpus's base archives of
#: u16, the first decoded by the tiled unpack, the second by the one-pass,
#: the third by the pipelined decode in chunks of PIPE_CHUNK (256, 256 and
#: 8 frames: the one-pass unpack, then the tiled) with its mutations past
#: the first chunk
HOSTILE_BASES = ((3, 1000), (256, 4096), (520, 1024))
PIPE_CHUNK = 256
#: phase 11(a): pipelines of the third base closed after their first chunk
ABANDONED = 20
#: the clean outcomes of a hostile archive besides a decode
OK_ERRORS = (ValueError, TypeError, OverflowError, KeyError, IndexError)
#: phase 11(b): host threads of the race drill and calls a thread
RACE_THREADS = 4
RACE_CALLS = 100
#: phase 11(d): calls a thread of the race drill under the bounds-checked
#: build, and the time limit (seconds) of its child process
CHECKED_RACE_CALLS = 25
CHECKED_TIMEOUT_S = 600
#: phase 11(c): BASELINE config 4, a movie of 512x512 u16 frames through
#: the acquisition pipeline of docs/DEPLOY.md, drawn and compared in
#: chunks of MOVIE_CHUNK frames
MOVIE_FRAMES = 10_000
MOVIE_CHUNK = 256
#: phase 12(a): shard counts of ``ShardedCodec(spec, [cuda:0] * k)``, the
#: batches (frames, side, dtype) drawn as in phase 5, and the timed
#: repetitions of each warm step
SHARDS = (1, 2, 4)
SHARD_BATCHES = ((256, 512, np.uint16), (32, 2048, np.uint32))
SHARD_REPS = 3
#: cycles of the spin kernel queued before each dispatch of phase 12(a)'s
#: overlap check: ~0.54 s at the H100's 1.98 GHz, far longer than the
#: dispatch loop's host work
OVERLAP_SPIN_CYCLES = 1 << 30
#: phase 13: values of the hostile corpus's one-frame base (u16, at least
#: WALK_ON_CARD_MIN_BLOCKS blocks), and the images whose rounds it counts
WALK_CORPUS_VALUES = 2_000_000
WALK_IMAGES = 16
#: device memory rate of an H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
DTYPES = (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32)


#: phase 14: a Gatan K3 movie, (fractions, height, width) of counted u8
#: frames at Poisson(K3_COUNTS) electrons a pixel
K3_MOVIE = (40, 4092, 5760)
K3_COUNTS = 0.86


def _frames(rng, F, n, dtype=np.uint16, hot=200, hot_value=None):
    """Poisson(3) frames with `hot` pixels per frame at `hot_value` (the
    dtype's max by default)."""
    fr = rng.poisson(3.0, (F, n)).astype(dtype)
    if hot:
        rows = np.repeat(np.arange(F), hot)
        fr[rows, rng.integers(0, n, F * hot)] = (
            np.iinfo(dtype).max if hot_value is None else hot_value)
    return fr


def _signed_frames(rng, F, n, dtype):
    info = np.iinfo(dtype)
    fr = rng.integers(-300, 300, (F, n)).clip(info.min, info.max)
    fr = fr.astype(dtype)
    fr[0, 0] = info.min
    fr[-1, -1] = info.max
    return fr


def _tile_edge_frames(rng, dtype, tile):
    """Four frames crossing `tile`-block tile edges with the tiled kernels'
    hard cases: random data, a constant frame (1-bit headers at every
    edge), a first tile of width 0, and the widest field at a tile's first
    value and (signed) last value. n leaves a partial last tile and
    block."""
    n = tile * 12 * 3 + 101
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = _signed_frames(rng, 4, n, dtype)
        fr[3, tile * 12 - 1] = info.min
    else:
        fr = _frames(rng, 4, n, dtype, hot=5)
    fr[3, tile * 12] = info.min if info.min < 0 else info.max
    fr[1] = 5
    fr[2, : tile * 12 + 5] = 0
    return fr


def _extreme_frames(dtype, n=40_000):
    """The worst case of a dtype: every value at its extreme (the widest
    stream a tile holds; 33-bit fields for int32)."""
    info = np.iinfo(dtype)
    return np.full((2, n), info.min if info.min < 0 else info.max, dtype)


def _one_pass_edge_frames(rng, dtype):
    """Two frames of three one-pass tiles (``cuda_pack.pack_geometry``)
    whose tile edges fall on a width change (a wide block right after the
    edge, a zero block right before it) and on a repeated width."""
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.ops.cuda_pack import pack_geometry

    tb = pack_geometry(FrameSpec.for_dtype(10**6, dtype))[0]
    edge = tb * 12
    info = np.iinfo(dtype)
    fr = _frames(rng, 2, 3 * edge + 7, dtype, hot=5) if info.min == 0 \
        else _signed_frames(rng, 2, 3 * edge + 7, dtype)
    fr[0, :] = 3
    fr[0, edge : edge + 12] = info.max
    fr[0, 2 * edge - 12 : 2 * edge] = 0
    fr[1, :] = 5
    return fr


def _big_block_frames(rng, dtype):
    """Three frames in blocks of ``BIG_BLOCK`` values (one-block tiles of
    the tiled kernels, walked in chunks of 8,192 values): the widest field
    on both sides of the first chunk edge, a zero block, a partial last
    block."""
    n = 3 * BIG_BLOCK + 17
    info = np.iinfo(dtype)
    fr = _signed_frames(rng, 3, n, dtype) if info.min < 0 \
        else _frames(rng, 3, n, dtype, hot=5)
    widest = info.min if info.min < 0 else info.max
    fr[0, 8191:8193] = widest
    fr[1, BIG_BLOCK : 2 * BIG_BLOCK] = 0
    fr[2, -1] = widest
    return fr


def _sparse_frames(rng, dtype):
    """Three frames of 200 blocks of ``WIDE_BLOCK`` values, mostly zero:
    tiles of all-zero blocks hold a few header bits, so many tiles share a
    word; a lone value, a one-bit block and a run of data between them."""
    block = WIDE_BLOCK
    n = 200 * block + 100
    fr = np.zeros((3, n), dtype)
    fr[0, 5 * block + 3] = 7
    fr[1, -1] = np.iinfo(dtype).max
    fr[2, 17 * block : 18 * block] = 1
    fr[2, 100 * block :] = _frames(rng, 1, n - 100 * block, dtype, hot=3)[0]
    return fr


def _route(spec, frames: int) -> tuple:
    """The pack and the unpack a batch of `frames` such frames takes."""
    return ("pack_tiled" if spec.tiled_pack(frames) else "pack",
            "unpack_tiled" if spec.tiled(frames) else "unpack")


def _bound_ms(nbytes: int) -> float:
    """Least time to move `nbytes` through the card's memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (as int64)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    return int((a - b).abs().max().item()) if a.numel() else 0


def _builds_openmp(cxx: str) -> bool:
    """True if `cxx` compiles and links a trivial OpenMP program."""
    if shutil.which(cxx) is None:
        return False
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            [cxx, "-fopenmp", "-x", "c++", "-", "-o", os.path.join(d, "a")],
            input="int main() { return 0; }\n", capture_output=True,
            text=True)
    return r.returncode == 0


def _counters():
    """The four kernel wrappers, whose `.launches` count kernel launches."""
    from trpx_tpu_torch.ops import (
        decode_batch,
        decode_batch_tiled,
        encode_batch,
        encode_batch_tiled,
    )

    return {"pack": encode_batch, "unpack": decode_batch,
            "pack_tiled": encode_batch_tiled,
            "unpack_tiled": decode_batch_tiled}


def _drive(stack: np.ndarray, block: int = 12) -> dict:
    """One compress and decompress of `stack` (F, h, w) through the public
    API as a user calls it (``device`` left at its default, the card),
    with the launch counters set to 0 just before and read just after,
    then a decompress of the native codec's (foreign) archive; raises
    unless bytes, pixels and the foreign decode all agree."""
    import trpx_tpu_torch
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.native import codec as ncodec

    F, h, w = stack.shape
    native_arch = ncodec.encode(stack.reshape(F, -1), block=block,
                                dimensions=(w, h))
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    arch = trpx_tpu_torch.compress(stack, block=block)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = trpx_tpu_torch.decompress(arch)
    t_dec = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    foreign = TrpxArchive.from_bytes(native_arch.to_bytes())
    t0 = time.perf_counter()
    back_foreign = trpx_tpu_torch.decompress(foreign)
    t_foreign = time.perf_counter() - t0
    name = f"{F}x{h}x{w} {stack.dtype}"
    if arch.to_bytes() != native_arch.to_bytes():
        raise AssertionError(f"{name}: compress bytes differ from the "
                             f"native codec's")
    if back.shape != stack.shape or back.dtype != stack.dtype \
            or not np.array_equal(back, stack):
        raise AssertionError(f"{name}: decompress did not round-trip")
    if not np.array_equal(back_foreign, stack):
        raise AssertionError(f"{name}: foreign archive decoded to other "
                             f"pixels")
    return dict(arch=arch, launches=launches, t_enc=t_enc, t_dec=t_dec,
                t_foreign=t_foreign, ratio=stack.nbytes / arch.meta.memory_size)


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _stream_encode(flat, dims, chunk, dev, path, want: bytes,
                   resume: bool = False):
    """``StreamingEncoder`` over the (F, n) frames `flat` in `chunk`-frame
    chunks into `path`, then ``finalize(verify=True, index=True)``; raises
    unless the file equals `want`. With `resume`, first a crash drill:
    two chunks, the encoder dropped without ``flush`` (the second chunk
    in flight is lost), and a new encoder resumes from ``frames_done``.
    Returns the host-clock seconds of the chunks (up to the last flush)
    and of finalize."""
    from trpx_tpu_torch.runtime import StreamingEncoder

    def encoder():
        return StreamingEncoder(path, nvalues=flat.shape[1], dtype=flat.dtype,
                                dimensions=dims, device=dev)

    start = 0
    if resume:
        enc = encoder()
        enc.add_frames(flat[:chunk])
        enc.add_frames(flat[chunk : 2 * chunk])
        del enc
        start = encoder().frames_done
        if start != chunk:
            raise AssertionError(f"resume from frame {start}, expected "
                                 f"{chunk}")
    t0 = time.perf_counter()
    enc = encoder()
    for lo in range(start, flat.shape[0], chunk):
        enc.add_frames(flat[lo : lo + chunk])
    enc.flush()
    t_chunks = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc.finalize(verify=True, index=True)
    t_final = time.perf_counter() - t0
    if path.read_bytes() != want:
        raise AssertionError(f"{path.name}: stream-encoded bytes differ "
                             f"from the native codec's"
                             + (" after a resume" if resume else ""))
    return t_chunks, t_final


def _sync_times(stack, chunk, arch, dev):
    """Host-clock seconds of the synchronous path over the same chunks:
    ``compress`` of each chunk, and ``ops.decode`` of each chunk's
    sub-archive (walk included), one after the other."""
    import trpx_tpu_torch
    from trpx_tpu_torch import ops
    from trpx_tpu_torch.io.trpx import subset_frames

    F = stack.shape[0]
    t0 = time.perf_counter()
    for lo in range(0, F, chunk):
        trpx_tpu_torch.compress(stack[lo : lo + chunk], device=dev)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, F, chunk):
        ops.decode(subset_frames(arch, slice(lo, min(F, lo + chunk))),
                   stack.dtype, device=dev)
    return t_enc, time.perf_counter() - t0


def _stream_phase(rng, dev, card: str, workdir: Path) -> dict:
    """Phase 7, the stream path: (a) ``StreamingEncoder`` over 1,024 x
    512x512 u16 in 256-frame chunks, with a resume drill; (b)
    ``decompress`` of that file, indexed and foreign, through
    ``iter_decode``; (c) ``iter_decode(fetch=False)``; (d) 64 x
    2048x2048 u32 through ``StreamingEncoder`` and ``iter_decode`` in
    32-frame chunks; (e) ``Terse`` on the card. Each is driven with the
    launch counters set to 0 just before it and read just after; returns
    their sums."""
    import trpx_tpu_torch
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.io.trpx import read_trpx
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.runtime import iter_decode

    total = dict.fromkeys(_counters(), 0)

    def expect(name, got, moved, still):
        if min(got[k] for k in moved) < 1 or any(got[k] for k in still):
            raise AssertionError(f"{name} took the wrong kernels: {got}")
        for k, v in got.items():
            total[k] += v

    tiled = ("pack_tiled", "unpack_tiled")
    # (a) 512x512 u16 stream encode, 256-frame chunks
    F, side, C = STREAM_MAIN
    stack = _frames(rng, F, side * side).reshape(F, side, side)
    flat = stack.reshape(F, -1)
    want = ncodec.encode(flat, dimensions=(side, side)).to_bytes()
    path = workdir / "main.trpx"
    _zero_counts()
    t_chunks, t_final = _stream_encode(flat, (side, side), C, dev, path, want)
    got = _read_counts()
    expect("512x512 stream encode", got, ("pack",), tiled + ("unpack",))
    t_warm, _ = _stream_encode(flat, (side, side), C, dev,
                               workdir / "warm.trpx", want)
    _stream_encode(flat, (side, side), C, dev, workdir / "resume.trpx",
                   want, resume=True)
    arch = TrpxArchive.from_bytes(want)
    s_enc, s_dec = _sync_times(stack, C, arch, dev)
    print(f"phase 7a stream encode: {F}x{side}x{side} u16 "
          f"({stack.nbytes / 1e6:.1f} MB) in {C}-frame chunks on {card}: "
          f"bytes == native codec, resume drill ok, launches {got}; host "
          f"clock {t_chunks * 1e3:.1f} ms = {F / t_chunks:.1f} frames/s "
          f"(second run {t_warm * 1e3:.1f} ms = {F / t_warm:.1f} frames/s) "
          f"+ finalize(verify, index) {t_final * 1e3:.1f} ms; synchronous "
          f"compress of the same chunks {s_enc * 1e3:.1f} ms = "
          f"{F / s_enc:.1f} frames/s", flush=True)
    # (b) decompress of that file: indexed, then foreign
    times = {}
    for kind, src in (("indexed", lambda: read_trpx(path)),
                      ("foreign", lambda: TrpxArchive.from_bytes(want))):
        a = src()
        if (getattr(a, "width_table", None) is not None) != \
                (kind == "indexed"):
            raise AssertionError(f"{kind} archive has the wrong tables")
        _zero_counts()
        t0 = time.perf_counter()
        back = trpx_tpu_torch.decompress(a, device=dev)
        times[kind] = time.perf_counter() - t0
        got = _read_counts()
        expect(f"512x512 {kind} stream decode", got, ("unpack",),
               tiled + ("pack",))
        if back.shape != stack.shape or not np.array_equal(back, stack):
            raise AssertionError(f"{kind} stream decode lost pixels")
        if a.width_table is None or len(a.frame_index) != F:
            raise AssertionError(f"{kind} decode left no walk tables")
        del back
    print(f"phase 7b stream decode ({card}): decompress of {F} frames "
          f"through iter_decode, lossless, unpack launches "
          f"{got['unpack']}; host clock indexed "
          f"{times['indexed'] * 1e3:.1f} ms = "
          f"{F / times['indexed']:.1f} frames/s, foreign "
          f"{times['foreign'] * 1e3:.1f} ms = "
          f"{F / times['foreign']:.1f} frames/s; synchronous "
          f"ops.decode of the same chunks (foreign) {s_dec * 1e3:.1f} ms "
          f"= {F / s_dec:.1f} frames/s", flush=True)
    # (c) device-resident chunks
    _zero_counts()
    lo = 0
    for out, nf in iter_decode(path, np.uint16, C, device=dev, fetch=False):
        ref = torch.from_numpy(flat[lo : lo + nf]).to(dev)
        if out.device != ref.device or not torch.equal(
                out[:nf].view(torch.int16), ref.view(torch.int16)):
            raise AssertionError("iter_decode(fetch=False) chunk differs")
        lo += nf
    got = _read_counts()
    expect("fetch=False stream decode", got, ("unpack",), tiled + ("pack",))
    if lo != F:
        raise AssertionError(f"iter_decode(fetch=False) gave {lo} frames")
    print(f"phase 7c iter_decode(fetch=False): {F // C} CUDA chunks equal "
          f"to the frames", flush=True)
    layers = {f"{side}x{side} u16": _stream_layers(flat, (side, side), C,
                                                    dev, workdir)}
    del stack, flat, want, arch
    # (d) 2048x2048 u32, 32-frame chunks: the one-pass pack, the tiled
    # unpack
    F, side, C = STREAM_BIG
    stack = _frames(rng, F, side * side, np.uint32,
                    hot_value=HOT_U32).reshape(F, side, side)
    flat = stack.reshape(F, -1)
    want = ncodec.encode(flat, dimensions=(side, side)).to_bytes()
    path = workdir / "big.trpx"
    _zero_counts()
    t_chunks, t_final = _stream_encode(flat, (side, side), C, dev, path,
                                       want, resume=True)
    got_enc = _read_counts()
    expect("2048x2048 stream encode", got_enc, ("pack",),
           tiled + ("unpack",))
    t_dec = {}
    for kind in ("indexed", "foreign"):
        a = read_trpx(path) if kind == "indexed" \
            else TrpxArchive.from_bytes(want)
        _zero_counts()
        t0 = time.perf_counter()
        back = _consume(iter_decode(a, np.uint32, C, device=dev), flat)
        t_dec[kind] = time.perf_counter() - t0
        got = _read_counts()
        expect(f"2048x2048 {kind} stream decode", got, ("unpack_tiled",),
               ("pack", "unpack", "pack_tiled"))
        if not np.array_equal(back, flat):
            raise AssertionError(f"2048x2048 {kind} stream decode lost "
                                 f"pixels")
        del back
    s_enc, s_dec = _sync_times(stack, C, TrpxArchive.from_bytes(want), dev)
    print(f"phase 7d big-frame stream: {F}x{side}x{side} u32 "
          f"({stack.nbytes / 1e6:.1f} MB) in {C}-frame chunks on {card}: "
          f"bytes == native codec (resume drill included), lossless, "
          f"launches encode {got_enc}, decode {got}; host clock encode "
          f"{t_chunks * 1e3:.1f} ms = {(F - C) / t_chunks:.2f} frames/s "
          f"(the {F - C} frames after the resume) + finalize "
          f"{t_final * 1e3:.1f} ms, iter_decode indexed "
          f"{t_dec['indexed'] * 1e3:.1f} ms = "
          f"{F / t_dec['indexed']:.2f} frames/s, foreign "
          f"{t_dec['foreign'] * 1e3:.1f} ms = "
          f"{F / t_dec['foreign']:.2f} frames/s; synchronous compress "
          f"{s_enc * 1e3:.1f} ms = {F / s_enc:.2f} frames/s, ops.decode "
          f"(foreign) {s_dec * 1e3:.1f} ms = {F / s_dec:.2f} frames/s",
          flush=True)
    layers["2048x2048 u32"] = _stream_layers(flat, (side, side), C, dev,
                                             workdir)
    del stack, flat, want
    for name, runs in layers.items():
        print(f"phase 7 layers ({name}, {card}; torch.profiler, one warm "
              f"run, ms per chunk): " + "; ".join(
                  f"{run} wall {wall:.2f}, host " + ", ".join(
                      f"{k} {v:.2f}" for k, v in host.items())
                  + ", device " + ", ".join(
                      f"{k} {v:.3f}" for k, v in device.items())
                  + f", device busy {sum(device.values()):.2f}"
                  for run, (wall, host, device) in runs.items()),
              flush=True)
    # (e) the Terse adapter on the card
    fr = _frames(rng, 24, 512 * 512).reshape(24, 512, 512)
    _zero_counts()
    t = trpx_tpu_torch.Terse(device=dev)
    for lo in (0, 8, 16):
        t.push_back(fr[lo : lo + 8])
    blob = workdir / "terse.trpx"
    t.write(blob)
    t2 = trpx_tpu_torch.Terse.from_stream(blob, device=dev)
    for i in (0, 12, 23):
        if not np.array_equal(t2.prolix(i), fr[i]):
            raise AssertionError(f"Terse.prolix({i}) differs")
    got = _read_counts()
    # the batch of 24 takes the one-pass pack, the single frames of prolix
    # the tiled unpack (FrameSpec.tiled_pack, FrameSpec.tiled)
    expect("Terse", got, ("pack", "unpack_tiled"), ("pack_tiled", "unpack"))
    if blob.read_bytes() != ncodec.encode(
            fr.reshape(24, -1), dimensions=(512, 512)).to_bytes():
        raise AssertionError("Terse.write bytes differ from the native "
                             "codec's")
    print(f"phase 7e Terse on the card: 3 push_backs of 8 x 512x512 u16, "
          f"write == native codec, from_stream, prolix(0/12/23) exact, "
          f"launches {got}", flush=True)
    return total


def _consume(chunks, like: np.ndarray) -> np.ndarray:
    """Copy ``iter_decode``'s chunks into one preallocated array, as
    ``decompress`` does, so each chunk's buffer is released in turn."""
    from trpx_tpu_torch.runtime.metrics import span

    out = np.empty_like(like)
    lo = 0
    for chunk in chunks:
        with span("trpx.consumer.copy"):
            hi = lo + chunk.shape[0]
            torch.from_numpy(out[lo:hi]).copy_(torch.from_numpy(chunk))
        lo = hi
    return out


def _short(key: str) -> str:
    """"void ns::name<T>(args)" -> "name"; copies keep their name."""
    if key.startswith("Mem"):
        return key
    return key.replace("(anonymous namespace)::", "").split("(")[0].split(
        "<")[0].split("::")[-1]


def _launch_ms(fn, reps: int = 10) -> dict:
    """Device ms per call of each kernel that `fn` launches, by short
    name: a ``torch.profiler`` window over `reps` calls after a warm
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k = _short(e.key)
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _stream_layers(flat, dims, C, dev, workdir: Path) -> dict:
    """``torch.profiler`` windows over one stream encode of `flat` (its
    chunks and the last flush, after a run that warmed the pinned
    buffers) and one ``iter_decode`` of the foreign bytes of its file.
    Returns, for "encode" and "decode", (profiled wall ms, mean host ms of
    each ``trpx.*`` range, device ms of each kernel and copy), all per
    chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.runtime import StreamingEncoder, iter_decode

    F = flat.shape[0]
    chunks = -(-F // C)
    path = workdir / "profiled.trpx"

    def encode():
        enc = StreamingEncoder(path, nvalues=flat.shape[1], dtype=flat.dtype,
                               dimensions=dims, device=dev)
        for lo in range(0, F, C):
            enc.add_frames(flat[lo : lo + C])
        enc.flush()
        return enc

    encode().finalize()
    raw = path.read_bytes()
    runs = {"encode": encode,
            "decode": lambda: _consume(iter_decode(
                TrpxArchive.from_bytes(raw), flat.dtype, C, device=dev),
                flat)}
    out = {}
    for run, fn in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / chunks
        if run == "encode":
            res.finalize()
        host: dict[str, float] = {}
        device: dict[str, float] = {}
        for e in prof.key_averages():
            if e.key.startswith("trpx.") and e.device_type == DeviceType.CPU:
                host[e.key[5:]] = e.cpu_time_total / 1e3 / chunks
            elif e.device_type == DeviceType.CUDA \
                    and not e.key.startswith("trpx."):
                k = _short(e.key)
                device[k] = device.get(k, 0.0) \
                    + e.self_device_time_total / 1e3 / chunks
        out[run] = (wall, host, device)
    return out


def _profile_layers(stack: np.ndarray, arch, dev, reps: int = 3):
    """Layers of the real path, from ``torch.profiler`` windows over `reps`
    compresses of `stack` and decompresses of an indexed and of a foreign
    (serial header walk) copy of `arch`. Returns (host, device): the mean
    host-clock ms of each ``trpx.*`` range of ``ops.coding`` (of the
    foreign decode only its walk and gather), and the device ms per call
    of each kernel and copy on the card, by short name."""
    import trpx_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trpx_tpu_torch.format.pycodec import TrpxArchive

    raw = arch.to_bytes()
    runs = {
        "encode": lambda: trpx_tpu_torch.compress(stack, device=dev),
        "decode": lambda: trpx_tpu_torch.decompress(TrpxArchive(
            meta=arch.meta, payload=arch.payload,
            frame_index=arch.frame_index), device=dev),
        "foreign": lambda: trpx_tpu_torch.decompress(
            TrpxArchive.from_bytes(raw), device=dev),
    }
    host: dict[str, float] = {}
    device: dict[str, float] = {}
    for run, fn in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.key.startswith("trpx.") and e.device_type == DeviceType.CPU:
                if run == "foreign":
                    if e.key in ("trpx.stream.walk", "trpx.stream.gather"):
                        host[f"{e.key[5:]} foreign"] = \
                            e.cpu_time_total / 1e3 / reps
                else:
                    host[e.key[5:]] = e.cpu_time_total / 1e3 / reps
            elif e.device_type == DeviceType.CUDA and run != "foreign" \
                    and not e.key.startswith("trpx."):
                name = f"{run} {_short(e.key)}"
                device[name] = device.get(name, 0.0) \
                    + e.self_device_time_total / 1e3 / reps
    return host, device


def _parallel_frames():
    """Phase 8's frames, made alike in every process from one seed:
    (PAR_MAIN, 512x512) u16 and (PAR_BIG, 2048x2048) u32."""
    rng = np.random.default_rng(SEED + 8)
    return (_frames(rng, PAR_MAIN, SIDE * SIDE),
            _frames(rng, PAR_BIG, BIG[0][0] ** 2, np.uint32,
                    hot_value=HOT_U32))


def _worker(mode: str, rank: int, world: int, port: int, workdir: str,
            device: str | None = None) -> int:
    """One rank of phase 8, on every card (``cuda:0`` on one) or on
    `device`, in a gloo group at localhost:`port`. ``shards``: drives (a)
    and (b), then the stream drill's first run, which rank 1 leaves with
    ``os._exit(3)`` after chunk 2's checkpoint (rank 0 exits too).
    ``resume``: the drill resumed and finalized. ``cards`` (phase 12(b),
    one card a rank): drives (a) and (b) only. Prints, as its last line,
    each drive's launch counters (set to 0 just before it) and wall
    seconds."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    import torch.distributed as dist
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.parallel import ShardedCodec
    from trpx_tpu_torch.parallel.distributed import (
        StreamingShardEncoder,
        init_from_env,
        write_run_manifest,
        write_shard_file,
    )

    if not init_from_env(timeout_s=WORKER_TIMEOUT_S):
        raise RuntimeError("no process group from the environment")
    work = Path(workdir)
    main_fr, big_fr = _parallel_frames()
    report = {}

    def drive(name, fn):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        report[name] = {"seconds": time.perf_counter() - t0,
                        "launches": _read_counts()}

    def shard_drive(name, frames, side):
        F = frames.shape[0]
        lo, hi = rank * F // world, (rank + 1) * F // world
        spec = FrameSpec.for_dtype(side * side, frames.dtype)
        # default devices: the card(s)
        codec = ShardedCodec(spec, None if device is None else [device])
        out = work / f"{name}.trpx"

        def run():
            res = codec.encode_shards(frames[lo:hi], F)
            write_shard_file(out, res, spec, F, (side, side))
            if rank == 0:
                write_run_manifest(out, res, spec, F, (side, side),
                                   dtype=frames.dtype)
        drive(name, run)

    if mode in ("shards", "cards"):
        shard_drive("a", main_fr, SIDE)
        shard_drive("b", big_fr, BIG[0][0])
    if mode == "cards":
        print(json.dumps(report), flush=True)
        dist.destroy_process_group()
        return 0
    codec = ShardedCodec(FrameSpec.for_dtype(SIDE * SIDE, np.uint16))
    F, C = main_fr.shape[0], PAR_CHUNK

    def stream():
        enc = StreamingShardEncoder(work / "c.trpx", codec, np.uint16,
                                    dimensions=(SIDE, SIDE))
        lo = enc.frames_done
        while lo < F:
            a, b = lo + rank * C // world, lo + (rank + 1) * C // world
            enc.add_chunk(main_fr[a:b], C)
            lo += C
            if mode == "shards" and lo == 2 * C:
                return
        enc.finalize()

    drive("c", stream)
    print(json.dumps(report), flush=True)
    if mode == "shards":
        # preempted right after chunk 2's checkpoint: rank 1 dies hard, the
        # others leave without a teardown
        os._exit(3 if rank == 1 else 0)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_workers(mode: str, workdir: Path, want_rcs,
                    devices=None) -> tuple:
    """Phase 8's `WORLD` workers of `mode` on a fresh port, with this
    process's environment (its cleaned ``CXX`` included), rank r on
    ``devices[r]`` if given; raises unless their exit codes are
    `want_rcs`. Returns (each rank's report, wall seconds of the
    launch)."""
    script = Path(__file__).resolve()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--worker", mode, str(r), str(WORLD),
         str(port), str(workdir)] + ([] if devices is None
                                     else [str(devices[r])]),
        cwd=script.parent, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rcs = tuple(p.returncode for p in procs)
    if rcs != tuple(want_rcs):
        raise AssertionError(
            f"phase 8 {mode} workers exited {rcs}, expected {want_rcs}:\n"
            + "\n".join(f"rank {r}: {o[-2000:]}\n{e[-4000:]}"
                        for r, (o, e) in enumerate(outs)))
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs], wall


def _expect_route(name: str, got: dict, want: set) -> None:
    """Raise unless the kernels in `want` launched and no other did."""
    if min((got[k] for k in want), default=1) < 1 or any(
            got[k] for k in got if k not in want):
        raise AssertionError(f"{name} took the wrong kernels: {got}, "
                             f"expected {sorted(want)}")


def _parallel_phase(dev, card: str, workdir: Path) -> dict:
    """Phase 8 (see the module docstring). Returns the launch counts of
    every drive, the workers' included."""
    from trpx_tpu_torch.io.trpx import read_trpx
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.parallel import decode_sharded
    from trpx_tpu_torch.parallel.distributed import recover_shard

    total = dict.fromkeys(_counters(), 0)
    main_fr, big_fr = _parallel_frames()
    side_big = BIG[0][0]
    frames = {"a": (main_fr, SIDE), "b": (big_fr, side_big),
              "c": (main_fr, SIDE)}
    want = {k: ncodec.encode(fr, dimensions=(s, s)).to_bytes()
            for k, (fr, s) in frames.items() if k != "c"}
    want["c"] = want["a"]
    # the pack each rank's shard takes: (a) 128 frames, (b) 2 frames of
    # 2048x2048, (c) 32 frames a chunk
    spec = {k: FrameSpec.for_dtype(s * s, fr.dtype)
            for k, (fr, s) in frames.items()}
    per_rank = {"a": PAR_MAIN // WORLD, "b": PAR_BIG // WORLD,
                "c": PAR_CHUNK // WORLD}
    route = {k: {_route(spec[k], per_rank[k])[0]} for k in frames}
    if route["b"] != {"pack_tiled"} or route["a"] != {"pack"}:
        raise AssertionError(f"phase 8 routes changed: {route}")

    def take(run, reports):
        for k, rep in reports[0].items():
            for r, ranks in enumerate(reports):
                _expect_route(f"phase 8 {run} drive {k} rank {r}",
                              ranks[k]["launches"], route[k])
                for kk, v in ranks[k]["launches"].items():
                    total[kk] += v

    reports, wall1 = _launch_workers("shards", workdir, (0, 3))
    take("first", reports)
    for k in ("a", "b"):
        if (workdir / f"{k}.trpx").read_bytes() != want[k]:
            raise AssertionError(f"phase 8 ({k}): the shared file differs "
                                 f"from the native codec's bytes")
    man = json.loads((workdir / "c.trpx.manifest").read_text())
    if man["frames_done"] != 2 * PAR_CHUNK or (workdir / "c.trpx").exists():
        raise AssertionError(f"phase 8 (c): manifest after the kill {man}")
    with open(workdir / "c.trpx.part", "r+b") as f:
        f.seek(man["payload_bytes"])
        f.write(b"\xde\xad" * 500_000)      # a torn tail past the checkpoint
    resumed, wall2 = _launch_workers("resume", workdir, (0, 0))
    take("resumed", resumed)
    if (workdir / "c.trpx").read_bytes() != want["c"]:
        raise AssertionError("phase 8 (c): the resumed stream differs from "
                             "the native codec's bytes")

    def walls(reps, k):
        return "/".join(f"{r[k]['seconds'] * 1e3:.1f}" for r in reps)

    print(f"phase 8 parallel ({card}; {WORLD} gloo processes time-slicing ONE "
          f"card, so no scaling figure): (a) {PAR_MAIN}x{SIDE}x{SIDE} u16 "
          f"encode_shards + write_shard_file, shared file == native codec, "
          f"ms per rank {walls(reports, 'a')}; (b) {PAR_BIG}x{side_big}x"
          f"{side_big} u32 (tiled pack per shard) == native, ms "
          f"{walls(reports, 'b')}; (c) StreamingShardEncoder {PAR_MAIN} "
          f"frames in {PAR_CHUNK}-frame chunks, rank 1 killed after chunk 2 "
          f"(ms {walls(reports, 'c')}), torn tail, resumed and finalized "
          f"(ms {walls(resumed, 'c')}) == native; worker launches of "
          f"{wall1:.1f} s and {wall2:.1f} s wall; launches "
          + "; ".join(f"{k} rank {r} {rep[k]['launches']}"
                      for k in ("a", "b") for r, rep in enumerate(reports)),
          flush=True)
    # (d) recover_shard of a zeroed back half, in this process on the card
    src = workdir / "a.trpx"
    out = workdir / "d.trpx"
    shutil.copy(Path(f"{src}.runmanifest"), Path(f"{out}.runmanifest"))
    blob = bytearray(want["a"])
    sizes = json.loads(Path(f"{out}.runmanifest").read_text())["nbytes"]
    lo = PAR_MAIN // 2
    start = len(blob) - sum(sizes) + sum(sizes[:lo])
    blob[start:] = bytes(len(blob) - start)
    out.write_bytes(bytes(blob))
    _zero_counts()
    t0 = time.perf_counter()
    recover_shard(out, main_fr[lo:], lo)
    t_rec = time.perf_counter() - t0
    got = _read_counts()
    _expect_route("phase 8 recover_shard", got,
                  {_route(spec["a"], PAR_MAIN - lo)[0]})
    for k, v in got.items():
        total[k] += v
    if out.read_bytes() != want["a"]:
        raise AssertionError("phase 8 (d): recover_shard did not restore "
                             "the native codec's bytes")
    # (e) decode_sharded of both files on the card
    msg = []
    for k in ("a", "b"):
        fr, s = frames[k]
        arch = read_trpx(workdir / f"{k}.trpx")
        _zero_counts()
        t0 = time.perf_counter()
        back = decode_sharded(arch, fr.dtype)
        t_dec = time.perf_counter() - t0
        got = _read_counts()
        _expect_route(f"phase 8 decode_sharded ({k})", got,
                      {_route(spec[k], fr.shape[0])[1]})
        for kk, v in got.items():
            total[kk] += v
        if back.shape != fr.shape or not np.array_equal(back, fr):
            raise AssertionError(f"phase 8 (e): decode_sharded of ({k}) "
                                 f"lost pixels")
        msg.append(f"{fr.shape[0]}x{s}x{s} {fr.dtype} {t_dec * 1e3:.1f} ms "
                   f"{got}")
    print(f"phase 8 in this process ({card}): (d) recover_shard of frames "
          f"{lo}-{PAR_MAIN - 1} == native, {t_rec * 1e3:.1f} ms; (e) "
          f"decode_sharded lossless: " + ", ".join(msg), flush=True)
    return total


def _cli_phase(rng, card: str, workdir: Path) -> dict:
    """Phase 9 (see the module docstring). Returns the launch counts of
    its steps."""
    import contextlib
    import io

    from trpx_tpu_torch.cli.main import main as cli
    from trpx_tpu_torch.io import read_tiff, write_tiff
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec

    total = dict.fromkeys(_counters(), 0)
    side_big = BIG[0][0]
    stacks = {
        "m512": _frames(rng, 64, SIDE * SIDE).reshape(64, SIDE, SIDE),
        "m2048": _frames(rng, 4, side_big ** 2, np.uint32,
                         hot_value=HOT_U32).reshape(4, side_big, side_big)}
    want = {}
    for name, st in stacks.items():
        write_tiff(st, workdir / f"{name}.tif")
        F, h, w = st.shape
        want[name] = ncodec.encode(st.reshape(F, -1),
                                   dimensions=(w, h)).to_bytes()
    specs = {name: FrameSpec.for_dtype(st.shape[1] * st.shape[2], st.dtype)
             for name, st in stacks.items()}
    tifs = [str(workdir / f"{n}.tif") for n in stacks]

    def run(step, argv, routes):
        """One CLI call with the counters set to 0 just before and read
        just after; raises on a nonzero exit or any error line."""
        _zero_counts()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(argv)
        wall = time.perf_counter() - t0
        got = _read_counts()
        if rc != 0 or err.getvalue():
            raise AssertionError(f"phase 9 {step}: rc {rc}\n{out.getvalue()}"
                                 f"\n{err.getvalue()}")
        _expect_route(f"phase 9 {step}", got, routes)
        for k, v in got.items():
            total[k] += v
        return wall, got, out.getvalue()

    def check_outputs(step, d, suffix):
        for name, st in stacks.items():
            p = d / f"{name}{suffix}"
            if suffix == ".trpx":
                ok = p.read_bytes() == want[name]
            else:
                back = read_tiff(p).as_array()
                ok = back.dtype == st.dtype and np.array_equal(back, st)
            if not ok:
                raise AssertionError(f"phase 9 {step}: {p.name} differs")

    packs = {_route(s, F)[0] for s, F in ((specs["m512"], 64),
                                          (specs["m2048"], 4))}
    unpacks = {_route(s, F)[1] for s, F in ((specs["m512"], 64),
                                            (specs["m2048"], 4))}
    C = 32
    s_packs = {_route(specs["m512"], C)[0], _route(specs["m2048"], 4)[0]}
    s_unpacks = {_route(specs["m512"], C)[1], _route(specs["m2048"], 4)[1]}
    lines = []
    for step, argv, routes, d, suffix in (
            ("encode", ["encode", *tifs, "--out-dir", "enc"], packs, "enc",
             ".trpx"),
            ("decode", ["decode", *(str(workdir / "enc" / f"{n}.trpx")
                                    for n in stacks), "--out-dir", "dec"],
             unpacks, "dec", ".tif"),
            ("encode --stream", ["encode", *tifs, "--stream",
                                 "--chunk-frames", str(C), "--out-dir",
                                 "senc"], s_packs, "senc", ".trpx"),
            ("decode --stream", ["decode", *(str(workdir / "senc" / f"{n}"
                                                 ".trpx") for n in stacks),
                                 "--stream", "--chunk-frames", str(C),
                                 "--out-dir", "sdec"], s_unpacks, "sdec",
             ".tif")):
        argv = [str(workdir / a) if a in ("enc", "dec", "senc", "sdec")
                else a for a in argv]
        wall, got, _ = run(step, argv, routes)
        check_outputs(step, workdir / d, suffix)
        lines.append(f"{step} {wall * 1e3:.1f} ms {got}")
    trpx = [str(workdir / "enc" / f"{n}.trpx") for n in stacks]
    _, _, text = run("verify", ["verify", *trpx], set())
    if text.count(": OK") != len(trpx):
        raise AssertionError(f"phase 9 verify: {text}")
    _, _, text = run("info", ["info", *trpx], set())
    if f"frames           {stacks['m512'].shape[0]}" not in text:
        raise AssertionError(f"phase 9 info: {text}")
    spec = FrameSpec.for_dtype(SIDE * SIDE, np.uint16)
    wall, got, text = run("bench", ["bench", "--frames", "64", "--e2e"],
                          {_route(spec, 1)[0], _route(spec, 64)[0],
                           _route(spec, 64)[1]})
    print(f"phase 9 CLI ({card}; in process, default device): "
          f"{'; '.join(lines)}; outputs == native codec bytes / the input "
          f"pixels; verify and info ok; bench {wall:.2f} s {got}:",
          flush=True)
    print(text.rstrip(), flush=True)
    return total


def _bench_phase(dev, card: str) -> None:
    """Phase 10(a): the bench at its full batches (``BENCH_DISTINCT``
    batches, ``BENCH_REPS`` calls on each), its launches checked against
    its routes."""
    from trpx_tpu_torch import bench
    from trpx_tpu_torch.ops import FrameSpec

    _zero_counts()
    t0 = time.perf_counter()
    r512 = bench.bench_512(512, BENCH_REPS, n2=BENCH_DISTINCT)
    big = {edge: bench.bench_big(BENCH_REPS, edge, F, n2=BENCH_DISTINCT)
           for edge, F, _ref in bench.BIG}
    wall = time.perf_counter() - t0
    got = _read_counts()
    # the routes of each configuration's batches, and the tiled unpack of
    # the pipelined decode's chunks (128, 8 and 2 frames)
    configs = [(512, np.uint16, 512)] + [(e, np.uint32, F)
                                         for e, F, _ in bench.BIG]
    want = {"unpack_tiled"}.union(*(
        _route(FrameSpec.for_dtype(e * e, dt), F) for e, dt, F in configs))
    _expect_route("phase 10(a) bench", got, want)
    summary = bench.summary(r512, big)
    for name, r in (("512x512 u16", r512),
                    *((f"{e}x{e} u32", big[e]) for e in big)):
        print(f"phase 10(a) {bench.describe(name, r, dev)}", flush=True)
    print(f"phase 10(a) bench ({BENCH_DISTINCT} distinct batches, "
          f"{BENCH_REPS} reps; guards passed: archives == native codec, "
          f"decodes == frames) {wall:.1f} s, launches {got}; card, then "
          f"its JSON:", flush=True)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)


def _campaign_phase(dev) -> dict:
    """Phase 10(b): the differential campaign's smoke tier on the default
    device, each row's counters against its route. Returns the launch
    counts of all rows."""
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.tools import differential_campaign as camp

    total = dict.fromkeys(_counters(), 0)
    routes = [_route(FrameSpec.for_dtype(r[2], r[0], r[3]), r[1])
              for r in camp.ROUTE_TRIALS]
    if routes != [("pack_tiled", "unpack_tiled")] * 3 + [
            ("pack", "unpack_tiled"), ("pack", "unpack_tiled"),
            ("pack", "unpack")]:
        raise AssertionError(f"phase 10(b): the route rows no longer "
                             f"straddle the routes: {routes}")
    t0 = time.perf_counter()
    lines = []
    for row in camp.SMOKE_TRIALS + camp.ROUTE_TRIALS:
        vals, block = camp.smoke_values(row)
        F, n = vals.shape
        name = f"{F}x{n} {vals.dtype} b{block} k{row[4]} seed {row[5]}"
        spec = FrameSpec.for_dtype(n, vals.dtype, block)
        _zero_counts()
        r0 = time.perf_counter()
        camp.run_trial(vals, block, dev)
        got = _read_counts()
        _expect_route(f"phase 10(b) {name}", got, set(_route(spec, F)))
        for k, v in got.items():
            total[k] += v
        lines.append(f"{name} {time.perf_counter() - r0:.1f} s "
                     f"{'+'.join(_route(spec, F))}")
    print(f"phase 10(b) campaign smoke tier on {dev}: "
          f"{len(camp.SMOKE_TRIALS)} smoke rows + {len(camp.ROUTE_TRIALS)} "
          f"route rows byte for byte (pycodec up to "
          f"{camp.PYCODEC_MAX_VALUES:,} values, the native codec on all), "
          f"lossless, each row on its route, {time.perf_counter() - t0:.1f} "
          f"s, launches {total}: " + "; ".join(lines), flush=True)
    return total


def _entry_phase(dev) -> dict:
    """Phase 10(c): ``entry()``'s pack against ``encode_batch_plain``,
    then ``dryrun_multichip(2)`` on the card. Returns the launch counts,
    the ranks' included."""
    from trpx_tpu_torch.graft_entry import dryrun_multichip, entry
    from trpx_tpu_torch.ops import FrameSpec, encode_batch_plain
    from trpx_tpu_torch.ops.cuda_pack import stream_words

    spec = FrameSpec.for_dtype(512 * 512, np.uint16)
    _zero_counts()
    fn, (frames,) = entry()
    words, bits, maxw = fn(frames)
    got = _read_counts()
    _expect_route("phase 10(c) entry", got, {_route(spec, len(frames))[0]})
    pw, pb, pm = encode_batch_plain(spec, frames)
    e = max(_diff(stream_words(words, bits), pw), _diff(bits, pb),
            _diff(maxw, pm))
    if e or frames.device.type != "cuda":
        raise AssertionError(f"phase 10(c): entry()'s pack != plain (max abs "
                             f"err {e}) or off the card ({frames.device})")
    total = dict(got)
    t0 = time.perf_counter()
    ranks = dryrun_multichip(2)
    wall = time.perf_counter() - t0
    for r in ranks:
        # shard encodes of 3-5 tiny frames, their sharded decodes, and the
        # tiled check's explicit tiled pack and unpack
        _expect_route(f"phase 10(c) dryrun rank {r['rank']}", r["launches"],
                      {"pack", "pack_tiled", "unpack_tiled"})
        for k, v in r["launches"].items():
            total[k] += v
    print(f"phase 10(c) entry(): {tuple(frames.shape)} {frames.dtype} on "
          f"{frames.device}, pack == encode_batch_plain on the defined words "
          f"(exact), launches {got}; dryrun_multichip(2) on cuda:0 passed in "
          f"{wall:.1f} s, rank launches "
          + "; ".join(f"{r['rank']}: {r['launches']}" for r in ranks),
          flush=True)
    return total


def _scaling_phase() -> None:
    """Phase 10(d): the scaling tool on every card (whole
    ``encode_shards`` steps), its launches checked against its route; with
    one card a null efficiency."""
    from trpx_tpu_torch.parallel import default_devices
    from trpx_tpu_torch.tools import scaling

    devices = default_devices()
    _zero_counts()
    res = scaling.run(devices)
    got = _read_counts()
    _expect_route("phase 10(d) scaling", got, {"pack"})
    if len(devices) == 1 and (res["scaling_efficiency"] is not None
                              or res.get("reason") != "one card"):
        raise AssertionError(f"phase 10(d): one card, but {res}")
    print(f"phase 10(d) scaling ({len(devices)} card(s)), launches {got}: "
          f"{json.dumps(res)}", flush=True)


def hostile_corpus(base: bytes, garbage: bool = False) -> list:
    """(kind, blob) mutations of the archive `base` with the seeds of
    tests/test_fuzz_decode.py: 120 payload byte flips (seed 0), 46
    truncations (seed 1), 15 header attribute tamperings, and 64 bursts of
    8-64 corrupt bytes (seeds 0-3, 16 each); with `garbage`, its random
    blobs (seed 2) too. tests/test_torch_fuzz_decode.py holds the flips,
    truncations and tamperings of its base archive to these."""
    from trpx_tpu_torch.format.pycodec import TrpxArchive

    hdr_end = base.index(b"/>") + 2
    out = []
    rng = np.random.default_rng(0)
    for _ in range(120):
        blob = bytearray(base)
        i = int(rng.integers(hdr_end, len(blob)))
        blob[i] ^= int(rng.integers(1, 256))
        out.append(("flip", bytes(blob)))
    rng = np.random.default_rng(1)
    cuts = set(int(rng.integers(0, len(base))) for _ in range(40))
    cuts |= {0, 1, hdr_end - 1, hdr_end, hdr_end + 1, len(base) - 1}
    out += [("truncation", base[:cut]) for cut in sorted(cuts)]
    meta = TrpxArchive.from_bytes(base).meta
    hdr, payload = base[:hdr_end].decode("latin1"), base[hdr_end:]

    def attr(name, old, new):
        return hdr.replace(f'{name}="{old}"', f'{name}="{new}"')

    n, F = meta.number_of_values, meta.number_of_frames
    tampered = [
        attr("number_of_values", n, 100 * n), attr("number_of_values", n, 0),
        attr("number_of_values", n, -5),
        attr("number_of_frames", F, 1_000_000),
        attr("number_of_frames", F, 0),
        attr("block", meta.block, 0), attr("block", meta.block, -1),
        attr("block", meta.block, 1_000_000_000),
        attr("prolix_bits", meta.prolix_bits, 200),
        attr("prolix_bits", meta.prolix_bits, -3),
        attr("signed", int(meta.signed), 1 - int(meta.signed)),
        *(attr("memory_size", len(payload), v)
          for v in (0, 1, len(payload) * 100, -1))]
    out += [("tamper", h.encode("latin1") + payload) for h in tampered]
    for seed in range(4):
        rng = np.random.default_rng(seed)
        for _ in range(16):
            blob = bytearray(base)
            start = int(rng.integers(hdr_end, len(blob) - 64))
            ln = int(rng.integers(8, 64))
            blob[start:start + ln] = rng.integers(
                0, 256, size=ln, dtype=np.uint8).tobytes()
            out.append(("burst", bytes(blob)))
    if garbage:
        rng = np.random.default_rng(2)
        out += [("garbage", rng.integers(0, 256, size=size,
                                         dtype=np.uint8).tobytes())
                for size in (0, 1, 7, 100, 4096)]
        out.append(("garbage", (
            b'<Terse prolix_bits="16" signed="0" block="12" '
            b'memory_size="512" number_of_values="1000" '
            b'number_of_frames="2"/>'
            + rng.integers(0, 256, size=512, dtype=np.uint8).tobytes())))
    return out


def _frame_starts(base: bytes) -> np.ndarray:
    """The byte offset of every frame of the archive `base` in its
    payload, and the payload's end, from the native walk."""
    from trpx_tpu_torch import native
    from trpx_tpu_torch.format.pycodec import TrpxArchive

    arch = TrpxArchive.from_bytes(base)
    meta = arch.meta
    return native.walk(arch.payload, meta.number_of_frames,
                       meta.number_of_values, meta.block,
                       want_poffs=False)[2]


def _truncated(base: bytes, cut: int) -> bytes:
    """The archive `base` with its payload cut at byte `cut` and its
    header's memory_size set to match: a stream that ends early."""
    hdr_end = base.index(b"/>") + 2
    hdr = base[:hdr_end].decode("latin1")
    size = len(base) - hdr_end
    hdr = hdr.replace(f'memory_size="{size}"', f'memory_size="{cut}"')
    return hdr.encode("latin1") + base[hdr_end:hdr_end + cut]


def pipeline_corpus(base: bytes, chunk: int = PIPE_CHUNK) -> list:
    """(kind, blob) mutations of the archive `base` past its first chunk of
    `chunk` frames, where the pipelined decode has that chunk's copies and
    unpack in flight, with the seeds of :func:`hostile_corpus`: 120 byte
    flips (seed 0) in the payload of frames `chunk` and later; 46
    truncations (seed 1: 40 cuts, and the first two bytes of chunks 2 and
    3 and the payload's last byte) inside chunks 2 and 3, each with the
    header's memory_size set to the cut, so that the stream ends there and
    the decode meets the end inside a chunk; 64 bursts of 8-64 corrupt
    bytes (seeds 0-3, 16 each) past the first chunk. The frame offsets
    come from the base's native walk."""
    hdr_end = base.index(b"/>") + 2
    starts = _frame_starts(base)
    size, F = int(starts[-1]), len(starts) - 1
    lo = int(starts[chunk])          # the second chunk's first byte
    out = []
    rng = np.random.default_rng(0)
    for _ in range(120):
        blob = bytearray(base)
        i = int(rng.integers(hdr_end + lo, len(blob)))
        blob[i] ^= int(rng.integers(1, 256))
        out.append(("flip", bytes(blob)))
    rng = np.random.default_rng(1)
    cuts = set(int(rng.integers(lo, size)) for _ in range(40))
    cuts |= {lo, lo + 1, size - 1}
    if F > 2 * chunk:
        third = int(starts[2 * chunk])
        cuts |= {third, third + 1}
    out += [("truncation", _truncated(base, cut)) for cut in sorted(cuts)]
    for seed in range(4):
        rng = np.random.default_rng(seed)
        for _ in range(16):
            blob = bytearray(base)
            start = int(rng.integers(hdr_end + lo, len(blob) - 64))
            ln = int(rng.integers(8, 64))
            blob[start:start + ln] = rng.integers(
                0, 256, size=ln, dtype=np.uint8).tobytes()
            out.append(("burst", bytes(blob)))
    return out


def _outcome(fn):
    """The clean exception class a call raised, or its output."""
    try:
        return np.asarray(fn())
    except OK_ERRORS as e:
        return type(e)


def _digest(outcome) -> str:
    """An outcome of :func:`_outcome` as a string: the exception class's
    name, or the output's dtype, shape and SHA-256."""
    import hashlib

    if isinstance(outcome, type):
        return outcome.__name__
    a = np.ascontiguousarray(outcome)
    return (f"{a.dtype.str}{a.shape} "
            f"{hashlib.sha256(a.tobytes()).hexdigest()}")


def _decode_routes(spec, frames: int) -> set:
    """The unpacks ``decompress`` launches on `frames` such frames: one
    batch, or the pipelined decode's chunks above PIPE_CHUNK frames."""
    if frames <= PIPE_CHUNK:
        return {_route(spec, frames)[1]}
    return {_route(spec, min(PIPE_CHUNK, frames - lo))[1]
            for lo in range(0, frames, PIPE_CHUNK)}


def _hostile_base(F: int, n: int, seed: int):
    """A base archive of the corpus: (F, n) u16 Poisson(3) frames with 20
    hot pixels a frame at 65535, from `seed`, and their native encoding."""
    from trpx_tpu_torch.native import codec as ncodec

    rng = np.random.default_rng(seed)
    stack = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 20)] = 65535     # hot pixels
    return stack, ncodec.encode(stack).to_bytes()


def pipeline_cases(stack: np.ndarray, base: bytes, workdir: Path) -> list:
    """Phase 11(a)'s hostile cases of the pipelined decode besides the
    corpus, on the base archive `base` of the frames `stack` (more than
    PIPE_CHUNK frames), each on the card with its launches on the routes:
    (1) two sidecars that pass every load-time gate but disagree with the
    stream (a width in a frame of chunk 2, the offsets of chunk 3 shifted
    a byte) through ``decompress(path)``: exact pixels and exactly one
    RuntimeWarning at site ``stream.sidecar_tables`` each; (2)
    ``iter_decode(fetch=False)`` of the base cut inside chunk 2: chunk 1 a
    device tensor equal to the plain versions' chunk 1, then the plain
    versions' exception class; (3) ABANDONED pipelines closed after their
    first chunk (chunk 2's copies and unpack in flight, its pinned buffers
    and side-stream output freed), then a clean decode, exact. Returns an
    outcome string per case."""
    import warnings

    import trpx_tpu_torch
    from trpx_tpu_torch import _fallback, api
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.io.trpx import read_trpx, write_index, write_trpx
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.runtime import iter_decode

    F, n = stack.shape
    spec = FrameSpec.for_dtype(n, np.uint16)
    arch = TrpxArchive.from_bytes(base)
    out = []
    # (1) sidecars that disagree with the stream
    path = workdir / "pipeline.trpx"
    write_trpx(arch, path, index=True)
    good = read_trpx(path)
    for kind in ("width", "offsets"):
        offs = np.asarray(good.frame_index).copy()
        widths = np.asarray(good.width_table).copy()
        if kind == "width":        # a frame of chunk 2
            widths[PIPE_CHUNK + 44, 3] = 6 if widths[PIPE_CHUNK + 44,
                                                     3] != 6 else 5
        else:                      # chunk 3 starts a byte late
            offs[2 * PIPE_CHUNK:] += 1
        write_index(path, offs, arch.meta.memory_size, widths=widths)
        if read_trpx(path).width_table is None:
            raise AssertionError(f"phase 11(a) sidecar ({kind}): a "
                                 f"load-time gate refused it")
        _fallback._seen.discard("stream.sidecar_tables")
        _zero_counts()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = trpx_tpu_torch.decompress(path)
        said = [w for w in rec if issubclass(w.category, RuntimeWarning)
                and "fallback at stream.sidecar_tables" in str(w.message)]
        if got.dtype != stack.dtype or not np.array_equal(got, stack):
            raise AssertionError(f"phase 11(a) sidecar ({kind}): the "
                                 f"decode is not exact")
        if len(said) != 1:
            raise AssertionError(f"phase 11(a) sidecar ({kind}): "
                                 f"{len(said)} warnings at "
                                 f"stream.sidecar_tables, expected 1")
        _expect_route(f"phase 11(a) sidecar ({kind})", _read_counts(),
                      _decode_routes(spec, F))
        out.append(f"sidecar {kind}: exact, 1 warning")
    # (2) fetch=False through a stream that ends inside chunk 2, then
    # inside chunk 3. The walk of chunk k + 1 precedes the yield of chunk
    # k (in both packages), so the first fails before chunk 1 is yielded;
    # the second yields chunk 1, then fails with chunk 2's unpack in
    # flight
    starts = _frame_starts(base)
    for k in (2, 3):
        blob = _truncated(base, int(starts[(k - 1) * PIPE_CHUNK]) + 1)
        _zero_counts()
        card = iter_decode(blob, np.uint16, PIPE_CHUNK, fetch=False)
        plain = iter_decode(blob, np.uint16, PIPE_CHUNK, device="cpu",
                            fetch=False)
        said = "before chunk 1, "
        if k == 3:
            (got, nf), (want, wnf) = next(card), next(plain)
            on_default = got.device.type == api._torch_device(None).type
            if not (on_default and nf == wnf
                    and torch.equal(got.cpu(), want)):
                raise AssertionError("phase 11(a) fetch=False: chunk 1 "
                                     "differs from the plain versions'")
            said = "chunk 1 exact, chunk 2 "
        after = _outcome(lambda: next(card)), _outcome(lambda: next(plain))
        if not isinstance(after[0], type) or after[0] is not after[1]:
            raise AssertionError(f"phase 11(a) fetch=False, cut in chunk "
                                 f"{k}: the card gave {after[0]}, the "
                                 f"plain versions {after[1]}")
        _expect_route(f"phase 11(a) fetch=False, cut in chunk {k}",
                      _read_counts(), {"unpack"})
        out.append(f"fetch=False cut in chunk {k}: {said}"
                   f"{after[0].__name__}")
    # (3) pipelines abandoned with chunk 2 in flight
    _zero_counts()
    for _ in range(ABANDONED):
        gen = iter_decode(base, np.uint16, PIPE_CHUNK)
        first = next(gen)
        gen.close()
        if not np.array_equal(first, stack[:PIPE_CHUNK]):
            raise AssertionError("phase 11(a) abandoned: chunk 1 differs")
    got = trpx_tpu_torch.decompress(base)
    if not np.array_equal(got, stack):
        raise AssertionError("phase 11(a) abandoned: the clean decode "
                             "after them differs")
    _expect_route("phase 11(a) abandoned", _read_counts(),
                  _decode_routes(spec, F))
    out.append(f"{ABANDONED} abandoned: the next decode exact")
    return out


def hostile_phase(card: str, workdir: Path | None = None,
                  expect: list | None = None) -> list:
    """Phase 11(a): the hostile corpus of each base archive through the
    public ``decompress`` at its default device; every outcome equals
    ``decompress(blob, device="cpu")``'s (``device=False``'s where the
    default routes the stream to the host codec), or with `expect` (the
    outcome strings of an earlier run) equals that run's instead; launches
    on the routes ``FrameSpec`` gives the decoded mutations; on the third
    base, :func:`pipeline_cases` too (in `workdir`, else a temporary
    directory); then the context is healthy. Returns the outcome strings.
    Its launches are not traffic: checked, not counted."""
    import warnings

    import trpx_tpu_torch
    from trpx_tpu_torch import api
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.ops import FrameSpec

    msgs, digests = [], []
    for (F, n), seed in zip(HOSTILE_BASES, (7, SEED + 11, SEED + 14)):
        stack, base = _hostile_base(F, n, seed)
        corpus = (hostile_corpus(base, garbage=F == HOSTILE_BASES[0][0])
                  if F <= PIPE_CHUNK else pipeline_corpus(base))
        counts: dict[str, int] = {}
        routes: set = set()
        on_card = 0
        t0 = time.perf_counter()
        _zero_counts()
        for kind, blob in corpus:
            try:
                meta = TrpxArchive.from_bytes(blob).meta
                dtype = api.output_dtype(meta)
                kernel = api._decode_ok(meta, dtype)
            except OK_ERRORS:
                kernel, meta = True, None
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = _outcome(lambda: trpx_tpu_torch.decompress(blob))
                if expect is None:
                    want = _digest(_outcome(lambda: trpx_tpu_torch.decompress(
                        blob, device="cpu" if kernel else False)))
                else:
                    want = expect[len(digests)]
            digests.append(_digest(got))
            if digests[-1] != want:
                raise AssertionError(
                    f"phase 11(a) {F}x{n} {kind}: the card gave "
                    f"{digests[-1]}, "
                    + ("the plain versions" if expect is None
                       else "the normal build") + f" {want}")
            key = got.__name__ if isinstance(got, type) else "decoded"
            counts[key] = counts.get(key, 0) + 1
            if kernel and not isinstance(got, type):
                on_card += 1
                spec = FrameSpec.for_dtype(meta.number_of_values, dtype,
                                           meta.block)
                routes |= _decode_routes(spec, meta.number_of_frames)
        got = _read_counts()
        _expect_route(f"phase 11(a) {F}x{n}", got, routes)
        msgs.append(f"{F}x{n} u16 base ({'+'.join(sorted(routes))}): "
                    f"{len(corpus)} mutations "
                    + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
                    + f" ({on_card} decoded on the card), launches {got}, "
                    f"{time.perf_counter() - t0:.1f} s")
        if F > PIPE_CHUNK:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=workdir) as d:
                cases = pipeline_cases(stack, base, Path(d))
            if expect is not None and cases != expect[len(digests):][
                    :len(cases)]:
                raise AssertionError(f"phase 11(a) pipeline cases: {cases}, "
                                     f"the normal build's differ")
            digests += cases
            msgs.append("; ".join(cases)
                        + f", {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    rng = np.random.default_rng(SEED + 12)
    r = _drive(_frames(rng, F_MAIN, SIDE * SIDE).reshape(F_MAIN, SIDE, SIDE))
    print(f"phase 11(a) hostile corpus through decompress on {card}, each "
          f"outcome == the "
          + ("plain versions'" if expect is None else "normal build's")
          + " (the same clean error class or equal pixels): "
          + "; ".join(msgs) + f"; then synchronize and a clean "
          f"{F_MAIN}x{SIDE}x{SIDE} round trip, launches {r['launches']}: "
          f"context healthy", flush=True)
    return digests


def race_drill(dev, card: str, calls: int = RACE_CALLS) -> None:
    """Phase 11(b): RACE_THREADS host threads launch at once (the ctypes
    launchers release the GIL), each taking in turn both unpacks of u8,
    u16, i16 and i32 batches (u8 and u16 share each unpack's unsigned
    16-bit instance, i16 and i32 its signed one, at different
    shared-memory sizes), both packs of u8 and u16 frames, and all four
    kernels on u32 frames in blocks of 3, 64 and 512 values (each kernel's
    generic-block instance, at sizes on both sides of the 48 KB a CTA gets
    without opting in), `calls` calls a thread; every result exact.
    Launches checked, not counted. Once one thread could lower a shared
    instance's shared-memory limit between another's lookup and launch
    (csrc/tile.cuh ``Residency``)."""
    import functools
    import threading

    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import (
        FrameSpec,
        decode_batch,
        decode_batch_tiled,
        decoded_dtype,
        encode_batch,
        encode_batch_plain,
        encode_batch_tiled,
        walk_archive,
    )
    from trpx_tpu_torch.ops.staging import Staging, upload
    from trpx_tpu_torch.ops.cuda_pack import stream_words

    rng = np.random.default_rng(SEED + 13)
    n = 20_000
    jobs = []
    packs = []
    for dt, block in ((np.uint8, 12), (np.uint16, 12), (np.int16, 12),
                      (np.int32, 12), (np.uint32, 3), (np.uint32, 64),
                      (np.uint32, 512)):
        fr = _signed_frames(rng, 4, n, dt) if np.iinfo(dt).min < 0 \
            else _frames(rng, 4, n, dt, hot=20)
        spec = FrameSpec.for_dtype(n, dt, block)
        name = f"{np.dtype(dt).name} block {block}"
        widths, words = walk_archive(ncodec.encode(fr, block=block), spec)
        wd = torch.from_numpy(widths).to(dev)
        wo = torch.from_numpy(words.view(np.int32)).to(dev)
        # the unpacks' output: u8's and u16's own lanes, else the int32
        # bits
        lanes = {torch.uint8: np.uint8, torch.uint16: np.uint16}.get(
            decoded_dtype(spec), np.int32)
        want = torch.from_numpy(fr.astype(np.int64).astype(lanes))
        want = want.to(dev)
        for fn in (decode_batch, decode_batch_tiled):
            jobs.append((f"{fn.__name__} {name}",
                         functools.partial(fn, spec, wo, wd,
                                           decoded_dtype(spec)), want))
        if dt in (np.uint8, np.uint16, np.uint32):
            x = upload(Staging(), "x", fr, spec.n_padded,
                       spec.torch_dtype, dev)
            want = encode_batch_plain(spec, x)
            for fn in (encode_batch, encode_batch_tiled):
                packs.append((f"{fn.__name__} {name}",
                              functools.partial(fn, spec, x), want))

    def right(got, want) -> bool:
        if isinstance(got, tuple):
            return (torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                                 want[2])
                    and torch.equal(stream_words(got[0], got[1]), want[0]))
        if got.dtype == torch.uint16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        return torch.equal(got, want)

    jobs += packs
    failures = []
    done = [0] * RACE_THREADS

    def run(k):
        try:
            for i in range(calls):
                name, call, want = jobs[(i + 3 * k) % len(jobs)]
                if not right(call(), want):
                    failures.append(f"thread {k} call {i}: {name} differs")
                done[k] += 1
        except Exception as e:   # reported below with the thread
            failures.append(f"thread {k}: {type(e).__name__}: {e}")

    _zero_counts()
    threads = [threading.Thread(target=run, args=(k,))
               for k in range(RACE_THREADS)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("phase 11(b): a drill thread did not finish")
    torch.cuda.synchronize()
    if failures or done != [calls] * RACE_THREADS:
        raise AssertionError(f"phase 11(b): calls done {done}, "
                             f"{len(failures)} failures: "
                             + "; ".join(failures[:5]))
    got = _read_counts()
    _expect_route("phase 11(b) race drill", got, set(_counters()))
    print(f"phase 11(b) race drill on {card}: {RACE_THREADS} threads x "
          f"{calls} calls over {len(jobs)} kernel calls (both unpacks "
          f"of u8/u16/i16/i32, both packs of u8/u16, all four kernels on "
          f"u32 in blocks of 3/64/512), every result exact, "
          f"{wall:.1f} s, launches {got}", flush=True)


def _selftest_line() -> int:
    """The line of ``csrc/pack.cu`` whose TRPX_CHECK the checked
    library's self-test trips."""
    from trpx_tpu_torch import _build

    lines = (_build.CSRC / "pack.cu").read_text().splitlines()
    return 1 + next(i for i, line in enumerate(lines)
                    if "trpx_checked_selftest trips this line" in line)


def _checked_selftest() -> int:
    """``chip_smoke.py --checked-selftest``: loads the bounds-checked
    library and runs its self-test, whose TRPX_CHECK fails and leaves the
    context unusable. Exits 0 only if the self-test returned no error,
    which means that the asserts were not compiled in."""
    import ctypes

    from trpx_tpu_torch import _build

    _build.select_checked()
    lib = _build.load()
    rc = lib.trpx_checked_selftest(0)
    print(f"trpx_checked_selftest returned {rc} "
          f"({lib.trpx_cuda_error_string(rc).decode()})", flush=True)
    ctypes.CDLL(None).fflush(None)   # the device assert's message
    return 0 if rc == 0 else 3


def _checked_child(expect_path: str, workdir: str) -> int:
    """``chip_smoke.py --checked EXPECT WORKDIR``: phase 11(d) in a process
    of its own, on the bounds-checked build: the self-test in a
    grandchild, which must fail and name its line; phase 11(a)'s three
    bases and pipeline cases, each outcome equal to the normal build's
    (EXPECT, a JSON list of hostile_phase's outcome strings); the
    hostile tables of tests/test_torch_cuda.py; the race drill at
    CHECKED_RACE_CALLS calls a thread. A TRPX_CHECK that fails prints its
    file, line and thread and makes the next CUDA call raise, so this
    process exits non-zero. Prints the phase's times as its last line."""
    import importlib.util

    from trpx_tpu_torch import _build

    t0 = time.perf_counter()
    _build.select_checked()
    so = _build.build(checked=True)
    _build.load()
    t_load = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    card = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--checked-selftest"], capture_output=True,
                       text=True, timeout=300)
    said = r.stdout + r.stderr
    where = f"pack.cu:{_selftest_line()}"
    if r.returncode == 0 or where not in said or "Assertion" not in said:
        raise AssertionError(f"phase 11(d): the self-test exited "
                             f"{r.returncode} without an assert at {where}:"
                             f"\n{said[-3000:]}")
    named = next(line for line in said.splitlines() if where in line)
    t_self = time.perf_counter() - t
    t = time.perf_counter()
    expect = json.loads(Path(expect_path).read_text())
    got = hostile_phase(card, Path(workdir), expect=expect)
    t_corpus = time.perf_counter() - t
    t = time.perf_counter()
    tests = Path(__file__).resolve().parent / "tests"
    sys.path.insert(0, str(tests))     # its helpers beside it
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", tests / "test_torch_cuda.py")
    cards = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cards)
    for dt in (np.uint16, np.uint8, np.int32):
        cards.test_unpack_kernels_on_hostile_tables(dev, dt)
    t_tables = time.perf_counter() - t
    t = time.perf_counter()
    race_drill(dev, card, calls=CHECKED_RACE_CALLS)
    t_race = time.perf_counter() - t
    torch.cuda.synchronize()
    print(json.dumps({"library": so.name, "load_s": t_load,
                      "selftest": named.strip()[-240:],
                      "selftest_s": t_self, "outcomes": len(got),
                      "corpus_s": t_corpus, "tables_s": t_tables,
                      "race_s": t_race}))
    return 0


def checked_phase(card: str, expect: list, workdir: Path,
                  build_s: float) -> None:
    """Phase 11(d): the bounds-checked build over the hostile inputs, in a
    child process (``--checked``), since a failed check leaves a sticky
    error that would poison this process's context. Fails unless the
    child exits 0; prints its output's end otherwise."""
    t0 = time.perf_counter()
    exp = workdir / "expect.json"
    exp.write_text(json.dumps(expect))
    try:
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--checked", str(exp), str(workdir)],
                           capture_output=True, text=True,
                           timeout=CHECKED_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"phase 11(d): the checked child ran past "
                             f"{CHECKED_TIMEOUT_S} s:\n"
                             f"{(e.stdout or '')[-4000:]}") from e
    if r.returncode != 0:
        raise AssertionError(f"phase 11(d): the checked child exited "
                             f"{r.returncode}:\n{r.stdout[-6000:]}\n"
                             f"{r.stderr[-6000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    for line in r.stdout.strip().splitlines()[:-1]:
        print(f"phase 11(d) child: {line}", flush=True)
    print(f"phase 11(d) bounds-checked build ({card}; {res['library']}, "
          f"built in {build_s:.1f} s beside the normal build, loaded in "
          f"{res['load_s']:.1f} s): self-test tripped its check in a "
          f"grandchild ({res['selftest_s']:.1f} s): {res['selftest']}; "
          f"{res['outcomes']} hostile outcomes == the normal build's "
          f"({res['corpus_s']:.1f} s), hostile tables of 3 targets "
          f"({res['tables_s']:.1f} s), race drill {RACE_THREADS} threads x "
          f"{CHECKED_RACE_CALLS} calls ({res['race_s']:.1f} s): no check "
          f"failed; phase {time.perf_counter() - t0:.1f} s", flush=True)


def _sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def _movie_phase(dev, card: str, workdir: Path) -> dict:
    """Phase 11(c), BASELINE config 4: MOVIE_FRAMES frames of 512x512 u16
    (Poisson(3), 200 hot pixels a frame at 65535) drawn on the card in
    MOVIE_CHUNK-frame chunks (``bench.synth``, a seed per chunk, so any
    chunk can be drawn again) into one BigTIFF with ``TiffWriter``, then
    the port's CLI in process at its default device: ``encode --stream
    --index`` on the card and ``encode --stream --host`` into another
    directory (equal SHA-256), ``decode --stream`` of the card's archive
    (a BigTIFF, chosen by ``needs_bigtiff``) held chunk by chunk through
    ``TiffStream`` against the frames drawn again, and ``verify``. Each
    step's launches are checked against its routes; returns them."""
    import contextlib
    import io

    from trpx_tpu_torch import bench
    from trpx_tpu_torch.cli.main import main as cli
    from trpx_tpu_torch.io.tiff import TiffStream, TiffWriter, needs_bigtiff
    from trpx_tpu_torch.ops import FrameSpec

    n = SIDE * SIDE
    spec = FrameSpec.for_dtype(n, np.uint16)
    F, C = MOVIE_FRAMES, MOVIE_CHUNK
    total = dict.fromkeys(_counters(), 0)
    free = shutil.disk_usage(workdir).free
    print(f"phase 11(c) movie: {F}x{SIDE}x{SIDE} u16 "
          f"({F * n * 2 / 1e9:.2f} GB), {free / 1e9:.1f} GB free on the "
          f"disk of {workdir}", flush=True)

    def chunk(lo):
        return bench.synth(spec, min(C, F - lo), 65535, SEED + lo,
                           dev)[:, :n]

    tif = workdir / "movie.tif"
    t0 = time.perf_counter()
    with TiffWriter(tif, bigtiff=needs_bigtiff(F * n * 2, F)) as wtr:
        for lo in range(0, F, C):
            wtr.append(chunk(lo).cpu().numpy().reshape(-1, SIDE, SIDE))
    walls = {"TIFF write": time.perf_counter() - t0}

    def run(step, argv, routes):
        """One CLI call, the counters set to 0 just before and read just
        after; raises on a nonzero exit, an error line or a kernel off the
        step's routes."""
        _zero_counts()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(argv)
        walls[step] = time.perf_counter() - t0
        got = _read_counts()
        if rc != 0 or err.getvalue():
            raise AssertionError(f"phase 11(c) {step}: rc {rc}\n"
                                 f"{out.getvalue()}\n{err.getvalue()}")
        _expect_route(f"phase 11(c) {step}", got, routes)
        for k, v in got.items():
            total[k] += v
        return got, out.getvalue()

    tail = F % C or C
    packs = {_route(spec, C)[0], _route(spec, tail)[0]}
    unpacks = {_route(spec, C)[1], _route(spec, tail)[1]}
    card_dir, host_dir, dec_dir = (workdir / d for d in ("card", "host",
                                                         "dec"))
    enc, _ = run("card encode", ["encode", "--stream", "--index", str(tif),
                                 "--out-dir", str(card_dir)], packs)
    run("host encode", ["encode", "--stream", "--host", str(tif),
                        "--out-dir", str(host_dir)], set())
    arch = card_dir / "movie.trpx"
    digest = _sha256(arch)
    if digest != _sha256(host_dir / "movie.trpx"):
        raise AssertionError("phase 11(c): the card's archive differs from "
                             "the host codec's")
    if not Path(f"{arch}.idx").exists():
        raise AssertionError("phase 11(c): encode --index wrote no sidecar")
    size = arch.stat().st_size
    tif.unlink()
    shutil.rmtree(host_dir)
    dec, _ = run("decode", ["decode", "--stream", str(arch), "--out-dir",
                            str(dec_dir)], unpacks)
    out = dec_dir / "movie.tif"
    out_size = out.stat().st_size
    with open(out, "rb") as f:
        big = f.read(4) == b"II\x2b\x00"
    if big != needs_bigtiff(F * n * 2, F) or big != (out_size > 1 << 32):
        raise AssertionError(f"phase 11(c): the decoded stack of "
                             f"{out_size} bytes is {'' if big else 'not '}"
                             f"a BigTIFF")
    t0 = time.perf_counter()
    ts = TiffStream(out)
    if len(ts) != F or ts.dims != (SIDE, SIDE):
        raise AssertionError(f"phase 11(c): {len(ts)} images of {ts.dims}")
    for lo in range(0, F, C):
        want = chunk(lo).cpu().numpy().reshape(-1, SIDE, SIDE)
        if not np.array_equal(ts.read(lo, lo + len(want)), want):
            raise AssertionError(f"phase 11(c): frames {lo}+ differ")
    ts.close()
    walls["compare"] = time.perf_counter() - t0
    _, text = run("verify", ["verify", str(arch)], set())
    if ": OK" not in text:
        raise AssertionError(f"phase 11(c) verify: {text}")
    shutil.rmtree(card_dir)
    shutil.rmtree(dec_dir)
    print(f"phase 11(c) movie ({card}): archive {size / 1e9:.3f} GB, "
          f"sha256 {digest[:16]} == --host's, encode launches {enc}, "
          f"decode {dec}; decoded {'BigTIFF' if big else 'TIFF'} of "
          f"{out_size} bytes == the frames drawn again; verify OK; host "
          f"clock frames/s: " + ", ".join(
              f"{k} {F / v:.1f} ({v:.1f} s)" for k, v in walls.items()),
          flush=True)
    return total


def _overlap_check(codec, frames: np.ndarray, dev) -> list:
    """Phase 12(a)'s overlap check: [(whether `dev`'s current stream
    still had work queued right after ``codec._dispatch_local(frames)``
    returned, the host ms of that dispatch)] for ``SHARD_REPS`` calls,
    each queued behind a spin kernel of ``OVERLAP_SPIN_CYCLES``. A
    dispatch that waits for its kernel, which runs after the spin,
    returns with the stream idle; one that only queues its work returns
    while the spin still runs."""
    out = []
    for _ in range(SHARD_REPS):
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            torch.cuda._sleep(OVERLAP_SPIN_CYCLES)
        t0 = time.perf_counter()
        flights = codec._dispatch_local(frames)
        t = (time.perf_counter() - t0) * 1e3
        out.append((not torch.cuda.current_stream(dev).query(), t))
        codec._collect_local(flights)
    return out


def _shard_routes(spec, F: int, k: int) -> set:
    """The kernels that an encode and a decode of `F` frames over `k`
    shards take."""
    from trpx_tpu_torch.parallel.codec import _split

    return {r for lo, hi in _split(F, k) for r in _route(spec, hi - lo)}


def _sharded_phase(dev, card: str) -> tuple:
    """Phase 12(a) (see the module docstring). Returns the launch counts
    of each batch's first encode and decode at each k, and what failed in
    the overlap check (None if it passed), which the caller raises after
    12(b); raises at once on a wrong byte, pixel or route."""
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.ops.cuda_unpack import decoded_dtype
    from trpx_tpu_torch.parallel import ShardedCodec

    total = dict.fromkeys(_counters(), 0)
    rng = np.random.default_rng(SEED + 12)
    queued = None
    for F, side, dt in SHARD_BATCHES:
        fr = _frames(rng, F, side * side, dt,
                     hot_value=HOT_U32 if dt == np.uint32 else None)
        spec = FrameSpec.for_dtype(side * side, dt)
        name = f"{F}x{side}x{side} {np.dtype(dt).name}"
        want = ncodec.encode(fr, dimensions=(side, side)).to_bytes()
        touch = []
        for _ in range(SHARD_REPS):
            t0 = time.perf_counter()
            torch.empty((F, side * side),
                        dtype=decoded_dtype(spec)).fill_(0)
            touch.append(time.perf_counter() - t0)
        print(f"phase 12(a) {name}: the first touch of a fresh pageable "
              f"array of its size (what a decode hands back) takes "
              f"{statistics.median(touch) * 1e3:.1f} ms, median of "
              f"{SHARD_REPS}", flush=True)
        for k in SHARDS:
            codec = ShardedCodec(spec, [dev] * k)
            _zero_counts()
            t0 = time.perf_counter()
            arch = codec.encode(fr, (side, side))
            t_enc0 = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = codec.decode(arch, dt)
            t_dec0 = time.perf_counter() - t0
            got = _read_counts()
            _expect_route(f"phase 12(a) {name} over {k}", got,
                          _shard_routes(spec, F, k))
            for kk, v in got.items():
                total[kk] += v
            if arch.to_bytes() != want:
                raise AssertionError(f"phase 12(a) {name} over {k}: bytes "
                                     f"differ from the native codec's")
            if not np.array_equal(back, fr):
                raise AssertionError(f"phase 12(a) {name} over {k}: decode "
                                     f"lost pixels")
            del back
            ts = {"dispatch": [], "collect": [], "encode": [], "decode": []}
            for _ in range(SHARD_REPS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                flights = codec._dispatch_local(fr)
                t1 = time.perf_counter()
                codec._collect_local(flights)
                ts["collect"].append(time.perf_counter() - t1)
                ts["dispatch"].append(t1 - t0)
                del flights
                t0 = time.perf_counter()
                codec.encode(fr, (side, side))
                ts["encode"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                codec.decode(arch, dt)
                ts["decode"].append(time.perf_counter() - t0)
            busy = None
            if side == SHARD_BATCHES[-1][1] and k == 2:
                queued = busy = _overlap_check(codec, fr, dev)
            print(f"phase 12(a) {name} over {k} shard(s) of {dev} ({card}): "
                  f"bytes == native codec, lossless, launches {got}; first "
                  f"encode {t_enc0 * 1e3:.1f} ms, decode {t_dec0 * 1e3:.1f} "
                  f"ms; host ms, median of {SHARD_REPS} warm: " + ", ".join(
                      f"{s} {statistics.median(v) * 1e3:.1f}"
                      for s, v in ts.items())
                  + (f"; work queued after the dispatch behind a spin "
                     f"{[b for b, _ in busy]}, dispatch ms "
                     f"{[round(t, 1) for _, t in busy]}" if busy else ""),
                  flush=True)
            del codec, arch
    F, side, _ = SHARD_BATCHES[-1]
    if not queued or not all(b for b, _ in queued):
        failed = (f"phase 12(a) overlap check: after the dispatch of {F}x"
                  f"{side}x{side} over 2 shards the stream had finished "
                  f"({queued}): a dispatch waited for its kernel")
        print(failed, flush=True)
        return total, failed
    print(f"phase 12(a) overlap check passed: {dev}'s current stream had "
          f"work queued right after each _dispatch_local of {F}x{side}x"
          f"{side} over 2 shards", flush=True)
    return total, None


def _cards_phase(card: str, workdir: Path) -> dict:
    """Phase 12(b) (see the module docstring). Returns the launch counts
    of its codec, dry run and worker drives."""
    from trpx_tpu_torch.graft_entry import dryrun_multichip
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.parallel import ShardedCodec, default_devices
    from trpx_tpu_torch.tools import scaling

    count = torch.cuda.device_count()
    if count < 2:
        print(f"phase 12(b) needs two or more cards; this machine has "
              f"{count}: no check run", flush=True)
        return {}
    total = dict.fromkeys(_counters(), 0)
    devices = default_devices()
    rng = np.random.default_rng(SEED + 13)
    msg = []
    for F, side, dt in SHARD_BATCHES:
        fr = _frames(rng, F, side * side, dt,
                     hot_value=HOT_U32 if dt == np.uint32 else None)
        spec = FrameSpec.for_dtype(side * side, dt)
        name = f"{F}x{side}x{side} {np.dtype(dt).name}"
        codec = ShardedCodec(spec, devices)
        _zero_counts()
        t0 = time.perf_counter()
        arch = codec.encode(fr, (side, side))
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = codec.decode(arch, dt)
        t_dec = time.perf_counter() - t0
        got = _read_counts()
        _expect_route(f"phase 12(b) {name} over {count} cards", got,
                      _shard_routes(spec, F, count))
        for k, v in got.items():
            total[k] += v
        if arch.to_bytes() != ncodec.encode(
                fr, dimensions=(side, side)).to_bytes():
            raise AssertionError(f"phase 12(b) {name} over {count} cards: "
                                 f"bytes differ from the native codec's")
        if not np.array_equal(back, fr):
            raise AssertionError(f"phase 12(b) {name} over {count} cards: "
                                 f"decode lost pixels")
        # warm calls: a timing loop, not counted
        warm = {"encode": [], "decode": []}
        for _ in range(SHARD_REPS):
            t0 = time.perf_counter()
            codec.encode(fr, (side, side))
            warm["encode"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            codec.decode(arch, dt)
            warm["decode"].append(time.perf_counter() - t0)
        msg.append(f"{name} first encode {t_enc * 1e3:.1f} ms, decode "
                   f"{t_dec * 1e3:.1f} ms; median of {SHARD_REPS} warm " +
                   ", ".join(f"{k} {statistics.median(v) * 1e3:.1f} ms"
                             for k, v in warm.items()))
        del fr, arch, back, codec
    print(f"phase 12(b) ShardedCodec over {count} cards ({card}): bytes == "
          f"native codec, lossless: " + "; ".join(msg), flush=True)
    t0 = time.perf_counter()
    ranks = dryrun_multichip(count)
    wall = time.perf_counter() - t0
    for r in ranks:
        _expect_route(f"phase 12(b) dryrun rank {r['rank']}", r["launches"],
                      {"pack", "pack_tiled", "unpack_tiled"})
        for k, v in r["launches"].items():
            total[k] += v
    print(f"phase 12(b) dryrun_multichip({count}), one rank a card, passed "
          f"in {wall:.1f} s", flush=True)
    # phase 8's shared files, rank r on cuda:r
    main_fr, big_fr = _parallel_frames()
    reports, wall = _launch_workers(
        "cards", workdir, (0,) * WORLD,
        [torch.device("cuda", r) for r in range(WORLD)])
    files = {"a": (main_fr, SIDE), "b": (big_fr, BIG[0][0])}
    for k, (fr, s) in files.items():
        spec = FrameSpec.for_dtype(s * s, fr.dtype)
        for r, rep in enumerate(reports):
            _expect_route(f"phase 12(b) worker {k} rank {r}",
                          rep[k]["launches"],
                          {_route(spec, len(fr) // WORLD)[0]})
            for kk, v in rep[k]["launches"].items():
                total[kk] += v
        if (workdir / f"{k}.trpx").read_bytes() != ncodec.encode(
                fr, dimensions=(s, s)).to_bytes():
            raise AssertionError(f"phase 12(b) workers ({k}): the shared "
                                 f"file differs from the native codec's")
    print(f"phase 12(b) {WORLD} gloo workers, rank r on cuda:r: shared "
          f"files of {main_fr.shape[0]}x{SIDE}x{SIDE} u16 and "
          f"{big_fr.shape[0]}x{BIG[0][0]}x{BIG[0][0]} u32 == native codec; "
          f"ms per rank " + "; ".join(
              k + " " + "/".join(f"{rep[k]['seconds'] * 1e3:.1f}"
                                 for rep in reports) for k in files)
          + f"; launch {wall:.1f} s wall", flush=True)
    # the scaling tool: a timing loop, checked but not counted
    _zero_counts()
    res = scaling.run(devices)
    _expect_route("phase 12(b) scaling", _read_counts(), {"pack"})
    if res["scaling_efficiency"] is None:
        raise AssertionError(f"phase 12(b) scaling: no efficiency on "
                             f"{count} cards: {res}")
    print(f"phase 12(b) scaling ({card}; {count} cards): "
          f"{json.dumps(res)}", flush=True)
    # the card tests that need two cards, in a child pytest (without the
    # suite's conftest, which imports jax)
    tests = [f"tests/test_torch_cuda.py::{t}" for t in (
        "test_launchers_leave_the_current_device",
        "test_sharded_codec_on_every_card")]
    root = Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", *tests], cwd=root, env=dict(os.environ),
        capture_output=True, text=True, timeout=600)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode or f"{len(tests)} passed" not in tail:
        raise AssertionError(f"phase 12(b) card tests: rc {r.returncode}\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-2000:]}")
    print(f"phase 12(b) card tests on {count} cards: {tail}", flush=True)
    return total


def _sharded_only(parts: str = "ab") -> int:
    """``chip_smoke.py --sharded [a|b]``: the card line, the kernels'
    build and phase 12 alone (12(a) and 12(b), or the one named); its
    last line is a JSON object of the phase's result, not the smoke's."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        del os.environ["CXX"]
    from trpx_tpu_torch import _build, native

    if not native.available():
        raise RuntimeError("the native host codec did not build")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    # nvidia-smi prints a line a card: name the first and the count
    label = f"{card.splitlines()[0]} x {torch.cuda.device_count()}"
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"phase 12 setup ({label}): build {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    launches, failed = dict.fromkeys(_counters(), 0), None
    if "a" in parts:
        launches, failed = _sharded_phase(torch.device("cuda:0"), label)
    work = Path(__file__).resolve().parent / "trpx_tpu_torch" / "_build"
    work.mkdir(exist_ok=True)
    if "b" in parts:
        with tempfile.TemporaryDirectory(dir=work) as d:
            for k, v in _cards_phase(label, Path(d)).items():
                launches[k] += v
    if failed:
        raise AssertionError(failed)
    print(f"phase 12 {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"phase12": "ok", "launches": launches,
                      "cards": torch.cuda.device_count()}))
    return 0


def walk_phase(dev, card: str) -> dict:
    """Phase 13 (module docstring): the header walk of one frame on the
    card. Returns the kernels line's walk entry."""
    import warnings

    import trpx_tpu_torch
    from trpx_tpu_torch import _fallback, native
    from trpx_tpu_torch.format.pycodec import TrpxArchive
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec, coding, cuda_walk
    from trpx_tpu_torch.ops.cuda_walk import (
        upload_stream,
        walk_frame,
        walk_frame_plain,
    )
    from trpx_tpu_torch.tools import walk_bench

    t0 = time.perf_counter()

    def same(got, want, what):
        a = (got.rounds, got.headers, got.wmax, got.end_bit)
        b = (want.rounds, want.headers, want.wmax, want.end_bit)
        if a != b:
            raise AssertionError(f"walk kernel != plain on {what}: {a} vs "
                                 f"{b}")
        k = min(got.headers, got.widths.shape[1])
        e = _diff(got.widths[:, :k], want.widths[:, :k])
        if e:
            raise AssertionError(f"walk kernel != plain widths on {what}: "
                                 f"off by up to {e}")
        return e

    # (a) kernel == plain == host walk
    frames = {"4362x4148 u32 gapped": walk_bench.gapped_image(seed=1),
              "2048x2048 u32": walk_bench.synth(1, 2048 * 2048, np.uint32,
                                                HOT_U32, seed=3)}
    rounds_a, err = {}, 0
    for name, fr in frames.items():
        arch = ncodec.encode(fr)
        spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
        P = arch.meta.memory_size
        words = upload_stream(arch.payload, dev)
        rows, _, fst = native.walk_chunk(native.padded_buffer(arch.payload),
                                         0, 1, spec.n, spec.block,
                                         max_width=32)
        bits = cuda_walk.WALK_BITS
        try:
            for L in (2048, bits):
                cuda_walk.WALK_BITS = L
                got = walk_frame(spec, words, P)
                if got.rounds is None:
                    raise AssertionError(f"walk of {name} in {L}-bit parts "
                                         f"did not converge")
                err = max(err, same(got, walk_frame_plain(spec, words, P),
                                    f"{name} L={L}"))
                e = _diff(got.widths.cpu().to(torch.int32),
                          torch.from_numpy(rows))
                err = max(err, e)
                if (e or got.wmax != rows.max()
                        or 1 + got.end_bit // 8 != fst[1]):
                    raise AssertionError(f"walk kernel != host walk on "
                                         f"{name}: widths off by up to {e}")
                rounds_a[f"{name} L={L}"] = got.rounds
        finally:
            cuda_walk.WALK_BITS = bits
    print(f"phase 13 (a) walk kernel == plain == host walk ({card}); "
          f"rounds {rounds_a}; widths off by at most {err}", flush=True)

    # (b) the hostile corpus on one frame above the crossover
    rng = np.random.default_rng(SEED)
    n = max(WALK_CORPUS_VALUES, 12 * coding.WALK_ON_CARD_MIN_BLOCKS)
    base_fr = rng.poisson(3.0, (1, n)).astype(np.uint16)
    base_fr[0, rng.integers(0, n, 40)] = 65535
    base = ncodec.encode(base_fr).to_bytes()
    keep = coding.WALK_ON_CARD_MIN_BLOCKS
    kinds: dict = {}
    walked = {"card": 0, "host": 0}
    saved = set(_fallback._seen)
    _fallback._seen.clear()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*fallback at")
            for kind, blob in hostile_corpus(base):
                outs = []
                for route, floor in (("card", keep), ("host", 10**12)):
                    coding.WALK_ON_CARD_MIN_BLOCKS = floor
                    before = dict(_count_walks())
                    got = _said(lambda: trpx_tpu_torch.decompress(blob))
                    a = None
                    try:
                        a = TrpxArchive.from_bytes(blob)
                        coding.decode(a, np.uint16, device=dev)
                    except OK_ERRORS:
                        pass
                    walked[route] += (_count_walks()["walks.card"]
                                      - before["walks.card"])
                    outs.append((got, a))
                (got, a), (want, b) = outs
                if _said_digest(got) != _said_digest(want):
                    raise AssertionError(f"walk corpus {kind}: card walk "
                                         f"{_said_digest(got)} != host walk "
                                         f"{_said_digest(want)}")
                ta = getattr(a, "width_table", None)
                tb = getattr(b, "width_table", None)
                if (ta is None) != (tb is None) or (
                        ta is not None and not (
                            np.array_equal(ta, tb)
                            and np.array_equal(a.frame_index,
                                               b.frame_index))):
                    raise AssertionError(f"walk corpus {kind}: the card "
                                         f"walk's tables differ")
                k = "ok" if not isinstance(got, tuple) else got[0].__name__
                kinds[f"{kind} {k}"] = kinds.get(f"{kind} {k}", 0) + 1
    finally:
        coding.WALK_ON_CARD_MIN_BLOCKS = keep
        _fallback._seen.clear()
        _fallback._seen.update(saved)
    if walked["host"] or not walked["card"]:
        raise AssertionError(f"walk corpus routes: {walked}")
    print(f"phase 13 (b) hostile corpus of 1 x {n} u16 "
          f"({FrameSpec.for_dtype(n, np.uint16).nb} blocks; {card}): card "
          f"walk == host walk on every outcome and table; {walked['card']} "
          f"card walks; {kinds}", flush=True)

    # (c) the kernels' device time at the image's shape, beside the bound
    fr = frames["4362x4148 u32 gapped"]
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    P = arch.meta.memory_size
    words = upload_stream(arch.payload, dev)
    call = lambda: walk_frame(spec, words, P)  # noqa: E731
    ms = walk_bench._walk_device_ms(call, 10)
    launches = _launch_ms(call, 10)
    host_ms = walk_bench._median_ms(call, 10)
    t = time.perf_counter()
    walk_frame_plain(spec, words, P)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    io = (P, spec.nb)
    print(f"phase 13 (c) walk ({card}) at 4362x4148 u32 gapped: {ms} ms "
          f"device, {host_ms} ms host clock a walk, bytes in {io[0]} out "
          f"{io[1]}, bound {_bound_ms(sum(io))} ms, plain {plain_ms} ms; "
          f"by launch (ms a call) " + ", ".join(
              f"{k} {v:.4f}" for k, v in launches.items()), flush=True)

    # (d) the images of a decompress_image cell through decompress: the
    # card walks each (walks.card), within the cap (walks.unsynced 0), in
    # walks.sync_rounds rounds
    from trpx_tpu_torch.runtime import metrics

    blobs = [(img, ncodec.encode(img, dimensions=(4148, 4362)).to_bytes())
             for img in (walk_bench.gapped_image(seed=100 + seed)
                         for seed in range(WALK_IMAGES))]
    names = ("walks.card", "walks.sync_rounds", "walks.unsynced")
    before = metrics.counters()
    most = 0
    _zero_counts()
    walk_frame.launches = 0
    for seed, (img, blob) in enumerate(blobs):
        r = metrics.counters().get("walks.sync_rounds", 0)
        got = trpx_tpu_torch.decompress(blob)
        most = max(most, metrics.counters().get("walks.sync_rounds", 0) - r)
        if not np.array_equal(got.reshape(-1), img[0]):
            raise AssertionError(f"image {seed} decoded to other pixels")
    counts = _read_counts()
    walks = walk_frame.launches
    c = {k: metrics.counters().get(k, 0) - before.get(k, 0) for k in names}
    print(f"phase 13 (d) {WALK_IMAGES} 4362x4148 u32 gapped images through "
          f"decompress ({card}): {c}, "
          f"{c['walks.sync_rounds'] / WALK_IMAGES} rounds an image, at most "
          f"{most} of a cap of {cuda_walk.WALK_ROUND_CAP}, at "
          f"{cuda_walk.WALK_BITS}-bit parts; launches: walk {walks}, "
          f"{counts}; {time.perf_counter() - t0:.1f} s", flush=True)
    if c["walks.card"] != WALK_IMAGES or c["walks.unsynced"]:
        raise AssertionError(f"the images' walks: {c}")
    if counts != {**dict.fromkeys(counts, 0), "unpack_tiled": WALK_IMAGES} \
            or walks < WALK_IMAGES:
        raise AssertionError(f"the images' launches: walk {walks}, {counts}")
    entry = {"name": "walk", "route": "cuda",
             "source": "trpx_tpu_torch/csrc/walk.cu", "replaces": None,
             "shape": "1x4362x4148 u32 gapped", "launches": walks,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": _bound_ms(sum(io)), "bound_by": "bytes",
             "library_ms": None}
    return entry, counts


def _said(fn):
    """:func:`_outcome` with the error's message: (class, message)."""
    try:
        return np.asarray(fn())
    except OK_ERRORS as e:
        return (type(e), str(e))


def _said_digest(outcome) -> str:
    if isinstance(outcome, tuple):
        return f"{outcome[0].__name__}: {outcome[1]}"
    return _digest(outcome)


def _count_walks() -> dict:
    from trpx_tpu_torch.runtime import metrics

    c = metrics.counters()
    return {k: c.get(k, 0) for k in ("walks.card", "walks.unsynced")}


def counted_phase(dev, card: str) -> dict:
    """Phase 14: a K3 movie through ``decompress(dtype=np.uint8)`` on the
    card (module docstring); returns the first decode's launches."""
    from trpx_tpu_torch import api
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import FrameSpec, decode_batch_tiled, walk_archive
    from trpx_tpu_torch.runtime import metrics
    from trpx_tpu_torch.runtime.metrics import device_ms

    F, h, w = K3_MOVIE
    n = h * w
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = np.empty((F, n), np.uint8)
    for lo in range(0, F, 4):
        x = torch.poisson(torch.full((4, n), K3_COUNTS, device=dev),
                          generator=gen)
        frames[lo:lo + 4] = x.clamp(max=255).to(torch.uint8).cpu().numpy()
    arch = ncodec.encode(frames, dimensions=(w, h))
    blob = arch.to_bytes()
    want = frames.reshape(F, h, w)

    def decode_counted():
        before = metrics.counters()
        out = api.decompress(blob, dtype=np.uint8)
        after = metrics.counters()
        return out, {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}

    _zero_counts()
    out, got = decode_counted()
    launches = _read_counts()
    if out.dtype != np.uint8 or not np.array_equal(out, want):
        raise AssertionError("phase 14: the K3 movie decoded to other pixels")
    _expect_route("phase 14 K3 movie", launches, {"unpack_tiled"})
    if launches["unpack_tiled"] != 1:
        raise AssertionError(f"phase 14: launches {launches}")
    routes = {k: v for k, v in got.items() if k.startswith("frames.")}
    if routes != {"frames.decode_batch_tiled": F}:
        raise AssertionError(f"phase 14: routes {routes}")
    if (got.get("unpack_out_bytes.trpx.decode.kernel") != F * n
            or got.get("results.pinned") != 1 or "results.pageable" in got):
        raise AssertionError(f"phase 14: counters {got}")
    del out
    # three movies, each decoded while the two before it are held
    held, ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        out, got = decode_counted()
        ms.append((time.perf_counter() - t0) * 1e3)
        if got.get("results.pinned") != 1 or "results.pageable" in got:
            raise AssertionError(f"phase 14: with {len(held)} held, "
                                 f"counters {got}")
        held = (held + [out])[-2:]
    del held, out
    spec = FrameSpec.for_dtype(n, np.uint8)
    wide = FrameSpec.for_dtype(n, np.uint16)
    widths, words = walk_archive(arch, spec)
    wd = torch.from_numpy(widths).to(dev)
    wo = torch.from_numpy(words.view(np.int32)).to(dev)
    lanes_ms = {name: device_ms(
        lambda: decode_batch_tiled(sp, wo, wd, odt), 5)
        for name, sp, odt in (("u8", spec, torch.uint8),
                              ("u16", wide, torch.uint16))}
    moved = {k: (arch.meta.memory_size + F * n * b) / 1e6
             for k, b in (("u8", 1), ("u16", 2))}
    print(f"phase 14 K3 movie ({card}): {F}x{h}x{w} u8, ratio "
          f"{arch.meta.memory_size / frames.nbytes:.4f}, exact, one tiled "
          f"unpack, pinned results with two held; decompress "
          f"{statistics.median(ms):.1f} ms (host clock, median of 3); tiled "
          f"unpack device ms: u8 lanes {lanes_ms['u8']:.4f} "
          f"({moved['u8']:.1f} MB, bound {_bound_ms(moved['u8'] * 1e6):.4f}),"
          f" u16 lanes {lanes_ms['u16']:.4f} ({moved['u16']:.1f} MB, bound "
          f"{_bound_ms(moved['u16'] * 1e6):.4f})", flush=True)
    return launches


def _counted_only() -> int:
    """``--counted``: build the kernels and run phase 14 alone."""
    from trpx_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        del os.environ["CXX"]
    _build.build()
    _build.load()
    counted_phase(torch.device("cuda:0"), card)
    print(json.dumps({"phase14": "ok"}))
    return 0


def _walk_only() -> int:
    """``--walk``: build the kernels and run phase 13 alone."""
    from trpx_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        del os.environ["CXX"]
    _build.build()
    _build.load()
    entry, _ = walk_phase(torch.device("cuda:0"), card)
    print(json.dumps({"phase13": "ok", "walk": entry}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the port's host codec builds with $CXX -fopenmp; a CXX that cannot
    # (missing, or without OpenMP) would leave it unbuilt and every header
    # walk in pure Python
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        print(f"CXX={cxx} cannot build OpenMP code: the host codec builds "
              f"with g++ from PATH")
        del os.environ["CXX"]
    from trpx_tpu_torch import _build, native
    from trpx_tpu_torch.native import codec as ncodec
    from trpx_tpu_torch.ops import (
        FrameSpec,
        decode_batch,
        decode_batch_plain,
        decode_batch_tiled,
        decode_batch_tiled_plain,
        decoded_dtype,
        encode_batch,
        encode_batch_plain,
        encode_batch_tiled,
        encode_batch_tiled_plain,
        walk_archive,
    )
    from trpx_tpu_torch.ops.staging import Staging, upload
    from trpx_tpu_torch.ops.cuda_pack import (
        defined_words,
        pack_geometry,
        pack_scratch_ints,
        stream_words,
    )
    from trpx_tpu_torch.ops.cuda_unpack import unpack_geometry
    from trpx_tpu_torch.runtime.metrics import device_ms, event_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda:0")
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | native host codec {native.available()}",
          flush=True)
    if not native.available():
        raise RuntimeError("the native host codec (trpx_tpu_torch.native) "
                           "did not build")

    # phase 2: build the kernels from the checkout's sources, and beside
    # them the bounds-checked build of phase 11(d)
    import threading

    checked: dict = {}

    def build_checked():
        t = time.perf_counter()
        try:
            checked["so"] = _build.build(checked=True)
        except Exception as e:   # raised below, in this thread
            checked["error"] = e
        checked["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    builder = threading.Thread(target=build_checked)
    builder.start()
    so = _build.build()
    t_build = time.perf_counter() - t0
    _build.load()
    builder.join()
    if "error" in checked:
        raise checked["error"]
    root = _build.CSRC.parent.parent
    print(f"phase 2 build: {t_build:.2f} s -> {so.relative_to(root)}; "
          f"bounds-checked build beside it {checked['s']:.2f} s -> "
          f"{checked['so'].relative_to(root)}", flush=True)

    def inputs(fr, block=12):
        """Device inputs of the kernels for frames `fr` (F, n) in blocks of
        `block` values."""
        spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype, block)
        x = upload(Staging(), "x", fr, spec.n_padded, spec.torch_dtype,
                   dev)
        widths, words = walk_archive(ncodec.encode(fr, block=block), spec)
        return dict(spec=spec, x=x, odt=decoded_dtype(spec),
                    wd=torch.from_numpy(widths).to(dev),
                    wo=torch.from_numpy(words.view(np.int32)).to(dev))

    def calls(m, tile=None):
        """Each kernel's wrapper and its plain version on the inputs `m`,
        the tiled ones at `tile`-block tiles (None: their default
        geometry)."""
        spec, x, wo, wd, odt = m["spec"], m["x"], m["wo"], m["wd"], m["odt"]
        return {
            "pack": (lambda: encode_batch(spec, x),
                     lambda: encode_batch_plain(spec, x)),
            "unpack": (lambda: decode_batch(spec, wo, wd, odt),
                       lambda: decode_batch_plain(spec, wo, wd, odt)),
            "pack_tiled": (lambda: encode_batch_tiled(spec, x, tile),
                           lambda: encode_batch_tiled_plain(spec, x, tile)),
            "unpack_tiled": (
                lambda: decode_batch_tiled(spec, wo, wd, odt, tile),
                lambda: decode_batch_tiled_plain(spec, wo, wd, odt, tile)),
        }

    err = dict.fromkeys(_counters(), 0)
    current = torch.cuda.current_device()

    def check(name, fr, kernels, block=12, tile=None):
        """The named kernels (the tiled ones at `tile`-block tiles, None:
        their default geometry) against their plain versions on frames
        `fr` in blocks of `block` values, and each decode against the
        frames; keeps the largest error of each kernel in `err` and
        returns the device inputs."""
        m = inputs(fr, block)
        for k in kernels:
            fn, plain = calls(m, tile)[k]
            got, want = fn(), plain()
            if torch.cuda.current_device() != current:
                raise AssertionError(f"{k} kernel on {name} left the thread "
                                     f"on device "
                                     f"{torch.cuda.current_device()}")
            if k.startswith("pack"):
                # a pack kernel defines each frame's words up to its bits
                got = (stream_words(got[0], got[1]),) + tuple(got[1:])
                e = max(_diff(g, w) for g, w in zip(got, want))
            else:
                e = _diff(got, want)
                if not np.array_equal(got.cpu().numpy().astype(fr.dtype), fr):
                    raise AssertionError(f"{k} kernel lost pixels on {name}")
            if e:
                raise AssertionError(f"{k} kernel != plain on {name}: max "
                                     f"abs err {e}")
            err[k] = max(err[k], e)
            del got, want
        return m

    # phase 3: kernels against their plain versions on the card
    one_pass = ("pack", "unpack")
    tiled = ("pack_tiled", "unpack_tiled")
    rng = np.random.default_rng(SEED)
    n_main = SIDE * SIDE
    main_frames = _frames(rng, F_MAIN, n_main)
    one_pass_cases = [
        ("512x512 u16 x256", main_frames),
        ("all-zero 512x512 u16", np.zeros((1, n_main), np.uint16)),
        ("n=1000 u16", _frames(rng, 3, 1000, hot=5)),
        ("n=100 u16", _frames(rng, 3, 100, hot=2)),
        ("n=1000 u8", _frames(rng, 3, 1000, np.uint8, hot=5)),
        ("n=1000 u32", _frames(rng, 3, 1000, np.uint32, hot=5)),
        ("n=1000 i8", _signed_frames(rng, 3, 1000, np.int8)),
        ("n=1000 i16", _signed_frames(rng, 3, 1000, np.int16)),
        ("n=1001 i32", _signed_frames(rng, 3, 1001, np.int32)),
    ]
    one_pass_cases += [(f"worst case {np.dtype(dt).name}", _extreme_frames(dt))
                      for dt in DTYPES]
    one_pass_cases += [(f"tile edges {np.dtype(dt).name}",
                       _one_pass_edge_frames(rng, dt))
                      for dt in (np.uint16, np.int32)]
    tiled_cases = [
        (f"tile edges {np.dtype(dt).name}",
         _tile_edge_frames(rng, dt, SMALL_TILE), SMALL_TILE)
        for dt in DTYPES]
    tiled_cases.append((
        "2048x2048 u32 x4", _frames(rng, 4, 2048 * 2048, np.uint32,
                                    hot_value=HOT_U32), None))
    main_inputs = {}
    for name, fr in one_pass_cases:
        m = check(name, fr, one_pass)
        if name == one_pass_cases[0][0]:
            main_inputs = m
    for name, fr, tile in tiled_cases:
        check(name, fr, tiled, tile=tile)
    # at their default tiles: blocks larger than a tile, and tiles of
    # fewer than 32 bits
    wide_cases = [(f"{BIG_BLOCK}-value blocks {np.dtype(dt).name}",
                   _big_block_frames(rng, dt), BIG_BLOCK)
                  for dt in (np.uint8, np.int16, np.uint32, np.int32)]
    wide_cases += [(f"zero {WIDE_BLOCK}-value blocks {np.dtype(dt).name}",
                    _sparse_frames(rng, dt), WIDE_BLOCK)
                   for dt in (np.uint16, np.int32)]
    for name, fr, block in wide_cases:
        check(name, fr, tiled, block=block)
    torch.cuda.synchronize()
    print(f"phase 3 kernels == plain versions (exact): one-pass on "
          f"{len(one_pass_cases)} inputs, tiled on "
          f"{len(tiled_cases) + len(wide_cases)} ({len(tiled_cases) - 1} "
          f"dtypes at {SMALL_TILE}-block tiles; at their default tiles "
          f"2048x2048 u32 x4, {BIG_BLOCK}-value blocks (larger than a "
          f"tile) on 4 dtypes, tiles of fewer than 32 bits on 2)",
          flush=True)

    # phase 4: the 512x512 path, with the launch counters
    stack = main_frames.reshape(F_MAIN, SIDE, SIDE)
    r = _drive(stack)
    launches = dict(r["launches"])
    if min(launches["pack"], launches["unpack"]) < 1 \
            or launches["pack_tiled"] or launches["unpack_tiled"]:
        raise AssertionError(f"512x512 path took the wrong kernels: "
                             f"{launches}")
    t_enc, t_dec = r["t_enc"], r["t_dec"]
    print(f"phase 4 512x512 path: {F_MAIN}x{SIDE}x{SIDE} u16, "
          f"{stack.nbytes / 1e6:.1f} MB -> "
          f"{r['arch'].meta.memory_size / 1e6:.3f} MB, bytes == native "
          f"codec, lossless, foreign decode ok, launches {r['launches']}; "
          f"host clock compress {t_enc * 1e3:.1f} ms, decompress "
          f"{t_dec * 1e3:.1f} ms, foreign decompress "
          f"{r['t_foreign'] * 1e3:.1f} ms", flush=True)
    del stack, r

    # phase 5: the big-frame paths. Both batches encode with the one-pass
    # pack and decode with the tiled unpack (FrameSpec.tiled_pack,
    # FrameSpec.tiled)
    big_inputs = {}
    layers = ({}, {})
    for side, F in BIG:
        stack = _frames(rng, F, side * side, np.uint32,
                        hot_value=HOT_U32).reshape(F, side, side)
        r = _drive(stack)
        got = r["launches"]
        route = _route(FrameSpec.for_dtype(side * side, np.uint32), F)
        if min(got[k] for k in route) < 1 or any(
                got[k] for k in got if k not in route):
            raise AssertionError(f"{side}x{side} path took the wrong "
                                 f"kernels: {got}")
        for k, v in got.items():
            launches[k] += v
        print(f"phase 5 big-frame path: {F}x{side}x{side} u32, "
              f"{stack.nbytes / 1e6:.1f} MB -> "
              f"{r['arch'].meta.memory_size / 1e6:.3f} MB (ratio "
              f"{r['ratio']:.3f}), bytes == native codec, lossless, foreign "
              f"decode ok, launches {got}; host clock compress "
              f"{r['t_enc'] * 1e3:.1f} ms = {F / r['t_enc']:.2f} frames/s, "
              f"decompress {r['t_dec'] * 1e3:.1f} ms = "
              f"{F / r['t_dec']:.2f} frames/s, foreign decompress "
              f"{r['t_foreign'] * 1e3:.1f} ms = "
              f"{F / r['t_foreign']:.2f} frames/s", flush=True)
        # all four kernels against their plain versions at the path's own
        # shape, the ones its route ran among them (the launches after
        # _drive are not counted)
        name = f"{F}x{side}x{side} u32"
        big_inputs[side] = check(name, stack.reshape(F, -1), one_pass + tiled)
        print(f"phase 5 kernels == plain versions (exact) at {name}: "
              f"one-pass, and tiled at their default tiles", flush=True)
        if side == BIG[0][0]:
            layers = _profile_layers(stack, r["arch"], dev)
        del stack, r
    # blocks of 1,024 int32 values are too large for a tile of the one-pass
    # pack, so compress takes the tiled pack (FrameSpec.tiled_pack); 4
    # frames decode with the tiled unpack
    side, F = BIG[0][0], 4
    wide = rng.integers(-300, 300, (F, side * side)).astype(np.int32)
    wide[np.repeat(np.arange(F), 200),
         rng.integers(0, side * side, F * 200)] = -HOT_U32  # int32 output
    r = _drive(wide.reshape(F, side, side), block=WIDE_BLOCK)
    got = r["launches"]
    route = _route(FrameSpec.for_dtype(side * side, np.int32, WIDE_BLOCK), F)
    if route != ("pack_tiled", "unpack_tiled") or min(
            got[k] for k in route) < 1 or any(
                got[k] for k in got if k not in route):
        raise AssertionError(f"{WIDE_BLOCK}-value blocks took the wrong "
                             f"kernels: {got}")
    for k, v in got.items():
        launches[k] += v
    wide_name = f"{F}x{side}x{side} i32, block {WIDE_BLOCK}"
    print(f"phase 5 wide-block path: {wide_name}, bytes == native codec, "
          f"lossless, foreign decode ok, launches {got}", flush=True)
    # the kernels its route ran (and the one-pass unpack) against their
    # plain versions at its shape
    wide_inputs = check(wide_name, wide, ("pack_tiled", "unpack",
                                          "unpack_tiled"), block=WIDE_BLOCK)
    print(f"phase 5 kernels == plain versions (exact) at {wide_name}: "
          f"pack_tiled, unpack (one-pass, "
          f"{unpack_geometry(wide_inputs['spec'])[0]}-block tiles), "
          f"unpack_tiled", flush=True)
    del wide, r
    host, device = layers
    print(f"phase 5 layers ({BIG[0][1]}x{BIG[0][0]}x{BIG[0][0]} u32, "
          f"{card}; torch.profiler, means of 3): host clock ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
          + "; device ms " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in device.items()),
          flush=True)

    # phase 6: each kernel's times at the shape of a path that runs it,
    # and the bytes it must move there: every input read once, every
    # output written once (the words each frame defines; the unpack reads
    # the same words, the widths, and writes the pixels)
    def traffic(m):
        spec, x, wd, odt = m["spec"], m["x"], m["wd"], m["odt"]
        F = x.shape[0]
        pack = encode_batch_tiled if spec.tiled_pack(F) else encode_batch
        bits = pack(spec, x)[1]
        stream = 4 * int(defined_words(bits).sum().item())
        pixels_in = x.numel() * x.element_size()
        pixels_out = F * spec.n * odt.itemsize
        return {"pack": (pixels_in, stream + 8 * F),
                "unpack": (stream + wd.numel(), pixels_out)}

    main_name = f"{F_MAIN}x{SIDE}x{SIDE} u16"
    big_name = {side: f"{F}x{side}x{side} u32" for side, F in BIG}
    # the kernels line's shapes: the 512x512 path for the one-pass kernels,
    # the wide-block path for the tiled pack, the 4096x4096 path for the
    # tiled unpack
    at = {"pack": (main_inputs, main_name, 20),
          "unpack": (main_inputs, main_name, 20),
          "pack_tiled": (wide_inputs, wide_name, 10),
          "unpack_tiled": (big_inputs[4096], big_name[4096], 10)}
    ms, event, plain_ms, io_bytes, shape = {}, {}, {}, {}, {}
    for k, (m, name, iters) in at.items():
        fn, plain = calls(m)[k]
        # device time (the line's "ms"), beside the CUDA-event time of a
        # loop of calls, which includes whatever host work outlasts the
        # kernels
        ms[k] = device_ms(fn, iters)
        event[k] = event_ms(fn, iters)
        plain_ms[k] = event_ms(plain, 2)
        io_bytes[k] = traffic(m)[k.split("_")[0]]
        shape[k] = name
        print(f"phase 6 {k} ({card}) at {name}: {ms[k]} ms device = "
              f"{m['x'].shape[0] / ms[k] * 1e3} frames/s (events "
              f"{event[k]} ms), bytes in {io_bytes[k][0]} out "
              f"{io_bytes[k][1]}, bound {_bound_ms(sum(io_bytes[k]))} ms, "
              f"plain {plain_ms[k]} ms", flush=True)
    # the tiled kernels' time by launch (each runs three) at the same shapes
    for k in tiled:
        m, name, _ = at[k]
        print(f"phase 6 {k} launches ({card}; torch.profiler, ms per call) "
              f"at {name}: " + ", ".join(
                  f"{n} {v:.4f}"
                  for n, v in _launch_ms(calls(m)[k][0]).items()),
              flush=True)
    # the pack's one fill: its zeroed scratch (ticket, tile descriptors,
    # widths), part of its time above
    spec = main_inputs["spec"]
    tiles = -(-spec.nb // pack_geometry(spec)[0])
    fill_ms = event_ms(lambda: torch.zeros(
        (pack_scratch_ints(F_MAIN, tiles),), dtype=torch.int32, device=dev),
        20)
    # the other routes at the 512x512 and big shapes, the tiled pack at
    # 32 x 2048x2048 u32 among them (route_sweep times both routes at
    # 1-256 frames)
    others = [(main_name, k) for k in tiled] + [
        (big_name[s], k) for s in big_name for k in one_pass + tiled
        if (big_name[s], k) != (shape["unpack_tiled"], "unpack_tiled")]
    ins = {main_name: main_inputs,
           **{big_name[s]: big_inputs[s] for s in big_name}}
    other_ms = {}
    for name, k in others:
        fn = calls(ins[name])[k][0]
        other_ms[f"{k} at {name}"] = (device_ms(fn, 10), event_ms(fn, 10))
    print(f"phase 6 other routes ({card}), ms device / events: pack scratch "
          f"fill at {main_name} {fill_ms} (events); " + "; ".join(
              f"{k} {d} / {e}" for k, (d, e) in other_ms.items())
          + f"; end to end at {main_name}: compress {F_MAIN / t_enc} "
          f"frames/s, decompress {F_MAIN / t_dec} frames/s", flush=True)
    del main_inputs, wide_inputs, m
    big_inputs.clear()

    # phase 7: the stream path
    work = Path(__file__).resolve().parent / "trpx_tpu_torch" / "_build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as d:
        streamed = _stream_phase(rng, dev, card, Path(d))
    for k, v in streamed.items():
        launches[k] += v

    # phase 8: the parallel path, two gloo processes on the card
    with tempfile.TemporaryDirectory(dir=work) as d:
        for k, v in _parallel_phase(dev, card, Path(d)).items():
            launches[k] += v

    # phase 9: the CLI on the card, in this process
    with tempfile.TemporaryDirectory(dir=work) as d:
        for k, v in _cli_phase(rng, card, Path(d)).items():
            launches[k] += v

    # phase 10: the bench, the campaign's smoke tier, the entry points and
    # the scaling tool, on the default device
    from trpx_tpu_torch.api import _torch_device

    # (a) and (d) time repeated calls: their launches count the timing
    # loops' repetitions, not traffic, so they stay out of the kernels
    # line (each checks its own routes)
    t10 = time.perf_counter()
    _bench_phase(dev, card)
    for got in (_campaign_phase(_torch_device(None)), _entry_phase(dev)):
        for k, v in got.items():
            launches[k] += v
    _scaling_phase()
    print(f"phase 10 {time.perf_counter() - t10:.1f} s", flush=True)

    # phase 11: the hostile corpus and the race drill (checked, not
    # counted: neither is traffic), BASELINE config 4's movie, then the
    # corpus, the hostile tables and the drill on the bounds-checked build
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=work) as d:
        outcomes = hostile_phase(card, Path(d))
    race_drill(dev, card)
    with tempfile.TemporaryDirectory(dir=work) as d:
        for k, v in _movie_phase(dev, card, Path(d)).items():
            launches[k] += v
    with tempfile.TemporaryDirectory(dir=work) as d:
        checked_phase(card, outcomes, Path(d), checked["s"])
    print(f"phase 11 {time.perf_counter() - t11:.1f} s", flush=True)

    # phase 12: the sharded path over k shards of the card, then over every
    # card when there are two or more
    t12 = time.perf_counter()
    got, failed = _sharded_phase(dev, card)
    with tempfile.TemporaryDirectory(dir=work) as d:
        for k, v in _cards_phase(card, Path(d)).items():
            got[k] += v
    if failed:
        raise AssertionError(failed)
    for k, v in got.items():
        launches[k] += v
    print(f"phase 12 {time.perf_counter() - t12:.1f} s", flush=True)

    # phase 13: the header walk of one frame on the card
    walk_entry, got = walk_phase(dev, card)
    for k, v in got.items():
        launches[k] += v

    # phase 14: a Gatan K3 movie in u8 lanes
    for k, v in counted_phase(dev, card).items():
        launches[k] += v

    sources = {"pack": ("pack.cu", "trpx_tpu/ops/pallas_pack.py:712"),
               "unpack": ("unpack.cu", "trpx_tpu/ops/pallas_unpack.py:626"),
               "pack_tiled": ("pack_tiled.cu",
                              "trpx_tpu/ops/pallas_pack.py:1013"),
               "unpack_tiled": ("unpack_tiled.cu",
                                "trpx_tpu/ops/pallas_unpack.py:824")}
    # no PyTorch call computes a TRPX pack or unpack: no library time
    kernels = [
        {"name": k, "route": "cuda",
         "source": f"trpx_tpu_torch/csrc/{src}", "replaces": replaces,
         "shape": shape[k], "launches": launches[k], "max_abs_err": err[k],
         "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": _bound_ms(sum(io_bytes[k])),
         "bound_by": "bytes", "library_ms": None}
        for k, (src, replaces) in sources.items()]
    # the walk replaces no TPU kernel: the JAX package walks on the host
    kernels.append(walk_entry)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        a = sys.argv[2:]
        sys.exit(_worker(a[0], int(a[1]), int(a[2]), int(a[3]), a[4],
                         *a[5:6]))
    if sys.argv[1:2] == ["--checked"]:
        sys.exit(_checked_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--checked-selftest"]:
        sys.exit(_checked_selftest())
    if sys.argv[1:2] == ["--sharded"]:
        sys.exit(_sharded_only(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--walk"]:
        sys.exit(_walk_only())
    if sys.argv[1:2] == ["--counted"]:
        sys.exit(_counted_only())
    sys.exit(main())
