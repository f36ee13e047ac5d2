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
2. the kernels' build from ``trpx_tpu_torch/csrc`` (seconds);
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
   values, many tiles to a word);
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
   over the same chunks.

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
#: device memory rate of an H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
DTYPES = (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32)


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
    from torch.profiler import record_function

    out = np.empty_like(like)
    lo = 0
    for chunk in chunks:
        with record_function("trpx.consumer.copy"):
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
    foreign decode only its walk), and the device ms per call of each
    kernel and copy on the card, by short name."""
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
                    if e.key == "trpx.decode.walk":
                        host["decode.walk foreign"] = e.cpu_time_total / 1e3 / reps
                else:
                    host[e.key[5:]] = e.cpu_time_total / 1e3 / reps
            elif e.device_type == DeviceType.CUDA and run != "foreign" \
                    and not e.key.startswith("trpx."):
                name = f"{run} {_short(e.key)}"
                device[name] = device.get(name, 0.0) \
                    + e.self_device_time_total / 1e3 / reps
    return host, device


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
    from trpx_tpu_torch.ops.coding import _pad_batch
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

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> "
          f"{so.relative_to(_build.CSRC.parent.parent)}", flush=True)

    def inputs(fr, block=12):
        """Device inputs of the kernels for frames `fr` (F, n) in blocks of
        `block` values."""
        spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype, block)
        x = torch.from_numpy(_pad_batch(fr, spec)).to(dev)
        widths, words = walk_archive(ncodec.encode(fr, block=block), spec)
        return dict(spec=spec, x=x, odt=decoded_dtype(spec),
                    wd=torch.from_numpy(widths.astype(np.uint8)).to(dev),
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
        pixels_out = F * spec.n * (2 if odt == torch.uint16 else 4)
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
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
