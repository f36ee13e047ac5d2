"""Benchmark of the port: TRPX encode and decode rates on the card, at the
configurations of the repo's ``bench.py``.

    python -m trpx_tpu_torch.bench [n_frames] [reps] [--device DEV]

Defaults: 512 frames and 7 reps, on the card (``--device cpu`` runs the
kernels' plain PyTorch versions, timed by the host clock: no device
metric). Prints, on stderr, the card's name and power limit, the kernel
each configuration was routed to and the share of the card's memory rate
(3.35 TB/s) that the encode ingests, and, as the last line of stdout, one
JSON object with the keys of ``bench.py``'s (``summary``):

* 512x512 uint16 frames (``bench_512``): encode and decode rates of the
  routed kernels on resident batches, the host header walk, the foreign
  first-contact decode (walk, then unpack, no overlap) and the pipelined
  foreign decode (``runtime.stream.iter_decode`` with ``fetch=False``);
* 2048x2048 (32 frames) and 4096x4096 (8 frames) uint32 frames with
  overflow-heavy hot pixels (``bench_big``), the same rates.

Frames are synthesized on the device from an explicit ``torch.Generator``
(Poisson(3) with 200 hot pixels a frame, the workload of ``BASELINE.md``)
into several distinct resident batches, and the timed calls rotate over
them. Encode and decode times are device times per call
(``runtime.metrics.device_ms``), with the CUDA-event time of a loop of
calls (``event_ms``) beside them on stderr. Before any timing, the first
batch of each configuration is checked: its archive must equal the native
host codec's bytes and its decode must return the frames; on a mismatch
the bench raises and prints no rate.

The port times its kernels directly, so ``bench.py``'s chain-slope
estimator, capacity schedules, staging layouts, XLA cache and discovery
watchdog have no counterpart here, nor has ``tile_prepass``: the tiled
unpack scans its tile offsets on the card, inside the decode's time.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import api as _api
from . import native
from .format.pycodec import TrpxArchive
from .native import codec as ncodec
from .ops.coding import (
    FrameSpec,
    assemble_archive,
    decoded_dtype,
    encode_collect,
    encode_dispatch,
    narrow_values,
    pack_kernel,
    unpack_kernel,
    walk_archive,
)
from .runtime.metrics import device_ms, event_ms
from .runtime.stream import iter_decode

REFERENCE_FPS = 1712.0       # reference encoder, 1 CPU core (BASELINE.md)
REFERENCE_DECODE_FPS = 2061.0
REFERENCE_2K_FPS = 54.0      # 0.9 GB/s on 16.8 MB 2048² u32 frames
REFERENCE_4K_FPS = 13.5      # 0.9 GB/s on 67 MB 4096² u32 frames

#: device memory rate of an H100 SXM, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: hot pixels per synthesized frame, and their values
HOT_PIXELS = 200
HOT_U16 = 60000
HOT_U32 = 2_000_000_000
#: frames synthesized at once (bounds the Poisson sampler's temporaries)
SYNTH_CHUNK = 256
#: (edge, frames, reference frames/s) of the big-frame configurations
BIG = ((2048, 32, REFERENCE_2K_FPS), (4096, 8, REFERENCE_4K_FPS))


class GuardError(RuntimeError):
    """The codec under test disagreed with the native codec or with the
    frames: no rate is measured."""


def synth(spec: FrameSpec, F: int, hot_value: int, seed: int,
          device) -> torch.Tensor:
    """(F, spec.n_padded) frames of the spec's dtype (uint16 or uint32) on
    ``device``: Poisson(3) with ``HOT_PIXELS`` pixels a frame at
    ``hot_value``, zero past ``spec.n``, drawn from a ``torch.Generator``
    on the device seeded from (`seed`, `F`), ``SYNTH_CHUNK`` frames at a
    time."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 977 * F)
    x = torch.zeros((F, spec.n_padded), dtype=torch.int32, device=dev)
    for lo in range(0, F, SYNTH_CHUNK):
        Fc = min(SYNTH_CHUNK, F - lo)
        rate = torch.full((Fc, spec.n), 3.0, device=dev)
        x[lo : lo + Fc, : spec.n] = torch.poisson(rate, generator=gen).to(
            torch.int32)
        del rate
        hot = torch.randint(0, spec.n, (Fc, HOT_PIXELS), generator=gen,
                            device=dev)
        x[lo : lo + Fc].scatter_(1, hot, hot_value)
    if spec.torch_dtype == torch.uint16:
        return torch.where(x >= 1 << 15, x - (1 << 16), x).to(
            torch.int16).view(torch.uint16)
    if spec.torch_dtype == torch.uint32:
        return x.view(torch.uint32)
    raise ValueError(f"synth makes uint16 or uint32 frames, not {spec}")


def _host_frames(spec: FrameSpec, x: torch.Tensor) -> np.ndarray:
    """The (F, n) frames of a padded device batch, on the host."""
    return x[:, : spec.n].cpu().numpy()


def _per_call_ms(fn, iters: int, dev: torch.device) -> tuple[float, float]:
    """(device ms, CUDA-event ms) per call of `fn` on the card; on the CPU
    the host clock per call, twice."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return device_ms(fn, iters), event_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, ms


def _encode(spec: FrameSpec, x: torch.Tensor) -> TrpxArchive:
    """The archive of one resident batch, through ``ops.coding``'s routed
    pack."""
    return assemble_archive(spec, *encode_collect(encode_dispatch(spec, x)))


def _unpack_inputs(spec: FrameSpec, arch: TrpxArchive, dev: torch.device):
    """The header walk's words and widths of `arch`, on `dev`."""
    widths, words = walk_archive(arch, spec)
    return (torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(widths).to(dev))


def _guard_archive(name: str, frames: np.ndarray, spec: FrameSpec,
                   arch: TrpxArchive) -> None:
    """Raise GuardError unless `arch` equals the native codec's bytes of
    `frames`."""
    if arch.to_bytes() != ncodec.encode(frames, block=spec.block).to_bytes():
        raise GuardError(f"{name}: the routed pack's archive differs from "
                         f"the native codec's bytes")


def _guard_decode(name: str, frames: np.ndarray,
                  decoded: torch.Tensor) -> None:
    """Raise GuardError unless `decoded`, the routed unpack's output, holds
    `frames`."""
    if not np.array_equal(narrow_values(decoded.cpu().numpy(), frames.dtype),
                          frames):
        raise GuardError(f"{name}: the routed unpack did not return the "
                         f"frames")


def _walk_s(arch: TrpxArchive, spec: FrameSpec, reps: int) -> float:
    """Median seconds of the serial header walk and gather
    (``ops.coding.walk_archive``) of fresh index-free views of `arch`
    (``walk_archive`` caches its tables on the archive), sharing its
    padded payload copy."""
    ts = []
    for _ in range(reps):
        cold = TrpxArchive(meta=arch.meta, payload=arch.payload)
        cold._padded_buf = getattr(arch, "_padded_buf", None)
        t0 = time.perf_counter()
        walk_archive(cold, spec)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _pipelined_s(arch: TrpxArchive, dtype, C: int, reps: int,
                 dev: torch.device) -> float:
    """Least wall seconds over `reps` (after a warm run) of
    ``iter_decode(..., fetch=False)`` of a fresh index-free view of `arch`
    in `C`-frame chunks: the chunked walk overlapping the device unpack,
    pixels left on the device; a corner of every chunk is summed on the
    device and read at the end, which drains the pipeline."""
    def once():
        cold = TrpxArchive(meta=arch.meta, payload=arch.payload)
        t0 = time.perf_counter()
        chk = torch.zeros((), dtype=torch.int64, device=dev)
        for out, _nf in iter_decode(cold, dtype, chunk_frames=C,
                                    device=dev, fetch=False):
            corner = out[0, 0]
            if corner.dtype == torch.uint16:
                corner = corner.view(torch.int16)
            chk += corner.to(torch.int64)
        int(chk)
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(reps))


def _run(name: str, dtype, edge: int, F: int, hot_value: int, seeds,
         reps: int, walk_reps: int, chunk: int, dev: torch.device) -> dict:
    """`edge` x `edge` frames of `dtype`: synthesize one resident batch
    per seed, check the first, then time the routed pack and unpack
    (rotating over the batches), the walk, the foreign and the pipelined
    foreign decode."""
    spec = FrameSpec.for_dtype(edge * edge, dtype)
    if not native.available():
        raise RuntimeError("the native host codec (trpx_tpu_torch.native) "
                           "did not build: the bench has no byte oracle")
    xs = [synth(spec, F, hot_value, s, dev) for s in seeds]
    pack, unpack = pack_kernel(spec, F), unpack_kernel(spec, F)
    odt = decoded_dtype(spec)
    frames = _host_frames(spec, xs[0])
    archs = [_encode(spec, x) for x in xs]
    arch = archs[0]
    _guard_archive(name, frames, spec, arch)
    inputs = [_unpack_inputs(spec, a, dev) for a in archs]
    _guard_decode(name, frames, unpack(spec, *inputs[0], odt))
    del frames, archs[1:]

    batches = itertools.cycle(xs)
    enc_ms, enc_event_ms = _per_call_ms(lambda: pack(spec, next(batches)),
                                        len(xs) * reps, dev)
    rotation = itertools.cycle(inputs)
    dec_ms, dec_event_ms = _per_call_ms(
        lambda: unpack(spec, *next(rotation), odt), len(xs) * reps, dev)
    del inputs, rotation
    walk_s = _walk_s(arch, spec, walk_reps)
    pipe_s = _pipelined_s(arch, dtype, chunk, walk_reps, dev)
    raw = F * spec.n * xs[0].element_size()
    return dict(
        pack=pack.__name__, unpack=unpack.__name__, frames=F,
        enc_ms=enc_ms, enc_event_ms=enc_event_ms, dec_ms=dec_ms,
        dec_event_ms=dec_event_ms, walk_s=walk_s, pipe_s=pipe_s,
        enc_fps=F / enc_ms * 1e3, dec_fps=F / dec_ms * 1e3,
        enc_gbs=raw / enc_ms / 1e6,
        walk_fps=F / walk_s,
        # first contact with a foreign archive: the serial walk, then the
        # unpack, no overlap assumed
        foreign_fps=F / (walk_s + dec_ms / 1e3),
        pipelined_fps=F / pipe_s,
        ratio=arch.meta.memory_size / raw)


def bench_512(F: int = 512, reps: int = 7, device=None, n2: int = 9) -> dict:
    """512x512 uint16 frames: `n2` distinct resident batches of `F`
    frames; the timed loops make `reps` calls on each. ``device``: None
    means the card (RuntimeError without one)."""
    dev = _api._torch_device(device)
    return _run("512x512 u16", np.uint16, 512, F, HOT_U16, range(n2), reps,
                max(3, min(reps, 5)), max(32, F // 4), dev)


def bench_big(reps: int = 5, edge: int = 2048, F: int = 32, device=None,
              n2: int = 5) -> dict:
    """`edge` x `edge` uint32 frames with hot pixels at 2,000,000,000 (32-
    bit fields in every hot block): `n2` distinct resident batches of `F`
    frames, as :func:`bench_512`."""
    dev = _api._torch_device(device)
    return _run(f"{edge}x{edge} u32", np.uint32, edge, F, HOT_U32,
                range(2, 2 + n2), reps, 3, max(2, F // 4), dev)


def summary(r512: dict, big: dict) -> dict:
    """The JSON object of ``bench.py``, key for key, from
    :func:`bench_512`'s result and ``big``, :func:`bench_big`'s result by
    edge (2048 and 4096)."""
    out = {
        "metric": "encode_512x512_u16_frames_per_s",
        "value": round(r512["enc_fps"], 1),
        "unit": "frames/s",
        "vs_baseline": round(r512["enc_fps"] / REFERENCE_FPS, 2),
        "decode_512x512_u16_frames_per_s": round(r512["dec_fps"], 1),
        "decode_vs_reference": round(r512["dec_fps"] / REFERENCE_DECODE_FPS,
                                     2),
        "host_walk_frames_per_s": round(r512["walk_fps"], 1),
        "foreign_decode_512x512_u16_frames_per_s": round(
            r512["foreign_fps"], 1),
        "foreign_pipelined_512x512_u16_frames_per_s": round(
            r512["pipelined_fps"], 1),
    }
    for edge, _F, ref_fps in BIG:
        rb = big[edge]
        out.update({
            f"encode_{edge}x{edge}_u32_frames_per_s": round(rb["enc_fps"], 1),
            f"decode_{edge}x{edge}_u32_frames_per_s": round(rb["dec_fps"], 1),
            f"foreign_decode_{edge}x{edge}_u32_frames_per_s": round(
                rb["foreign_fps"], 1),
            f"encode_{edge}_vs_reference": round(rb["enc_fps"] / ref_fps, 2),
            f"foreign_pipelined_{edge}x{edge}_u32_frames_per_s": round(
                rb["pipelined_fps"], 1),
        })
    return out


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def describe(name: str, r: dict, dev: torch.device) -> str:
    """One stderr line of a configuration's routes and rates."""
    share = (f", {100 * r['enc_gbs'] * 1e9 / HBM_BYTES_PER_S:.2f}% of "
             f"3.35 TB/s ingested" if dev.type == "cuda" else "")
    return (f"{name} x{r['frames']}: encode [{r['pack']}] "
            f"{r['enc_fps']:,.1f} frames/s ({r['enc_ms']:.4f} ms device, "
            f"{r['enc_event_ms']:.4f} ms events; {r['enc_gbs']:.1f} GB/s raw "
            f"in{share}); decode [{r['unpack']}] {r['dec_fps']:,.1f} frames/s "
            f"({r['dec_ms']:.4f} ms device, {r['dec_event_ms']:.4f} ms "
            f"events); host walk {r['walk_fps']:,.1f} frames/s; foreign "
            f"{r['foreign_fps']:,.1f}; pipelined foreign "
            f"{r['pipelined_fps']:,.1f} frames/s (iter_decode, "
            f"device-resident); compressed/raw {r['ratio']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpx_tpu_torch.bench",
        description="TRPX encode/decode rates of the port's kernels.")
    ap.add_argument("n_frames", nargs="?", type=int, default=512,
                    help="frames per 512x512 batch (default 512)")
    ap.add_argument("reps", nargs="?", type=int, default=7,
                    help="calls on each batch in the timed loops (default 7)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions, timed by the host clock)")
    a = ap.parse_args(argv)
    dev = _api._torch_device(a.device)
    if dev.type == "cuda":
        print(f"card: {card_line(dev)}", file=sys.stderr)
    else:
        print(f"device {dev}: the kernels' plain PyTorch versions, timed by "
              f"the host clock; these are not device rates", file=sys.stderr)
    r512 = bench_512(a.n_frames, a.reps, dev)
    print(describe("512x512 u16", r512, dev), file=sys.stderr, flush=True)
    big = {}
    for edge, F, _ref in BIG:
        big[edge] = bench_big(max(3, min(a.reps, 5)), edge, F, dev)
        print(describe(f"{edge}x{edge} u32", big[edge], dev),
              file=sys.stderr, flush=True)
    print(json.dumps(summary(r512, big)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
