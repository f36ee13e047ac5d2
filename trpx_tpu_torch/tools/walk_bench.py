"""Micro-benchmark of the port's header walks: the native host walk (the
foreign-archive decode's serial step), ``native.walk`` on the two flagship
workloads, the counterpart of ``tools/walk_bench.py``; and with
``--card``, the card's walk of single frames against the host's.

    python -m trpx_tpu_torch.tools.walk_bench [F512] [F2k]
    python -m trpx_tpu_torch.tools.walk_bench --card [--out PATH]

Host walk: the archives come from the port's native encoder. Times are
the host clock (least of 5) of the walk with block offsets, without them,
and with the production ``max_width`` hint (the branchless wide-stream
loop for overflow-heavy streams).

``--card`` (a CUDA card): for one frame of each class (128x128 to
1024x1024 u16 and 2048x2048 and 4096x4096 u32, Poisson(3) with hot
pixels, and a 4362x4148 u32 image on the EIGER2 X 16M's module grid,
:func:`gapped_image`), the host-clock median of ``ops.decode`` of the
parsed bytes walked on the host (``walk_chunks``) and on the card
(``cuda_walk.walk_frame``), which sets ``WALK_ON_CARD_MIN_BLOCKS``; and
for each part size of ``SEQ_BITS`` (set as ``cuda_walk.WALK_BITS``), the
card walk's rounds, its kernels' device time (``torch.profiler``) and its
host-clock time. Prints a line a
frame and a JSON object of everything with the card's name and power
limit (also written to ``--out``).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

from .. import native

#: the EIGER2 X 16M's module grid (portbench/configs/eiger2x16m_u32.json):
#: 4 x 8 modules of 1028 x 512 pixels, 12 gap columns and 38 gap rows
EIGER_GRID = (4, 8, 1028, 512, 12, 38)
#: part sizes of the card walk's sweep
SEQ_BITS = (2048, 4096, 8192, 16384)


def synth(F, n, dtype, hot_val, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, size=(F, n)).astype(dtype)
    hot = rng.random((F, n)) < 200.0 / n
    x[hot] = hot_val
    return x


def gapped_image(seed=0, grid=EIGER_GRID) -> np.ndarray:
    """(1, h * w) u32 of one image on a module grid (by default the EIGER2
    X 16M's, 4362 x 4148): Poisson(0.5) a pixel, one spot at 10,000 per
    4,524 pixels (4,000 an EIGER2 X 16M image), every pixel between the
    modules at 2^32 - 1."""
    cols, rows, mw, mh, gc, gr = grid
    h, w = rows * (mh + gr) - gr, cols * (mw + gc) - gc
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.5, (h, w)).astype(np.uint32)
    x.reshape(-1)[rng.integers(0, h * w, h * w // 4524)] = 10000
    gap = ((np.arange(h) % (mh + gr) >= mh)[:, None]
           | (np.arange(w) % (mw + gc) >= mw)[None, :])
    x[gap] = 2**32 - 1
    return x.reshape(1, -1)


def _least_s(fn, reps: int) -> float:
    fn()  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def bench(name, frames, block=12, reps=5) -> float:
    """Print the walk rates of `frames`; return the production walk's
    frames/s."""
    F, n = frames.shape
    payload, _fstarts, prolix = native.encode_frames(
        frames, block, frames.dtype.kind == "i")
    buf = native.padded_buffer(payload)
    nb = -(-n // block)
    t = _least_s(lambda: native.walk(buf, F, n, block), reps)
    tn = _least_s(lambda: native.walk(buf, F, n, block, want_poffs=False),
                  reps)
    tw = _least_s(lambda: native.walk(buf, F, n, block, want_poffs=False,
                                      max_width=prolix), reps)
    blocks = F * nb
    print(
        f"{name}: {F / t:,.0f} fps walk ({blocks / t / 1e6:.1f} Mblk/s, "
        f"{len(payload) / t / 1e9:.2f} GB/s through) | no-poffs {F / tn:,.0f} fps"
        f" | prod (wide={int(prolix > 16)}) {F / tw:,.0f} fps "
        f"({blocks / tw / 1e6:.1f} Mblk/s)"
        f" | payload {len(payload) / 1e6:.1f} MB, prolix {prolix}"
    )
    return F / tw


def _walk_device_ms(fn, reps: int = 5) -> float:
    """Device ms per call of the walk's kernels and memsets that ``fn``
    launches: a ``torch.profiler`` window over ``reps`` calls after a warm
    one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and ("walk_" in e.key or e.key.startswith("Memset"))
               ) / 1e3 / reps


def _median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def card_frames() -> dict:
    """The sweep's single frames by name."""
    return {
        "128x128 u16": synth(1, 128 * 128, np.uint16, 60000, seed=7),
        "256x256 u16": synth(1, 256 * 256, np.uint16, 60000, seed=8),
        "256x512 u16": synth(1, 256 * 512, np.uint16, 60000, seed=9),
        "512x512 u16": synth(1, 512 * 512, np.uint16, 60000, seed=1),
        "512x1024 u16": synth(1, 512 * 1024, np.uint16, 60000, seed=6),
        "1024x1024 u16": synth(1, 1024 * 1024, np.uint16, 60000, seed=2),
        "2048x2048 u32": synth(1, 2048 * 2048, np.uint32, 2_000_000_000,
                               seed=3),
        "4096x4096 u32": synth(1, 4096 * 4096, np.uint32, 2_000_000_000,
                               seed=4),
        "4362x4148 u32 gapped": gapped_image(seed=5),
    }


def card_sweep(reps: int = 15) -> dict:
    """The host walk against the card walk on one frame of each class,
    through ``ops.decode`` on the card (see the module docstring)."""
    import torch

    from ..format.pycodec import TrpxArchive
    from ..native import codec as ncodec
    from ..ops import FrameSpec, coding, cuda_walk
    from ..ops.cuda_walk import upload_stream, walk_frame

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    keep = coding.WALK_ON_CARD_MIN_BLOCKS, cuda_walk.WALK_BITS
    out = {"card": card, "frames": {}}
    try:
        for name, fr in card_frames().items():
            arch = ncodec.encode(fr)
            blob = arch.to_bytes()
            spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype)

            def decode():
                return coding.decode(TrpxArchive.from_bytes(blob), fr.dtype,
                                     device=dev)

            np.testing.assert_array_equal(decode()[0], fr[0])
            coding.WALK_ON_CARD_MIN_BLOCKS = 10**12
            row = {"blocks": spec.nb, "payload_bytes": len(arch.payload),
                   "host_walk_ms": _median_ms(decode, reps), "parts": {}}
            coding.WALK_ON_CARD_MIN_BLOCKS = 1
            words = upload_stream(arch.payload, dev)
            for L in SEQ_BITS:
                cuda_walk.WALK_BITS = L
                np.testing.assert_array_equal(decode()[0], fr[0])
                walk = walk_frame(spec, words, len(arch.payload))
                row["parts"][L] = {
                    "rounds": walk.rounds,
                    "walk_device_ms": _walk_device_ms(
                        lambda: walk_frame(spec, words, len(arch.payload))),
                    "walk_ms": _median_ms(
                        lambda: walk_frame(spec, words, len(arch.payload)),
                        reps),
                    "card_walk_ms": _median_ms(decode, reps)}
            cuda_walk.WALK_BITS = keep[1]
            out["frames"][name] = row
            print(f"{name} ({card}): {spec.nb} blocks, decode walked on the "
                  f"host {row['host_walk_ms']:.3f} ms; on the card "
                  + "; ".join(f"L={L}: {p['card_walk_ms']:.3f} ms, walk "
                              f"{p['walk_ms']:.3f} ms (device "
                              f"{p['walk_device_ms']:.4f}), rounds "
                              f"{p['rounds']}"
                              for L, p in row["parts"].items()), flush=True)
    finally:
        coding.WALK_ON_CARD_MIN_BLOCKS, cuda_walk.WALK_BITS = keep
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--card"]:
        got = card_sweep()
        print(json.dumps(got))
        if argv[1:2] == ["--out"]:
            with open(argv[2], "w") as f:
                json.dump(got, f)
        return 0
    if not native.available():
        raise RuntimeError("the native host codec (trpx_tpu_torch.native) "
                           "did not build")
    F512 = int(argv[0]) if len(argv) > 0 else 256
    F2k = int(argv[1]) if len(argv) > 1 else 8
    bench("512^2 u16 lam3", synth(F512, 512 * 512, np.uint16, 60000))
    bench("2048^2 u32 overflow", synth(F2k, 2048 * 2048, np.uint32,
                                       2_000_000_000, seed=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
