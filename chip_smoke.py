"""Smoke run of trpx_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, ``trpx_tpu_torch.compress`` -> ``.trpx`` ->
``trpx_tpu_torch.decompress``, on 256 seeded 512x512 uint16 diffraction-like
frames (Poisson(3) with hot pixels at 65535), through the hand-written CUDA
pack and unpack kernels. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernels' build from ``trpx_tpu_torch/csrc`` (seconds);
3. each kernel against its plain PyTorch version on the card, exactly
   (lossless integer codec: tolerance 0), at the main path's shape and on
   an all-zero frame, partial blocks (n = 1000, n = 100) and every other
   device dtype;
4. the main path: archive bytes equal the native host codec's, pixels
   round-trip exactly, a natively encoded ("foreign") archive decodes to
   the same pixels, and both kernels' launch counters moved;
5. kernel and plain-version times (CUDA events) and frames/s.

It then prints the card line, a JSON line of per-kernel results and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; so does a machine without CUDA. Imports nothing of JAX.
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


def _frames(rng, F, n, dtype=np.uint16, hot=200):
    """Poisson(3) frames with `hot` pixels per frame at the dtype's max."""
    fr = rng.poisson(3.0, (F, n)).astype(dtype)
    if hot:
        rows = np.repeat(np.arange(F), hot)
        fr[rows, rng.integers(0, n, F * hot)] = np.iinfo(dtype).max
    return fr


def _signed_frames(rng, F, n, dtype):
    info = np.iinfo(dtype)
    fr = rng.integers(-300, 300, (F, n)).clip(info.min, info.max)
    fr = fr.astype(dtype)
    fr[0, 0] = info.min
    fr[-1, -1] = info.max
    return fr


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (as int64)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    return int((a - b).abs().max().item()) if a.numel() else 0


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def main() -> int:
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the shared host codec builds with $CXX -fopenmp; a CXX that cannot
    # (missing, or without OpenMP) would leave it unbuilt and every header
    # walk in pure Python
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        print(f"CXX={cxx} cannot build OpenMP code: the host codec builds "
              f"with g++ from PATH")
        del os.environ["CXX"]
    os.environ.setdefault("TRPX_NATIVE_CACHE", str(
        Path(__file__).resolve().parent / "trpx_tpu_torch" / "_build"
        / "native"))
    from trpx_tpu import native
    from trpx_tpu.format.pycodec import TrpxArchive
    from trpx_tpu.native import codec as ncodec

    import trpx_tpu_torch
    from trpx_tpu_torch import _build
    from trpx_tpu_torch.ops import (
        FrameSpec,
        decode_batch,
        decode_batch_plain,
        decoded_dtype,
        encode_batch,
        encode_batch_plain,
        walk_archive,
    )
    from trpx_tpu_torch.ops.coding import _pad_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda:0")
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | native host codec {native.available()}",
          flush=True)
    if not native.available():
        raise RuntimeError("the native host codec (trpx_tpu.native) did not build")

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> "
          f"{so.relative_to(_build.CSRC.parent.parent)}", flush=True)

    # phase 3: kernels against their plain versions on the card
    rng = np.random.default_rng(SEED)
    n_main = SIDE * SIDE
    main = _frames(rng, F_MAIN, n_main)
    cases = [
        ("512x512 u16 x256", main),
        ("all-zero 512x512 u16", np.zeros((1, n_main), np.uint16)),
        ("n=1000 u16", _frames(rng, 3, 1000, hot=5)),
        ("n=100 u16", _frames(rng, 3, 100, hot=2)),
        ("n=1000 u8", _frames(rng, 3, 1000, np.uint8, hot=5)),
        ("n=1000 u32", _frames(rng, 3, 1000, np.uint32, hot=5)),
        ("n=1000 i8", _signed_frames(rng, 3, 1000, np.int8)),
        ("n=1000 i16", _signed_frames(rng, 3, 1000, np.int16)),
        ("n=1001 i32", _signed_frames(rng, 3, 1001, np.int32)),
    ]
    err = {"pack": 0, "unpack": 0}
    main_inputs = {}
    for name, fr in cases:
        spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype)
        x = torch.from_numpy(_pad_batch(fr, spec)).to(dev)
        got = encode_batch(spec, x)
        want = encode_batch_plain(spec, x)
        e = max(_diff(g, w) for g, w in zip(got, want))
        if e:
            raise AssertionError(f"pack kernel != plain on {name}: max abs "
                                 f"err {e}")
        arch = ncodec.encode(fr)
        widths, words = walk_archive(arch, spec)
        wd = torch.from_numpy(widths.astype(np.uint8)).to(dev)
        wo = torch.from_numpy(words.view(np.int32)).to(dev)
        odt = decoded_dtype(spec)
        out = decode_batch(spec, wo, wd, odt)
        ref = decode_batch_plain(spec, wo, wd, odt)
        d = _diff(out, ref)
        if d:
            raise AssertionError(f"unpack kernel != plain on {name}: max abs "
                                 f"err {d}")
        vals = out.cpu().numpy()
        if not np.array_equal(vals.astype(fr.dtype), fr):
            raise AssertionError(f"unpack kernel lost pixels on {name}")
        if name == cases[0][0]:
            err = {"pack": e, "unpack": d}
            main_inputs = dict(spec=spec, x=x, wo=wo, wd=wd, odt=odt)
        del got, want, out, ref
    torch.cuda.synchronize()
    print(f"phase 3 kernels == plain versions on {len(cases)} inputs "
          f"(exact)", flush=True)

    # phase 4: the main path, with the launch counters
    stack = main.reshape(F_MAIN, SIDE, SIDE)
    native_arch = ncodec.encode(main, dimensions=(SIDE, SIDE))
    encode_batch.launches = 0
    decode_batch.launches = 0
    t0 = time.perf_counter()
    arch = trpx_tpu_torch.compress(stack, device="cuda")
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = trpx_tpu_torch.decompress(arch, device="cuda")
    t_dec = time.perf_counter() - t0
    launches = {"pack": encode_batch.launches, "unpack": decode_batch.launches}
    foreign = TrpxArchive.from_bytes(native_arch.to_bytes())
    t0 = time.perf_counter()
    back_foreign = trpx_tpu_torch.decompress(foreign, device="cuda")
    t_foreign = time.perf_counter() - t0
    if arch.to_bytes() != native_arch.to_bytes():
        raise AssertionError("compress(device='cuda') bytes differ from the "
                             "native codec's")
    if back.shape != stack.shape or back.dtype != stack.dtype \
            or not np.array_equal(back, stack):
        raise AssertionError("decompress(device='cuda') did not round-trip")
    if not np.array_equal(back_foreign, stack):
        raise AssertionError("foreign archive decoded to other pixels")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    raw = stack.nbytes
    print(f"phase 4 main path: {F_MAIN}x{SIDE}x{SIDE} u16, "
          f"{raw / 1e6:.1f} MB -> {arch.meta.memory_size / 1e6:.3f} MB, "
          f"bytes == native codec, lossless, foreign decode ok, launches "
          f"{launches}; host clock compress {t_enc * 1e3:.1f} ms, "
          f"decompress {t_dec * 1e3:.1f} ms, foreign decompress "
          f"{t_foreign * 1e3:.1f} ms", flush=True)

    # phase 5: kernel vs plain version at the main path's shape
    m = main_inputs
    spec, x, wo, wd, odt = m["spec"], m["x"], m["wo"], m["wd"], m["odt"]
    ms = {
        "pack": _time_ms(lambda: encode_batch(spec, x), 20),
        "unpack": _time_ms(lambda: decode_batch(spec, wo, wd, odt), 20),
    }
    plain_ms = {
        "pack": _time_ms(lambda: encode_batch_plain(spec, x), 3),
        "unpack": _time_ms(lambda: decode_batch_plain(spec, wo, wd, odt), 3),
    }
    fps = {k: F_MAIN / (v / 1e3) for k, v in ms.items()}
    plain_fps = {k: F_MAIN / (v / 1e3) for k, v in plain_ms.items()}
    print(f"phase 5 times ({card}), {F_MAIN} frames 512x512 u16 per call: "
          f"pack kernel {ms['pack']} ms = {fps['pack']} frames/s, plain "
          f"{plain_ms['pack']} ms = {plain_fps['pack']} frames/s; unpack "
          f"kernel {ms['unpack']} ms = {fps['unpack']} frames/s, plain "
          f"{plain_ms['unpack']} ms = {plain_fps['unpack']} frames/s; "
          f"end to end compress {F_MAIN / t_enc} frames/s, decompress "
          f"{F_MAIN / t_dec} frames/s", flush=True)

    kernels = [
        {"name": "pack", "route": "cuda",
         "source": "trpx_tpu_torch/csrc/pack.cu",
         "replaces": "trpx_tpu/ops/pallas_pack.py:712",
         "launches": launches["pack"], "max_abs_err": err["pack"],
         "ms": ms["pack"], "plain_ms": plain_ms["pack"]},
        {"name": "unpack", "route": "cuda",
         "source": "trpx_tpu_torch/csrc/unpack.cu",
         "replaces": "trpx_tpu/ops/pallas_unpack.py:626",
         "launches": launches["unpack"], "max_abs_err": err["unpack"],
         "ms": ms["unpack"], "plain_ms": plain_ms["unpack"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
