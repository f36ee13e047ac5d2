"""Micro-benchmark of the port's native header walk (the foreign-archive
decode's serial step), ``native.walk`` on the two flagship workloads: the
counterpart of ``tools/walk_bench.py``.

    python -m trpx_tpu_torch.tools.walk_bench [F512] [F2k]

Host only: the archives come from the port's native encoder. Times are the
host clock (least of 5) of the walk with block offsets, without them, and
with the production ``max_width`` hint (the branchless wide-stream loop
for overflow-heavy streams).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import native


def synth(F, n, dtype, hot_val, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, size=(F, n)).astype(dtype)
    hot = rng.random((F, n)) < 200.0 / n
    x[hot] = hot_val
    return x


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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
