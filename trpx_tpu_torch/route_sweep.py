"""Times the two kernel routes of ``ops.coding`` on one CUDA card, to set
the routes of ``FrameSpec.tiled`` (which decodes take the tiled unpack).

    python3 -m trpx_tpu_torch.route_sweep [--out PATH]

For 512x512 and 1024x1024 uint16 and 2048x2048 and 4096x4096 uint32
frames in blocks of 12, and 2048x2048 int32 frames in blocks of 1,024 (the
wide-block path), all Poisson(3) with 200 hot pixels a frame at the
dtype's max, made on the card from torch seed 0, and batches of 1 to 256
frames (64 at 4096x4096, 32 in wide blocks), it takes each pack and unpack
wrapper's device time per call (``runtime.metrics.device_ms``, scratch
fills included): ``encode_batch`` / ``decode_batch`` (the one-pass kernels
of ``csrc/pack.cu`` and ``csrc/unpack.cu``) against
``encode_batch_tiled`` / ``decode_batch_tiled`` (``csrc/pack_tiled.cu``,
``csrc/unpack_tiled.cu``), after checking that both routes give the same
words and pixels (the one-pass pack cannot tile wide blocks: there only
the tiled pack runs, and the decodes are checked against the frames).
Prints one line per shape and batch, then for each shape the batches on
which the tiled unpack was faster and, last, a JSON object of all the
times with the card's name and power limit (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .ops import (
    FrameSpec,
    decode_batch,
    decode_batch_tiled,
    decoded_dtype,
    encode_batch,
    encode_batch_tiled,
)
from .ops.coding import _fits
from .ops.cuda_pack import block_widths, pack_geometry, stream_words
from .runtime.metrics import device_ms

#: (side, dtype, block, most frames) of the frame classes, and the batch
#: sizes
SHAPES = ((512, np.uint16, 12, 256), (1024, np.uint16, 12, 256),
          (2048, np.uint32, 12, 256), (4096, np.uint32, 12, 64),
          (2048, np.int32, 1024, 32))
FRAMES = (1, 2, 3, 4, 8, 12, 16, 24, 32, 64, 128, 192, 256)


def _batch(spec, dtype, F: int, dev) -> torch.Tensor:
    """(F, n_padded) frames on the card, zero past n, built in the signed
    type of the same width (an unsigned dtype's max is -1 there)."""
    g = torch.Generator(device=dev).manual_seed(0)
    n = spec.n
    sdt = {np.uint16: torch.int16, np.uint32: torch.int32,
           np.int32: torch.int32}[dtype]
    hot = -1 if np.iinfo(dtype).min == 0 else np.iinfo(dtype).max
    x = torch.zeros((F, spec.n_padded), dtype=sdt, device=dev)
    x[:, :n] = torch.poisson(torch.full((F, n), 3.0, device=dev),
                             generator=g).to(sdt)
    cols = torch.randint(0, n, (F, 200), generator=g, device=dev)
    x.scatter_(1, cols, torch.full((F, 200), hot, dtype=sdt, device=dev))
    return x.view(spec.torch_dtype)


def sweep(dev) -> list[dict]:
    rows = []
    for side, dtype, block, most in SHAPES:
        spec = FrameSpec.for_dtype(side * side, dtype, block)
        x_all = _batch(spec, dtype, most, dev)
        name = f"{side}^2 {np.dtype(dtype).name} b{block}"
        one_pass = _fits(pack_geometry, spec)
        for F in (F for F in FRAMES if F <= most):
            x = x_all[:F]
            words, bits, maxw = encode_batch_tiled(spec, x)
            if one_pass:
                one = encode_batch(spec, x)
                if not (torch.equal(bits, one[1]) and torch.equal(maxw, one[2])
                        and torch.equal(stream_words(one[0], bits),
                                        stream_words(words, bits))):
                    raise AssertionError(f"pack routes differ at {F} x {name}")
                del one
            widths = torch.cat([block_widths(spec, x[f : f + 8])[1]
                                for f in range(0, F, 8)]).to(torch.uint8)
            odt = decoded_dtype(spec)
            out = decode_batch(spec, words, widths, odt)
            if not torch.equal(out, decode_batch_tiled(spec, words, widths,
                                                       odt)):
                raise AssertionError(f"unpack routes differ at {F} x {name}")
            if not one_pass and not torch.equal(out[:, : spec.n],
                                                   x[:, : spec.n]):
                raise AssertionError(f"decode lost values at {F} x {name}")
            del out
            row = dict(
                side=side, dtype=np.dtype(dtype).name, block=block, frames=F,
                nb=spec.nb,
                pack_ms=None if not one_pass else device_ms(
                    lambda: encode_batch(spec, x), 5),
                pack_tiled_ms=device_ms(lambda: encode_batch_tiled(spec, x),
                                        5),
                unpack_ms=device_ms(
                    lambda: decode_batch(spec, words, widths, odt), 5),
                unpack_tiled_ms=device_ms(
                    lambda: decode_batch_tiled(spec, words, widths, odt), 5))
            pack = "-" if row["pack_ms"] is None else f"{row['pack_ms']:.4f}"
            print(f"{F:4d} x {name}: pack {pack} (tiled "
                  f"{row['pack_tiled_ms']:.4f}) ms, unpack "
                  f"{row['unpack_ms']:.4f} (tiled {row['unpack_tiled_ms']:.4f})"
                  f" ms", flush=True)
            rows.append(row)
            del words, bits, maxw, widths
        del x_all
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("route_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    rows = sweep(torch.device("cuda"))
    for side, dtype, block, _ in SHAPES:
        won = [r["frames"] for r in rows
               if (r["side"], r["block"]) == (side, block)
               and r["unpack_tiled_ms"] < r["unpack_ms"]]
        print(f"{side}^2 {np.dtype(dtype).name} b{block}: tiled unpack "
              f"faster at {won or 'no'} frames", flush=True)
    result = {"card": card, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
