"""Randomized differential soak of the port's codec engines, and its fixed
smoke tier on the card: the counterpart of ``tools/differential_campaign.py``.

    python -m trpx_tpu_torch.tools.differential_campaign [n] [--device DEV]
    python -m trpx_tpu_torch.tools.differential_campaign --smoke [--device DEV]

Every trial draws a random (dtype, frame count, frame size, block, value
distribution), or takes a fixed row of the smoke tier, and requires:

* the native C++ encoder and the spec-as-code Python encoder
  (``format.pycodec``, the normative ground truth) give byte-identical
  archives, and both decoders return the pixels;
* when the device is in use (``--device``, or ``--smoke``) and the items
  are at most 4 bytes: the device path, ``ops.encode`` and ``ops.decode``
  on that device (the CUDA kernels on the card, their plain versions on
  the CPU), gives the same bytes and returns the pixels. These are the
  batch entry points, where a 2-D array is (frames, values);
  ``api.compress`` would take it for one image;
* inside the reference's verified-correct envelope, the archive equals
  the compiled reference encoder's output (``tests/oracle/encode_shim.cpp``
  built against the reference checkout that ``TRPX_REFERENCE`` names; no
  reference, no oracle check).

Rows of more than ``PYCODEC_MAX_VALUES`` values are held against the
native codec only: pycodec takes seconds per million values.

``--smoke`` runs the seeded rows of ``SMOKE_TRIALS`` (the JAX package's
table) and ``ROUTE_TRIALS`` (the port's kernel routes: the tiled and the
one-pass pack and unpack on either side of ``FrameSpec.tiled_pack`` and
``FrameSpec.tiled``) on the device, by default the card: the gate after
any change to a kernel. Without ``--device`` or ``--smoke`` the soak
checks the host codecs only, on random shapes; with ``--device`` it
draws its shapes from ``DEVICE_SHAPES``, as the JAX tool does, so a seed
of either tool's device soak replays in the other.

Prints progress every 250 trials; on the first mismatch prints
``MISMATCH:`` with the full repro (seed, dtype, shape, block) and returns
1.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from .. import api as _api
from .. import native, ops
from ..format import pycodec
from ..native import codec as ncodec

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
          np.int8, np.int16, np.int32, np.int64]

#: the oracle shim's source, and where it is built
_SHIM_SRC = Path(__file__).resolve().parents[2] / "tests" / "oracle" \
    / "encode_shim.cpp"
_SHIM = Path(__file__).resolve().parents[1] / "_build" / "oracle" \
    / "encode_shim"

#: rows of more values than this skip pycodec (about 16 s per 3.2M values
#: to encode and decode on one core)
PYCODEC_MAX_VALUES = 3_200_000


def build_oracle() -> Path | None:
    """The reference encoder shim, built on demand against the reference
    checkout named by ``TRPX_REFERENCE``; None without one."""
    ref = os.environ.get("TRPX_REFERENCE")
    if not ref or not (Path(ref) / "include" / "Terse.hpp").exists():
        return None
    if _SHIM.exists():
        return _SHIM
    if not _SHIM_SRC.exists():
        return None
    _SHIM.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-include", "cmath",
         f"-I{Path(ref) / 'include'}", str(_SHIM_SRC), "-o", str(_SHIM)],
        capture_output=True)
    return _SHIM if r.returncode == 0 else None


def _in_reference_envelope(vals: np.ndarray, block: int) -> bool:
    """SURVEY §2.1: the envelope where the reference encoder is correct."""
    dt = vals.dtype
    # B7: the reference under-reserves for tiny frames (reserve formula
    # size*(sizeof(T)+12/(block*8)) ignores that header bits dominate
    # when n is small) — its own trailing bytes are UB there
    if vals.shape[1] < 4 * block:
        return False
    if dt == np.uint32:
        return bool(vals.max(initial=0) < 2**31)
    if dt == np.uint64:
        return bool(vals.max(initial=0) < 2**32)
    if dt.kind == "i":
        bits = 8 * dt.itemsize
        # blocks restart at every frame (pycodec.encode resets per frame,
        # matching Terse.hpp:505) — grouping across the flattened array
        # would misalign membership whenever n % block != 0 and misroute
        # trials into/out of the oracle comparison
        for frame in vals:
            nb = -(-frame.size // block)
            for b in range(nb):
                blk = frame[b * block:(b + 1) * block].astype(np.int64)
                if (blk < 0).any():
                    if np.abs(blk).max() > 2 ** (bits - 2):
                        return False
                elif dt == np.int64 and blk.max(initial=0) >= 2**31:
                    return False
        return True
    return True


#: the device soak's palette of (F, n, block), the JAX tool's: there,
#: every new shape costs an XLA compile; here it keeps the two tools'
#: seeds interchangeable
DEVICE_SHAPES = [(1, 144, 12), (3, 144, 12), (2, 1000, 12), (4, 1000, 16),
                 (2, 4096, 12), (1, 4095, 12),
                 # big enough that u32/i32 dtypes exceed the VMEM budget
                 # and take the TILED kernels on real hardware (the other
                 # randomized tiled coverage is interpret-mode only);
                 # ~12 s of pycodec per hit, so exactly one palette entry
                 (1, 3_200_000, 12),
                 # the routing FRONTIER: 1M values sits untiled for
                 # encode but tiled for decode (pallas_ok 40 MB vs
                 # pallas_ok_decode 8 MB thresholds), mixing the kernel
                 # pairs within one round trip
                 (1, 1_048_576, 12)]


#: the JAX tool's smoke tier: a fixed, seeded pass over every shape class
#: of its kernels' regression ledger. Columns: (dtype, F, n, block, kind,
#: seed).
SMOKE_TRIALS = [
    # S==1 grid trap: n=4095 u32 hits C=128 at the phase-2 transition
    (np.uint32, 1, 4095, 12, 1, 101),
    (np.int32, 1, 4095, 12, 0, 102),
    # flagship whole-frame kernels, multi-frame, hot pixels
    (np.uint16, 4, 512 * 512, 12, 0, 103),
    (np.int16, 2, 512 * 512, 12, 1, 104),
    # tiled kernels on real hardware (u32/i32 exceed the VMEM budget)
    (np.uint32, 1, 3_200_000, 12, 1, 105),
    (np.int32, 1, 3_200_000, 12, 0, 106),
    # routing frontier: untiled encode + tiled decode in one trip
    (np.uint32, 1, 1_048_576, 12, 0, 107),
    (np.uint32, 1, 1_048_576, 12, 2, 108),
    # small shapes, both signedness, partial blocks, odd block sizes
    (np.uint8, 3, 144, 12, 3, 109),
    (np.uint16, 2, 1000, 12, 2, 110),
    (np.int16, 2, 1000, 12, 1, 111),
    (np.uint16, 4, 1000, 16, 0, 112),
    (np.int8, 2, 4096, 12, 1, 113),
    (np.uint32, 2, 4096, 12, 1, 114),
    # repeat-header stress (constant/zero runs) on the frontier shapes
    (np.uint32, 1, 3_200_000, 12, 2, 115),
    (np.uint16, 4, 512 * 512, 12, 2, 116),
    # ramps crossing block boundaries
    (np.uint32, 2, 4096, 12, 3, 117),
    (np.uint16, 2, 512 * 512, 12, 3, 118),
]

#: the port's kernel routes (``ops.coding``): encodes of 1-3 frames of
#: 2048x2048 and up take the tiled pack, 4 frames the one-pass pack;
#: decodes of 191 frames the tiled unpack, of 192 the one-pass unpack.
#: Same columns as ``SMOKE_TRIALS``.
ROUTE_TRIALS = [
    (np.uint32, 1, 2048 * 2048, 12, 0, 119),
    (np.uint32, 3, 2048 * 2048, 12, 1, 120),
    (np.uint32, 1, 4096 * 4096, 12, 2, 121),
    (np.uint32, 4, 2048 * 2048, 12, 0, 122),
    (np.uint16, 191, 4096, 12, 0, 123),
    (np.uint16, 192, 4096, 12, 3, 124),
]


def _gen_values(dtype, F, n, kind, rng):
    info = np.iinfo(dtype)
    # generate in int64 then clip into an int64-SAFE window of the dtype
    # (uint64's full range overflows int64; 2^62 still exercises >32-bit
    # field widths)
    lo, hi = int(info.min), min(int(info.max), 2**62)
    if kind == 0:  # sparse poisson + hot pixels (diffraction-like)
        v = rng.poisson(2.0, (F, n)).astype(np.int64)
        v[rng.random((F, n)) < 0.01] = min(hi, 60000)
    elif kind == 1:  # full-range uniform (endpoint=True so the dtype's
        # exact max — the all-ones width-boundary pattern — is reachable)
        v = rng.integers(lo, hi, (F, n), dtype=np.int64, endpoint=True)
    elif kind == 2:  # constant / zero runs (repeat-header stress)
        v = np.zeros((F, n), np.int64)
        v[:, :: max(1, n // 7)] = int(rng.integers(0, 100))
    else:  # block-boundary ramps
        v = (np.arange(F * n).reshape(F, n) % 97).astype(np.int64)
    return np.clip(v, lo, hi).astype(dtype)


def _rand_frames(rng: np.random.Generator, fixed_shapes: bool = False):
    dtype = np.dtype(DTYPES[rng.integers(0, len(DTYPES))])
    if fixed_shapes:
        F, n, block = DEVICE_SHAPES[rng.integers(0, len(DEVICE_SHAPES))]
    else:
        F = int(rng.integers(1, 5))
        n = int(rng.integers(1, 2000))
        block = int(rng.choice([3, 7, 12, 12, 12, 16, 64]))
    kind = int(rng.integers(0, 4))
    return _gen_values(dtype, F, n, kind, rng), block


def smoke_values(row) -> tuple[np.ndarray, int]:
    """(values, block) of a row of ``SMOKE_TRIALS`` or ``ROUTE_TRIALS``."""
    dt, F, n, block, kind, seed = row
    return _gen_values(np.dtype(dt), F, n, kind,
                       np.random.default_rng(seed)), block


class Mismatch(Exception):
    """Two engines disagreed on a trial."""


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise Mismatch(what)


def _same(back, vals: np.ndarray) -> bool:
    return np.array_equal(np.asarray(back).reshape(vals.shape), vals)


def run_trial(vals: np.ndarray, block: int, device=None,
              oracle: Path | None = None) -> bool:
    """Hold every engine to the others on the (F, n) frames `vals` in blocks
    of `block` values (see the module docstring): the host codecs, the
    device path on the torch ``device`` (None: none), and the oracle shim
    where given and inside its envelope. Raises Mismatch on the first
    disagreement; returns True if the oracle checked the trial."""
    small = vals.size <= PYCODEC_MAX_VALUES
    if small:
        ref = pycodec.encode(list(vals), block=block)
    elif native.available():
        ref = ncodec.encode(vals, block=block)
    else:
        raise RuntimeError(f"{vals.size} values need the native codec, "
                           f"which did not build")
    blob = ref.to_bytes()
    if native.available():
        if small:
            _expect(ncodec.encode(vals, block=block).to_bytes() == blob,
                    "native encode != pycodec")
        _expect(_same(ncodec.decode(ref, vals.dtype), vals),
                "native decode mismatch")
    if small:
        _expect(_same(pycodec.decode(ref, vals.dtype), vals),
                "pycodec decode mismatch")
    if device is not None and vals.dtype.itemsize <= 4:
        got = ops.encode(vals, block=block, device=device)
        _expect(got.to_bytes() == blob, "device encode != pycodec")
        _expect(_same(ops.decode(ref, vals.dtype, device=device), vals),
                "device decode mismatch")
    if oracle is not None and _in_reference_envelope(vals, block):
        shim_dt = vals.dtype.kind + str(8 * vals.dtype.itemsize)
        r = subprocess.run(
            [str(oracle), shim_dt, str(block), str(vals.shape[0]),
             str(vals.shape[1])],
            input=np.ascontiguousarray(vals).tobytes(), capture_output=True)
        if r.returncode == 0 and r.stdout:
            _expect(r.stdout == blob, "reference oracle mismatch")
            return True
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpx_tpu_torch.tools.differential_campaign",
        description="Differential soak of the port's codec engines.")
    ap.add_argument("n", nargs="?", type=int, default=1000,
                    help="random trials (default 1000; ignored by --smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device path ('cuda', 'cpu'); "
                         "--smoke without it takes the card")
    ap.add_argument("--smoke", action="store_true",
                    help="the fixed rows of SMOKE_TRIALS and ROUTE_TRIALS "
                         "on the device")
    a = ap.parse_args(argv)
    dev = (_api._torch_device(a.device)
           if a.smoke or a.device is not None else None)
    rows = SMOKE_TRIALS + ROUTE_TRIALS
    n_trials = len(rows) if a.smoke else a.n
    oracle = build_oracle()
    rng_master = np.random.default_rng(int(os.environ.get("SEED", 2026)))
    oracle_checked = 0
    for t in range(n_trials):
        if a.smoke:
            seed = rows[t][5]
            vals, block = smoke_values(rows[t])
        else:
            seed = int(rng_master.integers(0, 2**31))
            vals, block = _rand_frames(np.random.default_rng(seed),
                                       fixed_shapes=dev is not None)
        ctx = (f"trial {t} seed {seed} dtype {vals.dtype} F,n={vals.shape} "
               f"block {block} device {dev}")
        try:
            oracle_checked += run_trial(vals, block, dev, oracle)
        except Mismatch as e:
            print(f"MISMATCH: {e} @ {ctx}", file=sys.stderr)
            return 1
        except Exception as e:
            print(f"ERROR: {type(e).__name__}: {e} @ {ctx}", file=sys.stderr)
            raise
        if (t + 1) % 250 == 0:
            print(f"{t + 1}/{n_trials} ok ({oracle_checked} oracle-checked)",
                  flush=True)
    print(f"CAMPAIGN DONE: {n_trials} trials, 0 failures "
          f"({oracle_checked} inside the reference oracle envelope)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
