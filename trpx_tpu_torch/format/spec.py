"""Normative TRPX format constants and per-block math.

Semantics pinned against the reference implementation:

* block width        — Terse.hpp:508-515,551-560
* header encoding    — Terse.hpp:517-535 (1/4/6/12-bit forms)
* frame byte length  — Terse.hpp:547 (``1 + floor(bits/8)``)
* header attributes  — Terse.hpp:454-474 (fixed order, exact formatting)

All functions here are pure and operate on Python ints / numpy arrays; the
device path re-derives the same quantities in PyTorch and CUDA
(ops/cuda_pack.py, csrc/) and is tested against these.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEFAULT_BLOCK = 12
#: Max encodable width: 10 + (2**6 - 1) (Terse.hpp:530-533). In practice <= 65
#: (64-bit data + sign bit), but the header form tops out at 73.
MAX_HEADER_WIDTH = 73

SUPPORTED_DTYPES = (
    np.uint8, np.uint16, np.uint32, np.uint64,
    np.int8, np.int16, np.int32, np.int64,
)


def significant_bits(or_of_magnitudes: int, signed: bool) -> int:
    """Width of a block given the OR of its values' magnitudes.

    Unsigned: bit length of the OR of the values (Terse.hpp:510-511,555-558).
    Signed:   1 + bit length of the OR of |values| — one extra sign bit
              (Terse.hpp:513-514,553-554). A zero block has width 0 in both
              cases (Terse.hpp:554 guards val == 0).
    """
    if or_of_magnitudes == 0:
        return 0
    bl = int(or_of_magnitudes).bit_length()
    return bl + 1 if signed else bl


def header_code(width: int, prev_width: int) -> tuple[int, int]:
    """(value, nbits) of the block header, to be written LSB-first.

    Terse.hpp:517-535: a repeat of the previous width is a single ``1`` bit;
    otherwise a ``0`` bit followed by a 3-, 5- or 11-bit width field.
    """
    if width == prev_width:
        return 1, 1
    if width < 7:
        return width << 1, 4
    if width < 10:
        return (0b111 | ((width - 7) << 3)) << 1, 6
    return (0b11111 | ((width - 10) << 5)) << 1, 12


def header_nbits(width: int, prev_width: int) -> int:
    if width == prev_width:
        return 1
    return 4 if width < 7 else (6 if width < 10 else 12)


def frame_nbytes(nbits: int) -> int:
    """Terse.hpp:547 — every frame ends with a terminal byte, so an exactly
    byte-aligned stream still gains one zero byte."""
    return 1 + nbits // 8


def block_widths(frame: np.ndarray, block: int, signed: bool) -> np.ndarray:
    """Vectorized per-block widths for a 1-D frame (numpy host path).

    Uses uint64 magnitude accumulation so |int64 min| and 64-bit values are
    handled correctly (the reference's ``abs`` is broken there — SURVEY B6;
    we define the mathematically correct width instead).
    """
    n = frame.shape[0]
    nb = -(-n // block)
    if signed:
        # |v| as uint64, correct even for int64 min (|min| = 2**63)
        if frame.dtype == np.int64:
            mags = np.abs(frame.astype(np.object_))
        else:
            mags = np.abs(frame.astype(np.int64)).astype(np.uint64)
    else:
        mags = frame.astype(np.uint64, copy=False)
    pad = nb * block - n
    if pad:
        mags = np.concatenate([mags, np.zeros(pad, dtype=mags.dtype)])
    if mags.dtype == np.object_:
        ors = np.bitwise_or.reduce(mags.reshape(nb, block), axis=1)
        widths = np.array([significant_bits(int(v), signed) for v in ors], dtype=np.int64)
        return widths
    ors = np.bitwise_or.reduce(mags.reshape(nb, block), axis=1)
    # bit_length via float log2 is unsafe; use a 64-step unrolled comparison
    widths = np.zeros(nb, dtype=np.int64)
    v = ors.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = v >= (np.uint64(1) << np.uint64(shift))
        widths += shift * big
        v = np.where(big, v >> np.uint64(shift), v)
    widths += (ors != 0)
    if signed:
        widths += (ors != 0)
    return widths


def block_counts(nvalues: int, block: int) -> np.ndarray:
    """Number of real values in each block (last block may be partial,
    Terse.hpp:507)."""
    nb = -(-nvalues // block)
    counts = np.full(nb, block, dtype=np.int64)
    if nvalues % block:
        counts[-1] = nvalues % block
    return counts


@dataclass
class FrameLayout:
    """Complete bit-level layout of one encoded frame."""

    widths: np.ndarray          # (nb,) per-block payload field width
    header_bits: np.ndarray     # (nb,) 1/4/6/12
    header_values: np.ndarray   # (nb,) LSB-first header bit patterns
    counts: np.ndarray          # (nb,) values per block
    block_starts: np.ndarray    # (nb,) absolute bit offset of each block header
    total_bits: int
    nbytes: int = field(init=False)

    def __post_init__(self) -> None:
        self.nbytes = frame_nbytes(self.total_bits)

    @property
    def payload_starts(self) -> np.ndarray:
        """Absolute bit offset of each block's first payload bit."""
        return self.block_starts + self.header_bits


def frame_layout(widths: np.ndarray, counts: np.ndarray) -> FrameLayout:
    """Derive the full frame layout from per-block widths (numpy)."""
    nb = widths.shape[0]
    prev = np.empty_like(widths)
    prev[0] = 0  # prevbits starts at 0 every frame (Terse.hpp:505)
    prev[1:] = widths[:-1]
    repeat = widths == prev
    hb = np.where(repeat, 1, np.where(widths < 7, 4, np.where(widths < 10, 6, 12)))
    hv = np.where(
        repeat,
        1,
        np.where(
            widths < 7,
            widths << 1,
            np.where(
                widths < 10,
                (0b111 | ((widths - 7) << 3)) << 1,
                (0b11111 | ((widths - 10) << 5)) << 1,
            ),
        ),
    )
    block_bits = hb + widths * counts
    starts = np.zeros(nb, dtype=np.int64)
    np.cumsum(block_bits[:-1], out=starts[1:])
    total = int(block_bits.sum())
    return FrameLayout(
        widths=widths.astype(np.int64),
        header_bits=hb.astype(np.int64),
        header_values=hv.astype(np.int64),
        counts=counts.astype(np.int64),
        block_starts=starts,
        total_bits=total,
    )
