"""Byte counts of the codec's problem, and the cards' peak memory rates.

A kernel's least time is the bytes the problem needs moved over the
card's peak memory rate: the codec does a handful of integer operations a
byte, far below any card's ratio of operations to bytes, so memory bounds
it. The bytes come from the problem, not from an implementation: each
input byte read once and each output byte written once, whatever a kernel
reads again or pads.
"""

from __future__ import annotations

#: peak device memory rate, bytes/s, by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet: H100 SXM 80 GB HBM3, 3.35 TB/s at 700 W)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def encode_bytes(frames: int, values: int, itemsize: int,
                 payload_bytes: int) -> int:
    """An encode: the raw frames read (unpadded) and the compressed
    payload written."""
    return frames * values * itemsize + payload_bytes


def decode_bytes(frames: int, values: int, itemsize: int,
                 payload_bytes: int) -> int:
    """A decode: the compressed payload read and the pixels written."""
    return payload_bytes + frames * values * itemsize


def share_pct(nbytes: int, kernel_s: float, device_name: str) -> float | None:
    """Percent of the card's peak memory rate that moving ``nbytes`` in
    ``kernel_s`` seconds of kernel time reaches; None where the card has no
    peak in the table or no kernel time was read."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None or kernel_s <= 0:
        return None
    return 100.0 * nbytes / peak / kernel_s
