"""LSB-first bitstream primitives (pure Python, normative).

This is the spec-as-code analogue of the reference bit substrate
(``Bit_pointer.hpp:120-797``): bits are written least-significant-bit first
into successive bytes, so bit index ``i`` of the stream lives at byte
``i >> 3``, bit ``i & 7``.  The on-disk stream is byte-order independent.

These classes are deliberately simple and slow — they are the ground truth
that the vectorized numpy paths and the CUDA kernels are tested against.
"""

from __future__ import annotations


class BitWriter:
    """Append-only LSB-first bit writer over a growable byte buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.pos = 0  # next free bit index

    def write(self, value: int, nbits: int) -> None:
        """Write the low ``nbits`` bits of ``value`` (two's complement for
        negative values), LSB-first. Matches ``Bit_range::operator|=`` /
        ``append_range`` (Bit_pointer.hpp:628,700)."""
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        end = self.pos + nbits
        need = (end >> 3) + 1
        if len(self.buf) < need:
            self.buf.extend(b"\x00" * (need - len(self.buf)))
        v = value << (self.pos & 7)
        i = self.pos >> 3
        while v:
            self.buf[i] |= v & 0xFF
            v >>= 8
            i += 1
        self.pos = end

    def frame_bytes(self, start_bit: int = 0) -> int:
        """Bytes consumed since ``start_bit`` per the reference rule
        ``1 + floor(bits/8)`` (Terse.hpp:547): an exactly byte-aligned frame
        still gains one terminal zero byte."""
        return 1 + (self.pos - start_bit) // 8

    def getvalue(self) -> bytes:
        """The stream with the terminal-byte rule applied."""
        n = 1 + self.pos // 8
        if len(self.buf) < n:
            return bytes(self.buf) + b"\x00" * (n - len(self.buf))
        return bytes(self.buf[:n])

    def align_to_byte_plus_terminal(self) -> None:
        """Advance to the start of the next frame: byte offset
        ``1 + floor(pos/8)`` (Terse.hpp:547; TRPX_Reader.java:130)."""
        self.pos = 8 * (1 + self.pos // 8)
        need = self.pos >> 3
        if len(self.buf) < need:
            self.buf.extend(b"\x00" * (need - len(self.buf)))


class BitReader:
    """LSB-first bit reader over a bytes-like object."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, start_bit: int = 0) -> None:
        self.buf = buf
        self.pos = start_bit

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        i = self.pos >> 3
        shift = self.pos & 7
        end_byte = (self.pos + nbits - 1) >> 3
        acc = 0
        k = 0
        for b in range(i, end_byte + 1):
            acc |= self.buf[b] << k
            k += 8
        self.pos += nbits
        return (acc >> shift) & ((1 << nbits) - 1)
