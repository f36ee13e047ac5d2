"""TRPX decode of a frame batch: the unpack kernels' wrappers and their
plain PyTorch versions.

``decode_batch`` launches the CUDA kernels of ``csrc/unpack.cu`` (each
tile's bit offset from the widths in one CTA per frame, then one CTA per
tile of :func:`unpack_geometry` blocks) and ``decode_batch_tiled`` those
of ``csrc/unpack_tiled.cu`` (tile bits in many CTAs per frame, a scan,
then one CTA per tile of :func:`tiled_unpack_geometry` blocks, for few
big frames and blocks of any size) for CUDA tensors; for CPU tensors each
runs its plain version (``decode_batch_plain``,
``decode_batch_tiled_plain``). Inputs are the
host walk's outputs: ``words`` (F, W) int32 holding each frame's uint32
stream words (at least two words past each stream's last bit) and
``widths`` (F, nb) uint8. The output is flat (F, n) in the lanes of
:func:`decoded_dtype`: uint8 for unsigned targets of at most 8 bits,
uint16 for those of at most 16, else int32 (sign-extended iff the target
spec is signed; a 33-bit field keeps its low 32 bits). The host narrows
int32 lanes to the target dtype (``coding.narrow_values``); unsigned
lanes are the target's own, and pass as they are.

The plain versions derive each block's bits from the widths as
``trpx_tpu/ops/pallas_unpack.py:block_bits_host`` does, take their
exclusive prefix (tile by tile, from each tile's offset, in the tiled
version), and read every value with the two-word gather of
``trpx_tpu/ops/coding.py:decode_frame_device``, in int64 (PyTorch has no
uint32 shifts). They are the kernels' specification on hostile tables
too: each read is clamped to the words the kernel's CTA stages for the
value's tile (:func:`_staged`), which only widths wider than the target's
fields can reach past.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .cuda_pack import (
    TILE_VALUES,
    block_counts,
    check_tile_blocks,
    choose_tile,
    header_codes,
    tile_smem_bytes,
    tiled_plan,
    value_tile_geometry,
    value_tile_smem,
    words_cap,
)


def decoded_dtype(spec) -> torch.dtype:
    """The unpack output type for a target spec: the unsigned target's own
    type for u8 and u16, int32 for the rest (the 9- and 17-bit fields of
    i8 and i16 need the host's clamp)."""
    if not spec.signed and spec.max_width <= 8:
        return torch.uint8
    if not spec.signed and spec.max_width <= 16:
        return torch.uint16
    return torch.int32


#: shared memory of an unpack_tiles CTA under which its tile is chosen
UNPACK_SMEM_TARGET = 32 * 1024


@functools.lru_cache(maxsize=64)
def unpack_geometry(spec) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of ``csrc/unpack.cu`` for the
    target ``spec``: tiles of 1,024 blocks for targets of at most 17-bit
    fields and 512 for 32-bit ones (about 31 KB of shared memory at
    12-value blocks, so that 7 CTAs of 128 threads share an SM), fewer for
    larger blocks."""
    return choose_tile(
        spec, 1024 if spec.max_width <= 17 else 512,
        lambda tb: tile_smem_bytes(spec.max_width, spec.block, tb),
        UNPACK_SMEM_TARGET)


@functools.lru_cache(maxsize=64)
def tiled_unpack_geometry(spec) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of ``csrc/unpack_tiled.cu``'s
    extraction CTA for the target ``spec``
    (:func:`cuda_pack.value_tile_geometry`)."""
    return value_tile_geometry("tiled unpack", spec)


def tiled_unpack_scratch_ints(frames: int, tiles: int) -> int:
    """int32 words of ``csrc/unpack_tiled.cu``'s scratch: each tile's bits
    without its first header (F, T), then the tile starts (F, T + 1)."""
    return frames * tiles + frames * (tiles + 1)


def _staged(spec, W: int, w: torch.Tensor, starts: torch.Tensor,
            hb: torch.Tensor, tile_blocks: int):
    """(first, last) word a kernel's CTA may read each value's two-word
    window from, broadcastable to (F, nb, B): the CTA of the value's tile
    of ``tile_blocks`` blocks stages the words of the tile's bits [P, E)
    (of a one-block tile of more than ``TILE_VALUES`` values, those of
    the value's chunk of fields), within the row and within its
    ``words_cap`` words (``csrc/unpack.cu``, ``csrc/unpack_tiled.cu``,
    ``tile.cuh:field_at``). Only widths wider than the target's fields
    reach past the tile's words."""
    nb, B = spec.nb, spec.block
    counts = block_counts(spec, w.device)
    total = starts[:, -1] + hb[:, -1] + w[:, -1] * counts[-1]
    first = torch.arange(nb, device=w.device) // tile_blocks * tile_blocks
    nxt = first + tile_blocks
    P = starts[:, first][..., None]
    E = torch.where(nxt < nb, starts[:, nxt.clamp(max=nb - 1)],
                    total[:, None])[..., None]
    if tile_blocks == 1 and B > TILE_VALUES:
        # a block's fields in chunks of TILE_VALUES, each staged alone
        c0 = torch.arange(B, device=w.device) // TILE_VALUES * TILE_VALUES
        c1 = torch.minimum(c0 + TILE_VALUES, counts[:, None])
        pay = (starts + hb)[..., None]
        wv = w[..., None]
        chunked = (counts[:, None] > TILE_VALUES) & (wv > 0)
        P = torch.where(chunked, pay + c0 * wv, P)
        E = torch.where(chunked, pay + c1 * wv, E)
        cap = words_cap(spec.max_width, TILE_VALUES, 1)
    else:
        cap = words_cap(spec.max_width, B, tile_blocks)
    base = (P >> 5).clamp(max=W - 2).clamp(min=0)
    end = torch.maximum(torch.minimum(((E >> 5) + 2).clamp(max=W),
                                      base + cap - 3), base + 2)
    return base, end - 2


def _extract(spec, words: torch.Tensor, w: torch.Tensor,
             starts: torch.Tensor, hb: torch.Tensor,
             out_dtype: torch.dtype, tile_blocks: int | None) -> torch.Tensor:
    """Every value's field from the (F, nb) int64 widths ``w``, block
    offsets ``starts`` and header bits ``hb``: the flat (F, n) output.
    Word reads are clamped as the kernel's at tiles of ``tile_blocks``
    blocks clamps them (:func:`_staged`; None: to the row), so
    inconsistent tables cannot index past a row."""
    F, W = words.shape
    B = spec.block
    if tile_blocks is None:
        lo, hi = 0, W - 2
    else:
        lo, hi = _staged(spec, W, w, starts, hb, tile_blocks)
    w = w[..., None]
    j = torch.arange(B, dtype=torch.int64, device=w.device)
    off = (starts + hb)[..., None] + j * w
    idx = torch.clamp(off >> 5, lo, hi).reshape(F, -1)
    off = off.reshape(F, -1)
    s = off & 31
    wd = words.to(torch.int64) & 0xFFFFFFFF
    lo = torch.gather(wd, 1, idx)
    hi = torch.gather(wd, 1, idx + 1)
    u = ((lo >> s) | ((hi << (32 - s)) & 0xFFFFFFFF)).reshape(F, -1, B)
    mask = (1 << w.clamp(max=32)) - 1
    u = u & mask
    if spec.signed:
        top = (u >> (w - 1).clamp(min=0)) & 1
        neg = (w > 0) & (w < 32) & (top == 1)
        u = torch.where(neg, u | (0xFFFFFFFF ^ mask), u)
    u = u.reshape(F, -1)[:, : spec.n]
    if out_dtype == torch.uint8:
        return (u & 0xFF).to(torch.uint8)
    if out_dtype == torch.uint16:
        return torch.where(u >= 2**15, u - 2**16, u).to(torch.int16).view(
            torch.uint16)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def decode_batch_plain(spec, words: torch.Tensor, widths: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch decode on the inputs' device; the reference the
    unpack kernel is held against, reads clamped as at its tiles
    (:func:`unpack_geometry`; to the row for blocks it cannot tile)."""
    w = widths.to(torch.int64)
    hb, _ = header_codes(w)
    block_bits = hb + w * block_counts(spec, w.device)
    starts = torch.cumsum(block_bits, dim=1) - block_bits
    try:
        tile_blocks = unpack_geometry(spec)[0]
    except ValueError:
        tile_blocks = None
    return _extract(spec, words, w, starts, hb, out_dtype, tile_blocks)


def decode_batch_tiled_plain(spec, words: torch.Tensor,
                             widths: torch.Tensor, out_dtype: torch.dtype,
                             tile_blocks: int | None = None) -> torch.Tensor:
    """Plain PyTorch decode in tiles of ``tile_blocks`` blocks
    (``cuda_pack.tiled_plan``; by default those of
    :func:`tiled_unpack_geometry`), on the inputs' device; the reference
    the tiled unpack kernels are held against."""
    if tile_blocks is None:
        tile_blocks = tiled_unpack_geometry(spec)[0]
    w = widths.to(torch.int64)
    p = tiled_plan(spec, w, tile_blocks)
    return _extract(spec, words, w, p["starts"], p["hb"], out_dtype,
                    tile_blocks)


def _check(spec, words, widths, out_dtype) -> None:
    if spec.worst_bits >= 2**31:
        # the kernels' bit offsets are int32
        raise ValueError("frame too large for 32-bit bit offsets")
    if words.dtype != torch.int32 or widths.dtype != torch.uint8:
        raise TypeError("words must be int32 and widths uint8, got "
                        f"{words.dtype} and {widths.dtype}")
    if out_dtype not in (torch.int32, decoded_dtype(spec)):
        raise TypeError(f"no {out_dtype} output for {spec}")
    if (words.ndim != 2 or widths.ndim != 2 or words.shape[1] < 2
            or words.shape[0] < 1 or widths.shape != (words.shape[0],
                                                       spec.nb)):
        raise ValueError(
            f"need words (F >= 1, W >= 2) and widths (F, {spec.nb}), got "
            f"{tuple(words.shape)} and {tuple(widths.shape)}")
    if words.device != widths.device:
        raise ValueError("words and widths must be on one device")
    if not (words.is_contiguous() and widths.is_contiguous()):
        raise ValueError("words and widths must be contiguous")


def decode_batch(spec, words: torch.Tensor, widths: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Decode a batch: the CUDA unpack kernel for CUDA tensors,
    :func:`decode_batch_plain` for CPU tensors. Counts kernel launches in
    ``decode_batch.launches``."""
    _check(spec, words, widths, out_dtype)
    if words.device.type == "cpu":
        return decode_batch_plain(spec, words, widths, out_dtype)
    if words.device.type != "cuda":
        raise ValueError(f"no unpack kernel for device {words.device}")
    tile_blocks, smem = unpack_geometry(spec)
    lib = _build.load()
    F, W = words.shape
    dev = words.device
    out = torch.empty((F, spec.n), dtype=out_dtype, device=dev)
    # scratch: each tile's bit offset and each frame's total
    tile_start = torch.empty((F, -(-spec.nb // tile_blocks) + 1),
                             dtype=torch.int32, device=dev)
    rc = lib.trpx_unpack(
        words.data_ptr(), widths.data_ptr(), F, W, spec.n, spec.block,
        tile_blocks, spec.max_width, smem, int(spec.signed),
        out.element_size(), out.data_ptr(), tile_start.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "unpack")
    _build.count_launch(decode_batch)
    return out


decode_batch.launches = 0


def decode_batch_tiled(spec, words: torch.Tensor, widths: torch.Tensor,
                       out_dtype: torch.dtype,
                       tile_blocks: int | None = None) -> torch.Tensor:
    """Decode a batch in tiles of ``tile_blocks`` blocks (by default those
    of :func:`tiled_unpack_geometry`): the CUDA kernels of
    ``csrc/unpack_tiled.cu`` for CUDA tensors,
    :func:`decode_batch_tiled_plain` for CPU tensors. Counts kernel
    launches in ``decode_batch_tiled.launches``."""
    _check(spec, words, widths, out_dtype)
    if tile_blocks is None:
        tile_blocks, smem = tiled_unpack_geometry(spec)
    else:
        tile_blocks = check_tile_blocks(spec, tile_blocks)
        smem = None
    if words.device.type == "cpu":
        return decode_batch_tiled_plain(spec, words, widths, out_dtype,
                                        tile_blocks)
    if words.device.type != "cuda":
        raise ValueError(f"no tiled unpack kernel for device {words.device}")
    if smem is None:
        smem = value_tile_smem("tiled unpack", spec, tile_blocks)
    lib = _build.load()
    F, W = words.shape
    dev = words.device
    out = torch.empty((F, spec.n), dtype=out_dtype, device=dev)
    # scratch, freed in stream order after the launches
    T = -(-spec.nb // tile_blocks)
    scratch = torch.empty((tiled_unpack_scratch_ints(F, T),),
                          dtype=torch.int32, device=dev)
    rc = lib.trpx_unpack_tiled(
        words.data_ptr(), widths.data_ptr(), F, W, spec.n, spec.block,
        tile_blocks, spec.max_width, smem, int(spec.signed),
        out.element_size(), scratch.data_ptr(), out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tiled unpack")
    _build.count_launch(decode_batch_tiled)
    return out


decode_batch_tiled.launches = 0
