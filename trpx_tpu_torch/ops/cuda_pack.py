"""TRPX encode of a frame batch: the pack kernel's wrapper and its plain
PyTorch version.

``encode_batch`` launches the CUDA kernel (``csrc/pack.cu``) for a CUDA
tensor and runs ``encode_batch_plain`` for a CPU tensor. Both return
``(words, bits, maxw)``: ``words`` (F, n_words) int32 holding the uint32
stream words, zero past each frame's bits; ``bits`` and ``maxw`` (F,)
int32, each frame's total bit count and largest block width.

The plain version computes the plan of ``trpx_tpu/ops/coding.py:plan_frame``
(block widths, header bits and values, the exclusive prefix of block bits)
and then places every header and field LSB first at its absolute bit
offset with a scatter-add into zeroed words. Blocks own disjoint bit
ranges, so adding is OR. PyTorch has no uint32 shifts or scatter-add and
its int32 ``>>`` is arithmetic, so words are carried as int64 and narrowed
to their int32 bit patterns at the end.
"""

from __future__ import annotations

import torch

from .. import _build

#: unsigned element types, read through the signed type of the same size
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _values64(spec, frames: torch.Tensor) -> torch.Tensor:
    """Frame values as int64: two's complement for signed specs, the
    unsigned value otherwise."""
    x = frames.view(_SIGNED_VIEW.get(frames.dtype, frames.dtype))
    x = x.to(torch.int64)
    if not spec.signed:
        x = x & ((1 << spec.max_width) - 1)
    return x


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values below 2**32."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big * s
        x = torch.where(big, x >> s, x)
    return n + x


def header_codes(width: torch.Tensor):
    """(bits, values) of each block header from the (F, nb) widths; the
    repeat chain starts at width 0 in every frame (Terse.hpp:505,517-535)."""
    prev = torch.nn.functional.pad(width[:, :-1], (1, 0))
    repeat = width == prev
    hb = torch.where(repeat, 1,
                     torch.where(width < 7, 4,
                                 torch.where(width < 10, 6, 12)))
    hv = torch.where(
        repeat, 1,
        torch.where(width < 7, width << 1,
                    torch.where(width < 10, (0b111 | ((width - 7) << 3)) << 1,
                                (0b11111 | ((width - 10) << 5)) << 1)))
    return hb, hv


def block_counts(spec, device) -> torch.Tensor:
    """(nb,) values in each block; the last block may be partial."""
    first = torch.arange(spec.nb, dtype=torch.int64, device=device)
    return (spec.n - first * spec.block).clamp(0, spec.block)


def plan_batch(spec, frames: torch.Tensor) -> dict:
    """Per-block tables of a (F, n_padded) batch, as ``plan_frame`` makes
    them for one frame: ``width``, ``hb``, ``hv``, ``counts``, ``starts``
    (exclusive prefix of block bits) as (F, nb) int64, ``total_bits`` (F,)
    and ``values``, the (F, nb, B) int64 values."""
    F = frames.shape[0]
    x = _values64(spec, frames).reshape(F, spec.nb, spec.block)
    mag = x.abs() if spec.signed else x
    setbits = mag[..., 0]
    for j in range(1, spec.block):
        setbits = setbits | mag[..., j]
    width = _bit_length(setbits)
    if spec.signed:
        width = width + (setbits != 0)  # one sign bit (Terse.hpp:553-554)
    hb, hv = header_codes(width)
    counts = block_counts(spec, frames.device)
    block_bits = hb + width * counts
    ends = torch.cumsum(block_bits, dim=1)
    return dict(width=width, hb=hb, hv=hv, counts=counts,
                starts=ends - block_bits, total_bits=ends[:, -1], values=x)


def encode_batch_plain(spec, frames: torch.Tensor):
    """Plain PyTorch encode of a (F, n_padded) batch on its own device;
    the reference the pack kernel is held against."""
    F, B = frames.shape[0], spec.block
    p = plan_batch(spec, frames)
    width = p["width"][..., None]
    j = torch.arange(B, dtype=torch.int64, device=frames.device)
    fields = torch.where(j < p["counts"][:, None],
                         p["values"] & ((1 << width) - 1), 0)
    offs = (p["starts"] + p["hb"])[..., None] + j * width
    vals = torch.cat([p["hv"][..., None], fields], dim=2).reshape(F, -1)
    offs = torch.cat([p["starts"][..., None], offs], dim=2).reshape(F, -1)
    # a field of <= 33 bits at phase s spans word off>>5 and the next one
    s = offs & 31
    lo = (vals & ((1 << (32 - s)) - 1)) << s
    hi = vals >> (32 - s)
    words = torch.zeros((F, spec.n_words), dtype=torch.int64,
                        device=frames.device)
    words.scatter_add_(1, offs >> 5, lo)
    words.scatter_add_(1, (offs >> 5) + 1, hi)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return (words.to(torch.int32), p["total_bits"].to(torch.int32),
            p["width"].amax(dim=1).to(torch.int32))


def _check(spec, frames: torch.Tensor) -> None:
    if frames.dtype != spec.torch_dtype:
        raise TypeError(f"frames must be {spec.torch_dtype} for {spec}, "
                        f"got {frames.dtype}")
    if frames.ndim != 2 or frames.shape[1] != spec.n_padded \
            or frames.shape[0] < 1:
        raise ValueError(f"frames must be (F >= 1, {spec.n_padded}), got "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")


def encode_batch(spec, frames: torch.Tensor):
    """Encode a (F, n_padded) batch: the CUDA pack kernel for a CUDA
    tensor, :func:`encode_batch_plain` for a CPU tensor. Padding values
    must be zero. Counts kernel launches in ``encode_batch.launches``."""
    _check(spec, frames)
    if frames.device.type == "cpu":
        return encode_batch_plain(spec, frames)
    if frames.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {frames.device}")
    lib = _build.load()
    F = frames.shape[0]
    dev = frames.device
    words = torch.zeros((F, spec.n_words), dtype=torch.int32, device=dev)
    bits = torch.empty((F,), dtype=torch.int32, device=dev)
    maxw = torch.empty((F,), dtype=torch.int32, device=dev)
    rc = lib.trpx_pack(
        frames.data_ptr(), frames.element_size(), int(spec.signed), F,
        spec.n, spec.n_padded, spec.block, spec.n_words, words.data_ptr(),
        bits.data_ptr(), maxw.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pack")
    encode_batch.launches += 1
    return words, bits, maxw


encode_batch.launches = 0
