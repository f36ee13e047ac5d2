"""Normative TRPX format layer: header, bitstream, layout math, and the
pure-Python spec-as-code codec that all fast paths are tested against.

The port's own copy of ``trpx_tpu/format`` (same module names, numpy only),
so that ``trpx_tpu_torch`` imports nothing of the JAX package;
``tests/test_torch_format.py`` holds the two copies to the same bytes."""

from .bitstream import BitReader, BitWriter
from .header import TrpxMeta, emit_header, parse_header
from .pycodec import TrpxArchive, decode, decode_frame, encode, frame_offsets, walk_frame
from .spec import (
    DEFAULT_BLOCK,
    FrameLayout,
    block_counts,
    block_widths,
    frame_layout,
    frame_nbytes,
    header_code,
    significant_bits,
)

__all__ = [
    "BitReader",
    "BitWriter",
    "TrpxMeta",
    "TrpxArchive",
    "DEFAULT_BLOCK",
    "FrameLayout",
    "block_counts",
    "block_widths",
    "decode",
    "decode_frame",
    "emit_header",
    "encode",
    "frame_layout",
    "frame_nbytes",
    "frame_offsets",
    "header_code",
    "parse_header",
    "significant_bits",
    "walk_frame",
]
