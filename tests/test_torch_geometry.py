"""PyTorch port: the launch geometry and the word contract of the kernels
(csrc/pack.cu, csrc/unpack.cu, csrc/pack_tiled.cu, csrc/unpack_tiled.cu),
computed in Python and passed to the kernels, which refuse a
shared-memory size other than their own carve-up. For every device dtype,
frame sizes from one value to 512x512 and the default and two other block
sizes: the one-pass tile is at least 32 blocks and at most what the frame
has (or 32). Frame sizes from one value to 2048x2048 and blocks of 7, 12,
64, 1,024 and one larger than a tile: the tiled kernels' tile is whole
blocks of at most ``TILE_VALUES`` values, at least one. Each kernel's
shared memory holds what it stages in it and fits an H100's 232,448 bytes
a CTA, the scratch sizes match the kernels' layouts, and the defined
prefix of each frame's words covers every byte the archive takes from it.
Exact integer checks.
"""

import numpy as np
import pytest
import torch

from trpx_tpu_torch.format.spec import frame_nbytes
from trpx_tpu_torch.ops.coding import FrameSpec
from trpx_tpu_torch.ops.cuda_pack import (
    MIN_TILE_BLOCKS,
    SMEM_LIMIT,
    TILE_VALUES,
    defined_words,
    encode_batch_plain,
    pack_geometry,
    pack_scratch_ints,
    pack_smem_bytes,
    stream_words,
    tile_smem_bytes,
    tiled_pack_geometry,
    tiled_pack_scratch_ints,
)
from trpx_tpu_torch.ops.cuda_unpack import (
    tiled_unpack_geometry,
    tiled_unpack_scratch_ints,
    unpack_geometry,
)

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32]
SIZES = [1, 100, 1000, 512 * 512]
BLOCKS = [12, 7, 64]
TILED_SIZES = [1, 1000, 512 * 512, 2048 * 2048]
TILED_BLOCKS = [7, 12, 64, 1024, TILE_VALUES + 808]  # the last: > a tile


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_geometry(dtype, n, block):
    spec = FrameSpec.for_dtype(n, dtype, block)
    itemsize = np.dtype(dtype).itemsize
    tb, smem = pack_geometry(spec)
    assert MIN_TILE_BLOCKS <= tb <= max(MIN_TILE_BLOCKS, spec.nb)
    assert smem == pack_smem_bytes(itemsize, spec.max_width, block, tb)
    assert smem <= SMEM_LIMIT < 232448
    # the tile and the block before it, with room for the 16-byte phase;
    # the worst-case stream of the tile with the word after it; an offset
    # and a width per block
    vals = ((tb + 1) * block + 16 // itemsize - 1) * itemsize
    words = -(-tb * spec.max_block_bits // 32) + 2
    assert smem >= vals + 4 * words + 4 * tb + (tb + 1)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_geometry(dtype, n, block):
    spec = FrameSpec.for_dtype(n, dtype, block)
    tb, smem = unpack_geometry(spec)
    assert MIN_TILE_BLOCKS <= tb <= max(MIN_TILE_BLOCKS, spec.nb)
    assert smem == tile_smem_bytes(spec.max_width, block, tb)
    assert smem <= SMEM_LIMIT
    # the word range of a tile of the widest fields, its 16-byte phase
    # (3 words) and the two-word window's second word; an offset and a
    # width per block
    words = -(-tb * spec.max_block_bits // 32) + 2 + 3
    assert smem >= 4 * words + 4 * tb + (tb + 1)


@pytest.mark.parametrize("frames,tiles", [(1, 1), (3, 22), (256, 22)])
def test_pack_scratch_layout(frames, tiles):
    # ticket and pad, an aggregate and an inclusive uint64 per tile, then
    # one int32 largest width per frame
    assert pack_scratch_ints(frames, tiles) == \
        2 + 2 * 2 * frames * tiles + frames


@pytest.mark.parametrize("kernel", ["pack", "unpack"])
@pytest.mark.parametrize("block", TILED_BLOCKS)
@pytest.mark.parametrize("n", TILED_SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_geometry(dtype, n, block, kernel):
    spec = FrameSpec.for_dtype(n, dtype, block)
    geometry = {"pack": tiled_pack_geometry,
                "unpack": tiled_unpack_geometry}[kernel]
    tb, smem = geometry(spec)
    # whole blocks, at least one and at most the frame's; as many as
    # TILE_VALUES values hold, or one larger block
    assert 1 <= tb <= spec.nb
    assert tb == min(max(1, TILE_VALUES // block), spec.nb)
    assert tb * block <= max(TILE_VALUES, block)
    # a one-block tile of more than TILE_VALUES values is walked in chunks
    # of TILE_VALUES values
    vals = min(block, TILE_VALUES) if tb == 1 else block
    assert smem == tile_smem_bytes(spec.max_width, vals, tb)
    assert smem <= SMEM_LIMIT
    # the widest stream of the tile or chunk from any bit of its first
    # word, the two-word window's second word and the 16-byte phase (3
    # words); an offset per block, a width per block and the one before
    words = (31 + tb * (12 + vals * spec.max_width)) // 32 + 2 + 3
    assert smem >= 4 * words + 4 * tb + (tb + 1)


@pytest.mark.parametrize("frames,tiles,nb", [(1, 1, 1), (3, 22, 15_000),
                                             (32, 513, 349_526)])
def test_tiled_scratch_layout(frames, tiles, nb):
    # the tiled pack: per (frame, tile) its bits without its first header
    # and its largest width, the tile starts (F, T + 1), then the (F, nb)
    # uint8 widths in whole int32 words
    assert tiled_pack_scratch_ints(frames, tiles, nb) == \
        2 * frames * tiles + frames * (tiles + 1) + -(-frames * nb // 4)
    # the tiled unpack: per (frame, tile) its bits without its first
    # header, then the tile starts
    assert tiled_unpack_scratch_ints(frames, tiles) == \
        frames * tiles + frames * (tiles + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_defined_prefix_covers_the_archive(dtype):
    """Every byte ``assemble_archive`` takes from a frame (1 + bits // 8,
    the terminal byte included) lies in the frame's defined words, and the
    plain pack's words past them are zero."""
    bits = torch.arange(0, 4 * 97 + 1, dtype=torch.int32)
    words = defined_words(bits)
    for b, w in zip(bits.tolist(), words.tolist()):
        assert frame_nbytes(b) <= 4 * w
        assert w == b // 32 + 1
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    info = np.iinfo(dtype)
    fr = rng.integers(max(info.min, -300), min(info.max, 300), (3, 1000))
    spec = FrameSpec.for_dtype(1000, dtype)
    x = torch.from_numpy(np.pad(fr.astype(dtype),
                                ((0, 0), (0, spec.n_padded - 1000))))
    w, b, _ = encode_batch_plain(spec, x)
    assert torch.equal(stream_words(w, b), w)
    garbage = w.clone()
    col = torch.arange(w.shape[1])[None, :]
    garbage[col >= defined_words(b)[:, None]] = -1
    assert torch.equal(stream_words(garbage, b), w)
