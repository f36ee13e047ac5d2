"""TRPX encode of a frame batch: the pack kernels' wrappers and their
plain PyTorch versions.

``encode_batch`` launches the CUDA kernel ``csrc/pack.cu`` (one pass, one
CTA per tile of :func:`pack_geometry` blocks, tiles chained by a
decoupled look-back) and ``encode_batch_tiled`` the kernels
``csrc/pack_tiled.cu`` (three launches over tiles of
:func:`tiled_pack_geometry` blocks, for blocks of any size) for a CUDA
tensor; for a CPU tensor each runs its plain version
(``encode_batch_plain``, ``encode_batch_tiled_plain``). All return
``(words, bits, maxw)``: ``words`` (F, n_words) int32 holding the uint32
stream words, ``bits`` and ``maxw`` (F,) int32, each frame's total bit
count and largest block width. Words ``[0, bits // 32]`` of each frame
(:func:`defined_words`) hold its stream, zero above its last bit; that is
all ``encode_collect`` and ``assemble_archive`` read. Both kernels leave
the words after them undefined (they write every word of that prefix and
need no zero-fill); the plain versions leave them zero. The stream does
not depend on the tile size.

The plain version computes the plan of ``trpx_tpu/ops/coding.py:plan_frame``
(block widths, header bits and values, the exclusive prefix of block bits)
and then places every header and field LSB first at its absolute bit
offset with a scatter-add into zeroed words. Blocks own disjoint bit
ranges, so adding is OR. PyTorch has no uint32 shifts or scatter-add and
its int32 ``>>`` is arithmetic, so words are carried as int64 and narrowed
to their int32 bit patterns at the end.
"""

from __future__ import annotations

import functools
import operator

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


#: dynamic shared memory a CTA may take on an H100: 232,448 bytes less room
#: for the one-pass kernels' static shared memory (csrc/tile.cuh)
SMEM_LIMIT = 232448 - 1024
#: shared memory of a CTA under which the pack picks its tile: five CTAs of
#: 256 threads then share an SM's 228 KB
PACK_SMEM_TARGET = 44 * 1024
#: fewest blocks in a tile of the one-pass kernels: every block has a
#: header bit, so the 32 bits before a tile belong to the tile before it
MIN_TILE_BLOCKS = 32
#: values in a tile of the tiled kernels (csrc/tile.cuh kTileValues): a
#: tile holds max(1, TILE_VALUES // block) whole blocks, and a tile of one
#: larger block is walked in chunks of this many values. Measured on an
#: H100 (PERF.md, section 6)
TILE_VALUES = 8192

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_smem_bytes(itemsize: int, max_width: int, block: int,
                    tile_blocks: int) -> int:
    """Dynamic shared memory of a ``csrc/pack.cu`` CTA (its ``PackSmem``):
    the tile's values and the block before it (16-byte rounded, with room
    for the 16-byte phase), the worst-case stream of the tile in words (+4,
    rounded to 4), an int offset per block and a byte width per block and
    the one before (rounded to 16)."""
    vals = _round_up(((tile_blocks + 1) * block + 16 // itemsize)
                     * itemsize, 16)
    out_words = _round_up(
        -(-tile_blocks * (12 + block * max_width) // 32) + 4, 4)
    return (vals + 4 * out_words + 4 * tile_blocks
            + _round_up(tile_blocks + 1, 16))


def choose_tile(spec, default: int, smem, target: int) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of a one-pass kernel: ``default``
    blocks (at least ``MIN_TILE_BLOCKS``, at most what the frame has),
    less 32 at a time while ``smem(tile_blocks)`` exceeds ``target``.
    Raises ValueError when even the smallest tile exceeds ``SMEM_LIMIT``
    (blocks of hundreds of values)."""
    tb = max(MIN_TILE_BLOCKS, min(default, spec.nb))
    while tb > MIN_TILE_BLOCKS and smem(tb) > target:
        tb = max(MIN_TILE_BLOCKS, tb - 32)
    if smem(tb) > SMEM_LIMIT:
        raise ValueError(
            f"block of {spec.block} values too large for the one-pass "
            f"kernels: a {tb}-block tile needs {smem(tb)} bytes of shared "
            f"memory, more than {SMEM_LIMIT}")
    return tb, smem(tb)


@functools.lru_cache(maxsize=64)
def pack_geometry(spec) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of ``csrc/pack.cu`` for ``spec``:
    the most blocks, up to 1,024, whose CTA takes at most
    ``PACK_SMEM_TARGET`` of shared memory (at 12-value blocks 1,024 for
    8-bit values, 800 for 16-bit and 416 for 32-bit ones)."""
    itemsize = spec.torch_dtype.itemsize
    return choose_tile(
        spec, 1024,
        lambda tb: pack_smem_bytes(itemsize, spec.max_width, spec.block, tb),
        PACK_SMEM_TARGET)


def pack_scratch_ints(frames: int, tiles: int) -> int:
    """int32 words of ``csrc/pack.cu``'s zeroed scratch: the ticket (and a
    pad word), two uint64 descriptors per (frame, tile), then the frames'
    largest widths."""
    return 2 + 4 * frames * tiles + frames


def words_cap(max_width: int, block: int, tile_blocks: int) -> int:
    """Stream words a CTA that holds a tile's words has room for
    (``csrc/tile.cuh:TileSmem::words_cap``): a tile of the widest fields,
    +6 for the bit and 16-byte phases and the two-word window, rounded to
    4."""
    return _round_up(-(-tile_blocks * (12 + block * max_width) // 32) + 6, 4)


def tile_smem_bytes(max_width: int, block: int, tile_blocks: int) -> int:
    """Dynamic shared memory of a CTA that holds a tile's stream words
    (``csrc/tile.cuh:TileSmem``: ``unpack.cu``, and the placement and
    extraction CTAs of the tiled kernels): :func:`words_cap` words, an int
    offset per block and a byte width per block and the one before
    (rounded to 16)."""
    return (4 * words_cap(max_width, block, tile_blocks) + 4 * tile_blocks
            + _round_up(tile_blocks + 1, 16))


def value_tile_smem(kernel: str, spec, tile_blocks: int) -> int:
    """Shared memory of a tiled kernel's CTA at tiles of ``tile_blocks``
    blocks: :func:`tile_smem_bytes` of the tile, or for a one-block tile
    of a chunk of at most ``TILE_VALUES`` values; raises ValueError above
    ``SMEM_LIMIT``."""
    vals = min(spec.block, TILE_VALUES) if tile_blocks == 1 else spec.block
    smem = tile_smem_bytes(spec.max_width, vals, tile_blocks)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel} tile of {tile_blocks} blocks needs "
                         f"{smem} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    return smem


def value_tile_geometry(kernel: str, spec) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of a tiled kernel for ``spec``:
    tiles of ``TILE_VALUES`` values in whole blocks, at least one (one
    block when a block is larger) and at most what the frame has. At most
    ~36 KB of shared memory (at 33-bit fields), so several CTAs share an
    SM."""
    tb = min(max(1, TILE_VALUES // spec.block), spec.nb)
    return tb, value_tile_smem(kernel, spec, tb)


@functools.lru_cache(maxsize=64)
def tiled_pack_geometry(spec) -> tuple[int, int]:
    """(tile_blocks, shared-memory bytes) of ``csrc/pack_tiled.cu``'s
    placement CTA for ``spec`` (:func:`value_tile_geometry`)."""
    return value_tile_geometry("tiled pack", spec)


def tiled_pack_scratch_ints(frames: int, tiles: int, nb: int) -> int:
    """int32 words of ``csrc/pack_tiled.cu``'s scratch: per (frame, tile)
    its bits without its first header and its largest width, the tile
    starts (F, T + 1), then the (F, nb) uint8 block widths."""
    return 2 * frames * tiles + frames * (tiles + 1) + -(-frames * nb // 4)


def defined_words(bits: torch.Tensor) -> torch.Tensor:
    """Words of each frame's stream that a pack defines: ``bits // 32 + 1``
    (the last holds the terminal zero byte when ``bits`` is a multiple of
    8)."""
    return (bits.to(torch.int64) >> 5) + 1


def stream_words(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``words`` with every word past :func:`defined_words` of its frame
    set to 0: what two packs of the same frames agree on."""
    col = torch.arange(words.shape[1], device=words.device)
    keep = col[None, :] < defined_words(bits).to(words.device)[:, None]
    return torch.where(keep, words, torch.zeros_like(words))


def header_codes(width: torch.Tensor, prev0: torch.Tensor | None = None):
    """(bits, values) of each block header from the (..., nb) widths. The
    repeat chain starts at ``prev0`` (...,), the width of the block before
    the first, or at width 0 as every frame does (Terse.hpp:505,517-535)."""
    first = (torch.zeros_like(width[..., :1]) if prev0 is None
             else prev0[..., None])
    prev = torch.cat([first, width[..., :-1]], dim=-1)
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


def block_widths(spec, frames: torch.Tensor):
    """The (F, nb, B) int64 values of a (F, n_padded) batch and the (F, nb)
    block widths: the bit length of the OR of a block's magnitudes, plus a
    sign bit for signed specs (Terse.hpp:553-554)."""
    F = frames.shape[0]
    x = _values64(spec, frames).reshape(F, spec.nb, spec.block)
    mag = x.abs() if spec.signed else x
    setbits = mag[..., 0]
    for j in range(1, spec.block):
        setbits = setbits | mag[..., j]
    width = _bit_length(setbits)
    if spec.signed:
        width = width + (setbits != 0)
    return x, width


def plan_batch(spec, frames: torch.Tensor) -> dict:
    """Per-block tables of a (F, n_padded) batch, as ``plan_frame`` makes
    them for one frame: ``width``, ``hb``, ``hv``, ``counts``, ``starts``
    (exclusive prefix of block bits) as (F, nb) int64, ``total_bits`` (F,)
    and ``values``, the (F, nb, B) int64 values."""
    x, width = block_widths(spec, frames)
    hb, hv = header_codes(width)
    counts = block_counts(spec, frames.device)
    block_bits = hb + width * counts
    ends = torch.cumsum(block_bits, dim=1)
    return dict(width=width, hb=hb, hv=hv, counts=counts,
                starts=ends - block_bits, total_bits=ends[:, -1], values=x)


def tile_tables_plain(spec, widths: torch.Tensor, tile_blocks: int):
    """Per-tile tables of a frame batch cut into tiles of ``tile_blocks``
    blocks, from its (F, nb) block widths, as int64 (F, T): ``tile_bits``,
    each tile's bits, whose first header is coded against the block before
    the tile as in the frame's stream (``pallas_unpack._tile_tables``);
    ``tile_start``, their exclusive prefix, the bit offset of each tile;
    ``prev0``, the width of block ``t * tile_blocks - 1`` (0 for t = 0)."""
    w = widths.to(torch.int64)
    F, Tb = w.shape[0], tile_blocks
    T = -(-spec.nb // Tb)
    hb, _ = header_codes(w)
    tile_bits = _tiles(hb + w * block_counts(spec, w.device), Tb).sum(dim=2)
    tile_start = torch.cumsum(tile_bits, dim=1) - tile_bits
    prev0 = torch.zeros((F, T), dtype=torch.int64, device=w.device)
    prev0[:, 1:] = w[:, Tb - 1 : (T - 1) * Tb : Tb]
    return tile_bits, tile_start, prev0


def _tiles(t: torch.Tensor, tile_blocks: int) -> torch.Tensor:
    """(F, nb) -> (F, T, tile_blocks), zero past the last block."""
    F, nb = t.shape
    T = -(-nb // tile_blocks)
    return torch.nn.functional.pad(t, (0, T * tile_blocks - nb)).reshape(
        F, T, tile_blocks)


def tiled_plan(spec, width: torch.Tensor, tile_blocks: int) -> dict:
    """Header codes and block offsets of a batch computed tile by tile, as
    the tiled kernels compute them: within each tile the untiled plan,
    with the tile's first header coded against ``prev0`` and its offsets
    shifted by ``tile_start`` (:func:`tile_tables_plain`). Returns ``hb``,
    ``hv``, ``starts`` (F, nb) and ``tile_bits`` (F, T), all int64."""
    w = width.to(torch.int64)
    F, nb = w.shape
    tile_bits, tile_start, prev0 = tile_tables_plain(spec, w, tile_blocks)
    wt = _tiles(w, tile_blocks)
    counts = _tiles(block_counts(spec, w.device).expand(F, nb), tile_blocks)
    hb, hv = header_codes(wt, prev0)
    bits = torch.where(counts > 0, hb + wt * counts, 0)
    starts = tile_start[..., None] + torch.cumsum(bits, dim=2) - bits

    def untile(t):
        return t.reshape(F, -1)[:, :nb]

    return dict(hb=untile(hb), hv=untile(hv), starts=untile(starts),
                tile_bits=tile_bits)


def _place(spec, values, width, hb, hv, counts, starts) -> torch.Tensor:
    """(F, n_words) int32 stream words: each block's header and fields,
    LSB first, at its absolute bit offset ``starts`` (all (F, nb) int64
    but ``values`` (F, nb, B) and ``counts`` (nb,) or (F, nb))."""
    F, B = values.shape[0], spec.block
    width = width[..., None]
    j = torch.arange(B, dtype=torch.int64, device=values.device)
    fields = torch.where(j < counts[..., None], values & ((1 << width) - 1),
                         0)
    offs = (starts + hb)[..., None] + j * width
    vals = torch.cat([hv[..., None], fields], dim=2).reshape(F, -1)
    offs = torch.cat([starts[..., None], offs], dim=2).reshape(F, -1)
    # a field of <= 33 bits at phase s spans word off>>5 and the next one
    s = offs & 31
    lo = (vals & ((1 << (32 - s)) - 1)) << s
    hi = vals >> (32 - s)
    words = torch.zeros((F, spec.n_words), dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(1, offs >> 5, lo)
    words.scatter_add_(1, (offs >> 5) + 1, hi)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def encode_batch_plain(spec, frames: torch.Tensor):
    """Plain PyTorch encode of a (F, n_padded) batch on its own device;
    the reference the pack kernel is held against."""
    p = plan_batch(spec, frames)
    words = _place(spec, p["values"], p["width"], p["hb"], p["hv"],
                   p["counts"], p["starts"])
    return (words, p["total_bits"].to(torch.int32),
            p["width"].amax(dim=1).to(torch.int32))


def encode_batch_tiled_plain(spec, frames: torch.Tensor,
                             tile_blocks: int | None = None):
    """Plain PyTorch encode of a (F, n_padded) batch in tiles of
    ``tile_blocks`` blocks (:func:`tiled_plan`; by default those of
    :func:`tiled_pack_geometry`), on its own device; the reference the
    tiled pack kernels are held against."""
    if tile_blocks is None:
        tile_blocks = tiled_pack_geometry(spec)[0]
    x, width = block_widths(spec, frames)
    p = tiled_plan(spec, width, tile_blocks)
    words = _place(spec, x, width, p["hb"], p["hv"],
                   block_counts(spec, frames.device), p["starts"])
    return (words, p["tile_bits"].sum(dim=1).to(torch.int32),
            width.amax(dim=1).to(torch.int32))


def _check(spec, frames: torch.Tensor) -> None:
    if spec.worst_bits >= 2**31:
        # the kernels' bit offsets are int32
        raise ValueError("frame too large for 32-bit bit offsets")
    if frames.dtype != spec.torch_dtype:
        raise TypeError(f"frames must be {spec.torch_dtype} for {spec}, "
                        f"got {frames.dtype}")
    if frames.ndim != 2 or frames.shape[1] != spec.n_padded \
            or frames.shape[0] < 1:
        raise ValueError(f"frames must be (F >= 1, {spec.n_padded}), got "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")


def check_tile_blocks(spec, tile_blocks) -> int:
    """``tile_blocks`` as an int >= 1, capped at the frame's block count
    (a larger tile holds the same blocks)."""
    tile_blocks = operator.index(tile_blocks)
    if tile_blocks < 1:
        raise ValueError(f"tile_blocks must be >= 1, got {tile_blocks}")
    return min(tile_blocks, spec.nb)


def encode_batch(spec, frames: torch.Tensor):
    """Encode a (F, n_padded) batch: the CUDA pack kernel for a CUDA
    tensor, :func:`encode_batch_plain` for a CPU tensor. Padding values
    must be zero. Only :func:`defined_words` of each frame's words are
    defined. Counts kernel launches in ``encode_batch.launches``."""
    _check(spec, frames)
    if frames.device.type == "cpu":
        return encode_batch_plain(spec, frames)
    if frames.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {frames.device}")
    tile_blocks, smem = pack_geometry(spec)
    lib = _build.load()
    F = frames.shape[0]
    dev = frames.device
    T = -(-spec.nb // tile_blocks)
    words = torch.empty((F, spec.n_words), dtype=torch.int32, device=dev)
    bits = torch.empty((F,), dtype=torch.int32, device=dev)
    # ticket, tile descriptors and the frames' largest widths, all zero
    scratch = torch.zeros((pack_scratch_ints(F, T),), dtype=torch.int32,
                          device=dev)
    rc = lib.trpx_pack(
        frames.data_ptr(), frames.element_size(), int(spec.signed), F,
        spec.n, spec.n_padded, spec.block, spec.n_words, tile_blocks, smem,
        words.data_ptr(), bits.data_ptr(), scratch.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pack")
    _build.count_launch(encode_batch)
    return words, bits, scratch[-F:]


encode_batch.launches = 0


def encode_batch_tiled(spec, frames: torch.Tensor,
                       tile_blocks: int | None = None):
    """Encode a (F, n_padded) batch in tiles of ``tile_blocks`` blocks (by
    default those of :func:`tiled_pack_geometry`): the CUDA kernels of
    ``csrc/pack_tiled.cu`` for a CUDA tensor,
    :func:`encode_batch_tiled_plain` for a CPU tensor. Padding values must
    be zero. As for :func:`encode_batch`, only :func:`defined_words` of
    each frame's words are defined. Counts kernel launches in
    ``encode_batch_tiled.launches``."""
    _check(spec, frames)
    if tile_blocks is None:
        tile_blocks, smem = tiled_pack_geometry(spec)
    else:
        tile_blocks = check_tile_blocks(spec, tile_blocks)
        smem = None
    if frames.device.type == "cpu":
        return encode_batch_tiled_plain(spec, frames, tile_blocks)
    if frames.device.type != "cuda":
        raise ValueError(f"no tiled pack kernel for device {frames.device}")
    if smem is None:
        smem = value_tile_smem("tiled pack", spec, tile_blocks)
    lib = _build.load()
    F = frames.shape[0]
    dev = frames.device
    T = -(-spec.nb // tile_blocks)
    words = torch.empty((F, spec.n_words), dtype=torch.int32, device=dev)
    bits = torch.empty((F,), dtype=torch.int32, device=dev)
    maxw = torch.empty((F,), dtype=torch.int32, device=dev)
    # scratch, freed in stream order after the launches
    scratch = torch.empty((tiled_pack_scratch_ints(F, T, spec.nb),),
                          dtype=torch.int32, device=dev)
    rc = lib.trpx_pack_tiled(
        frames.data_ptr(), frames.element_size(), int(spec.signed), F,
        spec.n, spec.n_padded, spec.block, spec.n_words, tile_blocks, smem,
        words.data_ptr(), bits.data_ptr(), maxw.data_ptr(),
        scratch.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tiled pack")
    _build.count_launch(encode_batch_tiled)
    return words, bits, maxw


encode_batch_tiled.launches = 0
