"""PyTorch port, tiled decode (big frames, wide blocks): the plain version
of the tiled unpack kernels (CPU tensors), at 64-block tiles and at the
kernels' default tiles (``tiled_unpack_geometry``), against the JAX
package's tiled Pallas decode in interpret mode at 64-block tiles, the
tile tables against the JAX host prepass, against the untiled plain
version, on the golden vectors, and at one-block tiles of blocks larger
than a tile.

Inputs are made with numpy from fixed seeds; the tolerance is exact
(lossless integer codec). The CUDA kernels themselves are held against
this plain version in tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from test_format_golden import GOLDEN
from test_torch_tiled_pack import (
    BIG_BLOCK,
    DTYPES,
    TB,
    big_block_frames,
    edge_frames,
)
from trpx_tpu.format.pycodec import TrpxArchive as JTrpxArchive
from trpx_tpu.ops import coding as jcoding
from trpx_tpu.ops import pallas_unpack
from trpx_tpu_torch.format import encode as format_encode
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_pack import TILE_VALUES, tile_tables_plain
from trpx_tpu_torch.ops.cuda_unpack import (
    decode_batch_plain,
    decode_batch_tiled,
    decode_batch_tiled_plain,
    decoded_dtype,
    tiled_unpack_geometry,
)


def _foreign(arch):
    """The archive as a reader of its bytes sees it: no frame index."""
    return TrpxArchive.from_bytes(arch.to_bytes())


def _jax(arch):
    """The same bytes as an archive of the JAX package."""
    return JTrpxArchive.from_bytes(arch.to_bytes())


def _decode_case(kind: str, n: int) -> np.ndarray:
    """The cases of tests/test_pallas_tiled_decode.py."""
    rng = np.random.default_rng(n)
    if kind == "u16":
        fr = rng.poisson(3.0, (3, n)).astype(np.uint16)
        fr[0, 5] = 60000
        fr[1, n - 1] = 40000          # wide field at the very stream tail
        fr[2] = 5                     # 1-bit repeat headers across edges
    elif kind == "i32":
        fr = rng.integers(-1000, 1000, (2, n)).astype(np.int32)
        fr[0, 0] = np.iinfo(np.int32).min        # width-33 field
        fr[1, TB * 12] = np.iinfo(np.int32).max  # tile 1's first value
    else:  # sparse: whole tiles of width 0
        fr = np.zeros((2, n), np.uint16)
        fr[0, 3] = 900                # data only in tile 0
        fr[1, n - 2] = 1234           # data only in the last, partial tile
    return fr


@pytest.mark.parametrize("kind,n", [("u16", TB * 12 * 3 + 100),
                                    ("i32", TB * 12 * 3 + 50),
                                    ("sparse", TB * 12 * 4 + 30)])
def test_tiled_plain_matches_pallas_tiled(kind, n):
    fr = _decode_case(kind, n)
    arch = ncodec.encode(fr)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    jwidths, _, jwords = jcoding.walk_archive(_jax(arch), jspec)
    ref = jax.device_get(pallas_unpack.decode_tiled_host(
        jspec, jwords, jwidths, interpret=True, tile_blocks=TB))
    ref = jcoding.narrow_values(pallas_unpack.flatten_decoded(ref, n),
                                fr.dtype)
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    widths, words = tcoding.walk_archive(_foreign(arch), spec)
    out = decode_batch_tiled_plain(
        spec, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(widths.astype(np.uint8)), decoded_dtype(spec), TB)
    ours = tcoding.narrow_values(out.numpy(), fr.dtype)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, fr)


@pytest.mark.parametrize("kind", ["u16", "i32"])
def test_default_tiles_match_pallas_tiled(kind):
    """The tiled plain version at the kernels' default tiles (three of
    ``tiled_unpack_geometry``'s 682 blocks, the last partial) against the
    tiled Pallas decode at 64-block tiles, the untiled plain version and
    the frames."""
    n = 2 * TILE_VALUES + 100
    fr = _decode_case(kind, n)
    arch = ncodec.encode(fr)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    jwidths, _, jwords = jcoding.walk_archive(_jax(arch), jspec)
    ref = jax.device_get(pallas_unpack.decode_tiled_host(
        jspec, jwords, jwidths, interpret=True, tile_blocks=TB))
    ref = jcoding.narrow_values(pallas_unpack.flatten_decoded(ref, n),
                                fr.dtype)
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    assert -(-spec.nb // tiled_unpack_geometry(spec)[0]) == 3
    widths, words = tcoding.walk_archive(_foreign(arch), spec)
    words = torch.from_numpy(words.view(np.int32))
    widths = torch.from_numpy(widths.astype(np.uint8))
    out = decode_batch_tiled_plain(spec, words, widths, decoded_dtype(spec))
    assert torch.equal(out, decode_batch_plain(spec, words, widths,
                                               decoded_dtype(spec)))
    ours = tcoding.narrow_values(out.numpy(), fr.dtype)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, fr)


@pytest.mark.parametrize("tile_blocks", [1, 8, TB])
@pytest.mark.parametrize("kind,n", [("u16", TB * 12 * 3 + 100),
                                    ("i32", TB * 12 * 3 + 50),
                                    ("sparse", TB * 12 * 4 + 30)])
def test_tile_tables_match_jax_prepass(kind, n, tile_blocks):
    fr = _decode_case(kind, n)
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    widths, words = tcoding.walk_archive(ncodec.encode(fr), spec)
    tile_bits, tile_start, prev0 = tile_tables_plain(
        spec, torch.from_numpy(widths), tile_blocks)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    jbits, _ = pallas_unpack._tile_tables(jspec, widths, tile_blocks)
    _, shift, jprev0, _ = pallas_unpack.tile_prepass(
        jspec, widths, words.view(np.uint32), tile_blocks)
    np.testing.assert_array_equal(tile_bits.numpy(), jbits)
    np.testing.assert_array_equal(tile_start.numpy() & 31, shift)
    np.testing.assert_array_equal(prev0.numpy(), jprev0)
    # each tile starts where the tiles before it end
    np.testing.assert_array_equal(tile_start.numpy()[:, 1:],
                                  np.cumsum(jbits, axis=1)[:, :-1])


def _inputs(fr):
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], fr.dtype)
    widths, words = tcoding.walk_archive(ncodec.encode(fr), spec)
    return (spec, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(widths.astype(np.uint8)))


@pytest.mark.parametrize("tile_blocks", [1, 3, TB, 1000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_plain_equals_untiled_plain(dtype, tile_blocks):
    fr = edge_frames(dtype, seed=1)
    spec, words, widths = _inputs(fr)
    for odt in {decoded_dtype(spec), torch.int32}:
        before = decode_batch_tiled.launches
        got = decode_batch_tiled(spec, words, widths, odt, tile_blocks)
        assert decode_batch_tiled.launches == before   # CPU: plain version
        want = decode_batch_plain(spec, words, widths, odt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        tcoding.narrow_values(got.numpy(), dtype), fr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_block_tiles_of_blocks_larger_than_a_tile(dtype):
    """Blocks larger than ``TILE_VALUES`` values: the default tiles are
    one block each (which the kernel decodes in chunks). The tiled plain
    version there against the untiled plain version and the frames,
    exactly, into both output types. The JAX package's decoders take
    minutes on the CPU at such blocks, so they are not run here."""
    fr = big_block_frames(dtype, seed=1)
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], dtype, BIG_BLOCK)
    assert tiled_unpack_geometry(spec)[0] == 1
    widths, words = tcoding.walk_archive(
        ncodec.encode(fr, block=BIG_BLOCK), spec)
    words = torch.from_numpy(words.view(np.int32))
    widths = torch.from_numpy(widths.astype(np.uint8))
    for odt in {decoded_dtype(spec), torch.int32}:
        got = decode_batch_tiled(spec, words, widths, odt)   # CPU: plain
        want = decode_batch_plain(spec, words, widths, odt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        tcoding.narrow_values(got.numpy(), dtype), fr)


@pytest.mark.parametrize("tile_blocks", [1, 2])
@pytest.mark.parametrize("name,vals,dtype,block,attrs,payload_hex", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_vectors_through_tiled_decode(name, vals, dtype, block, attrs,
                                             payload_hex, tile_blocks):
    arr = np.array(vals, dtype=dtype)
    arch = format_encode(arr, block=block)
    assert arch.payload == bytes.fromhex(payload_hex.replace(" ", ""))
    spec = tcoding.FrameSpec.for_dtype(arr.size, dtype, block)
    widths, words = tcoding.walk_archive(_foreign(arch), spec)
    out = decode_batch_tiled_plain(
        spec, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(widths.astype(np.uint8)), decoded_dtype(spec),
        tile_blocks)
    np.testing.assert_array_equal(
        tcoding.narrow_values(out.numpy(), dtype)[0], arr)


def test_tiled_wrapper_checks_inputs():
    spec, words, widths = _inputs(edge_frames(np.uint16))
    with pytest.raises(ValueError, match="tile_blocks"):
        decode_batch_tiled(spec, words, widths, torch.uint16, -1)
    with pytest.raises(TypeError):
        decode_batch_tiled(spec, words, widths, torch.int16)
    with pytest.raises(ValueError):
        decode_batch_tiled(spec, words, widths[:, 1:], torch.uint16)
    with pytest.raises(ValueError):
        decode_batch_tiled(spec, words[:, ::2], widths, torch.uint16)
    huge = tcoding.FrameSpec(n=2**26, block=12, signed=True, max_width=33)
    with pytest.raises(ValueError, match="32-bit bit offsets"):
        decode_batch_tiled(huge, words, widths, torch.int32)
    # no fallback: a device without a kernel raises
    with pytest.raises(ValueError, match="no tiled unpack kernel"):
        decode_batch_tiled(spec, words.to("meta"), widths.to("meta"),
                           torch.uint16)
