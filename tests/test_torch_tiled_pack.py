"""PyTorch port, tiled encode (big frames, wide blocks): the plain version
of the tiled pack kernels (CPU tensors), at 64-block tiles and at the
kernels' default tiles (``tiled_pack_geometry``), against the JAX
package's tiled Pallas encode in interpret mode at 64-block tiles, against
the untiled plain version, on the golden vectors, at one-block tiles of
blocks larger than a tile, and the routing of big frames to the tiled
wrappers.

Inputs are made with numpy from fixed seeds. The tolerance is exact: TRPX
is a lossless integer codec. The CUDA kernels themselves are held against
this plain version in tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

import trpx_tpu_torch
from _torch_helpers import pad_batch
from test_format_golden import GOLDEN
from test_torch_pack import _any_frames
from trpx_tpu.ops import coding as jcoding
from trpx_tpu.ops import pallas_pack
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_pack import (
    TILE_VALUES,
    encode_batch_plain,
    encode_batch_tiled,
    encode_batch_tiled_plain,
    tiled_pack_geometry,
)

TB = 64  # blocks per tile under test, as tests/test_pallas_tiled.py
I32_MIN = np.iinfo(np.int32).min
DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32]


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(pallas_pack, "TILE_BLOCKS", TB)


def _jax_case(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "u16":
        fr = rng.poisson(3.0, (2, n)).astype(np.uint16)
        fr[0, 5] = 60000
        fr[1, TB * 12] = 65535           # tile 1's first value
    elif kind == "const":
        fr = np.full((1, n), 5, np.uint16)  # 1-bit headers at every edge
    else:
        fr = rng.integers(-1000, 1000, (2, n)).astype(np.int32)
        fr[0, 0] = I32_MIN               # 33-bit fields
        fr[1, TB * 12] = I32_MIN         # tile 1's first value
        fr[1, TB * 12 - 1] = I32_MIN     # tile 0's last value
    return fr


@pytest.mark.parametrize("kind,n", [
    ("u16", TB * 12 * 3 + 100),   # partial last tile and block
    ("u16", TB * 12 * 2),
    ("u16", TB * 12 + 7),
    ("const", TB * 12 * 4),
    ("i32", TB * 12 * 3 + 50),
])
def test_tiled_plain_matches_pallas_tiled(small_tiles, kind, n):
    fr = _jax_case(kind, n)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    padded = np.zeros((fr.shape[0], jspec.tree_rows * jspec.block), fr.dtype)
    padded[:, :n] = fr
    jw, jb, jm, _ = jax.device_get(
        pallas_pack.encode_batch_pallas_tiled(jspec, padded, True))
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    w, b, m = encode_batch_tiled_plain(
        spec, torch.from_numpy(pad_batch(fr, spec)), TB)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(m.numpy(), jm)
    # JAX leaves words past each frame's bytes unspecified: compare the
    # archives, which keep only the bytes inside each frame
    ours = tcoding.assemble_archive(spec, w.numpy().view(np.uint32),
                                    b.numpy(), m.numpy())
    ref = jcoding.assemble_archive(jspec, np.asarray(jw), np.asarray(jb),
                                   np.asarray(jm))
    assert ours.to_bytes() == ref.to_bytes()
    assert ours.to_bytes() == ncodec.encode(fr).to_bytes()


@pytest.mark.parametrize("kind", ["u16", "i32"])
def test_default_tiles_match_pallas_tiled(small_tiles, kind):
    """The tiled plain version at the kernels' default tiles (three of
    ``tiled_pack_geometry``'s 682 blocks, the last partial) against the
    tiled Pallas encode at 64-block tiles and the untiled plain version."""
    n = 2 * TILE_VALUES + 100
    fr = _jax_case(kind, n)
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    assert -(-spec.nb // tiled_pack_geometry(spec)[0]) == 3
    x = torch.from_numpy(pad_batch(fr, spec))
    w, b, m = encode_batch_tiled_plain(spec, x)
    for g, want in zip((w, b, m), encode_batch_plain(spec, x)):
        assert torch.equal(g, want)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    padded = np.zeros((fr.shape[0], jspec.tree_rows * jspec.block), fr.dtype)
    padded[:, :n] = fr
    jw, jb, jm, _ = jax.device_get(
        pallas_pack.encode_batch_pallas_tiled(jspec, padded, True))
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(m.numpy(), jm)
    ours = tcoding.assemble_archive(spec, w.numpy().view(np.uint32),
                                    b.numpy(), m.numpy())
    ref = jcoding.assemble_archive(jspec, np.asarray(jw), np.asarray(jb),
                                   np.asarray(jm))
    assert ours.to_bytes() == ref.to_bytes()


def big_block_frames(dtype, seed: int = 0):
    """Three frames in blocks of ``BIG_BLOCK`` values, more than a tile's
    value budget: random data with the widest field on both sides of the
    first chunk edge (value ``TILE_VALUES``), a zero block, and a partial
    last block."""
    n = 3 * BIG_BLOCK + 17
    rng = np.random.default_rng(seed + n)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-300, 300, (3, n)).clip(info.min, info.max)
    else:
        fr = rng.poisson(3.0, (3, n))
    fr = fr.astype(dtype)
    widest = info.min if info.min < 0 else info.max
    fr[0, TILE_VALUES - 1 : TILE_VALUES + 1] = widest
    fr[1, BIG_BLOCK : 2 * BIG_BLOCK] = 0
    fr[2, -1] = widest
    return fr


#: values in a block larger than a tile of the tiled kernels
BIG_BLOCK = TILE_VALUES + 808


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_block_tiles_of_blocks_larger_than_a_tile(dtype):
    """Blocks larger than ``TILE_VALUES`` values: the default tiles are
    one block each (which the kernel places in chunks). The tiled plain
    version there against the untiled plain version, exactly, and its
    archive against the native codec's bytes. The JAX package's encoders
    take minutes on the CPU at such blocks, so they are not run here."""
    fr = big_block_frames(dtype)
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], dtype, BIG_BLOCK)
    assert tiled_pack_geometry(spec)[0] == 1
    x = torch.from_numpy(pad_batch(fr, spec))
    got = encode_batch_tiled(spec, x)   # CPU: plain version
    for g, w in zip(got, encode_batch_plain(spec, x)):
        assert torch.equal(g, w)
    w, b, m = (a.numpy() for a in got)
    arch = tcoding.assemble_archive(spec, w.view(np.uint32), b, m)
    assert arch.to_bytes() == ncodec.encode(fr, block=BIG_BLOCK).to_bytes()


def edge_frames(dtype, n: int = TB * 12 * 3 + 101, seed: int = 0):
    """Four frames with the tiled kernels' hard cases at 64-block tiles:
    random data (with the widest field), a constant frame, a first tile of
    width 0 and a whole zero tile, and for signed types INT_MIN at a
    tile's first and last value."""
    rng = np.random.default_rng(seed + n)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-300, 300, (4, n)).clip(info.min, info.max)
        fr = fr.astype(dtype)
        fr[0, 7] = info.min
        fr[3, TB * 12] = info.min
        fr[3, 2 * TB * 12 - 1] = info.min
    else:
        fr = rng.poisson(3.0, (4, n)).astype(dtype)
        fr[0, 7] = info.max
        fr[3, TB * 12] = info.max
    fr[1] = 5
    fr[2, : 2 * TB * 12 + 5] = 0
    return fr


@pytest.mark.parametrize("tile_blocks", [1, 3, TB, 1000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_plain_equals_untiled_plain(dtype, tile_blocks):
    fr = edge_frames(dtype)
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], dtype)
    x = torch.from_numpy(pad_batch(fr, spec))
    before = encode_batch_tiled.launches
    got = encode_batch_tiled(spec, x, tile_blocks)   # CPU: plain version
    assert encode_batch_tiled.launches == before
    for g, w in zip(got, encode_batch_plain(spec, x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tile_blocks", [1, 2])
@pytest.mark.parametrize("name,vals,dtype,block,attrs,payload_hex", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_vectors_through_tiled_encode(name, vals, dtype, block, attrs,
                                             payload_hex, tile_blocks):
    """Every golden vector with a tile edge after every block or two."""
    arr = np.array(vals, dtype=dtype)[None]
    spec = tcoding.FrameSpec.for_dtype(arr.shape[1], dtype, block)
    w, b, m = encode_batch_tiled_plain(
        spec, torch.from_numpy(pad_batch(arr, spec)), tile_blocks)
    arch = tcoding.assemble_archive(spec, w.numpy().view(np.uint32),
                                    b.numpy(), m.numpy())
    assert arch.payload == bytes.fromhex(payload_hex.replace(" ", ""))
    for key, value in attrs.items():
        assert int(getattr(arch.meta, key)) == value, key


def test_tiled_routing_by_block_count():
    """Encodes of few frames take the tiled pack only for frames of at
    least TILED_MIN_BLOCKS blocks (a 2048x2048 frame's)."""
    spec = tcoding.FrameSpec.for_dtype
    for side in (2048, 4096):                           # >= 349,526 blocks
        assert spec(side * side, np.uint32).tiled_pack(1)
    for side in (256, 512, 1024):                       # <= 87,382 blocks
        assert not spec(side * side, np.uint32).tiled_pack(1)
    edge = tcoding.TILED_MIN_BLOCKS * 12
    assert not spec(edge - 12, np.uint16).tiled_pack(1)
    assert spec(edge, np.uint16).tiled_pack(1)


def test_tiled_routing_by_frame_count():
    """Decodes of fewer than TILED_MAX_FRAMES frames take the tiled unpack
    whatever their size: one 512x512 u16 frame, the 2048x2048 u32 batches
    of 32 and the 4096x4096 batches of 8 do, the 512x512 u16 batches of
    256 take the one-pass unpack. Encodes of fewer than
    TILED_PACK_MAX_FRAMES big frames take the tiled pack, as do blocks of
    hundreds of 32-bit values; the one-pass pack takes every other
    batch."""
    spec = tcoding.FrameSpec.for_dtype
    assert not spec(512 * 512, np.uint16).tiled(256)
    assert spec(512 * 512, np.uint16).tiled(1)
    assert spec(2048 * 2048, np.uint32).tiled(32)
    assert spec(4096 * 4096, np.uint32).tiled(8)
    many = tcoding.TILED_PACK_MAX_FRAMES
    for dtype in (np.uint8, np.int16, np.uint32, np.int32):
        for block in (3, 12, 64, 512):
            assert not spec(4096 * 4096, dtype, block).tiled_pack(many)
    assert spec(4096, np.int32, 1024).tiled_pack(256)
    assert spec(4096, np.uint32, 1024).tiled_pack(256)
    assert not spec(4096, np.uint16, 1024).tiled_pack(256)
    assert spec(2048 * 2048, np.uint32).tiled_pack(many - 1)
    assert not spec(2048 * 2048, np.uint32).tiled_pack(many)
    limit = tcoding.TILED_MAX_FRAMES
    assert spec(2048 * 2048, np.uint32).tiled(limit - 1)
    assert not spec(2048 * 2048, np.uint32).tiled(limit)
    assert not spec(1024 * 1024, np.uint32).tiled(limit)


def test_big_frame_takes_the_tiled_wrappers(monkeypatch):
    """One overflow-heavy 2048x2048 u32 frame through compress/decompress
    on the CPU: the tiled pack and the tiled unpack run, the other two
    wrappers never."""
    rng = np.random.default_rng(2048)
    fr = rng.poisson(3.0, (1, 2048, 2048)).astype(np.uint32)
    fr.reshape(-1)[rng.integers(0, fr.size, 200)] = 2_000_000_000
    calls = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    def refuse(*args, **kwargs):
        raise AssertionError("a big frame took the wrong kernel")

    for name in ("encode_batch_tiled", "decode_batch_tiled"):
        monkeypatch.setattr(tcoding, name, spy(getattr(tcoding, name)))
    monkeypatch.setattr(tcoding, "encode_batch", refuse)
    monkeypatch.setattr(tcoding, "decode_batch", refuse)
    arch = trpx_tpu_torch.compress(fr, device="cpu")
    assert arch.to_bytes() == ncodec.encode(
        fr.reshape(1, -1), dimensions=(2048, 2048)).to_bytes()
    out = trpx_tpu_torch.decompress(TrpxArchive.from_bytes(arch.to_bytes()),
                                    device="cpu")
    np.testing.assert_array_equal(out, fr[0])
    assert calls == ["encode_batch_tiled", "decode_batch_tiled"]


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_wide_blocks_take_the_tiled_pack(monkeypatch, dtype):
    """Blocks of 1,024 32-bit values are too large for a tile of the
    one-pass pack: compress takes the tiled pack, whose tiles have no
    shared-memory size, and the bytes equal the native codec's."""
    calls = []
    real = tcoding.encode_batch_tiled

    def spy(spec, x):
        calls.append(len(x))
        return real(spec, x, 4)

    monkeypatch.setattr(tcoding, "encode_batch_tiled", spy)
    monkeypatch.setattr(tcoding, "encode_batch", None)   # must not run
    fr = _any_frames(dtype, 5000, seed=1024).reshape(3, 50, 100)
    arch = trpx_tpu_torch.compress(fr, block=1024, device="cpu")
    assert calls == [3]
    assert arch.to_bytes() == ncodec.encode(
        fr.reshape(3, -1), block=1024, dimensions=(100, 50)).to_bytes()
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(arch.to_bytes(), dtype=dtype,
                                  device="cpu"), fr)


def test_tiled_wrapper_checks_inputs():
    spec = tcoding.FrameSpec.for_dtype(100, np.uint16)
    good = torch.zeros((2, spec.n_padded), dtype=torch.uint16)
    with pytest.raises(ValueError, match="tile_blocks"):
        encode_batch_tiled(spec, good, 0)
    with pytest.raises(TypeError):
        encode_batch_tiled(spec, good, 2.5)
    with pytest.raises(TypeError):
        encode_batch_tiled(spec, good.view(torch.int16))
    with pytest.raises(ValueError):
        encode_batch_tiled(spec, good[:, :100])
    # the kernels' bit offsets are int32, whatever made the spec
    huge = tcoding.FrameSpec(n=2**26, block=12, signed=True, max_width=33)
    with pytest.raises(ValueError, match="32-bit bit offsets"):
        encode_batch_tiled(huge, torch.zeros((1, 12), dtype=torch.int32))
    # no fallback: a device without a kernel raises
    with pytest.raises(ValueError, match="no tiled pack kernel"):
        encode_batch_tiled(spec, good.to("meta"))
