"""PyTorch port on a CUDA card: each kernel against its plain version.

Every test here needs a card and skips without one. The module imports
nothing of JAX, so on a machine with a card and without JAX it runs
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact (lossless integer codec).
"""

import numpy as np
import pytest
import torch

from trpx_tpu.native import codec as ncodec
from trpx_tpu_torch import compress, decompress
from trpx_tpu_torch.ops import (
    TILE_BLOCKS,
    FrameSpec,
    decode_batch,
    decode_batch_plain,
    decode_batch_tiled,
    decode_batch_tiled_plain,
    decoded_dtype,
    encode_batch,
    encode_batch_plain,
    encode_batch_tiled,
    encode_batch_tiled_plain,
    walk_archive,
)
from trpx_tpu_torch.ops.coding import _pad_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(dtype, n, seed, F=3):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-300, 300, (F, n)).clip(info.min, info.max)
        fr = fr.astype(dtype)
        fr[0, 0] = info.min
    else:
        fr = rng.poisson(3.0, (F, n)).astype(dtype)
        fr[0, rng.integers(0, n, 20)] = info.max
    fr[-1, : min(n, 40)] = 0
    return fr


CASES = [(np.uint16, 512 * 512), (np.uint16, 1000), (np.uint16, 100),
         (np.uint8, 1001), (np.int8, 999), (np.int16, 1000),
         (np.uint32, 777), (np.int32, 1001)]


@pytest.mark.parametrize("dtype,n", CASES)
def test_pack_kernel_matches_plain(cuda, dtype, n):
    fr = _frames(dtype, n, seed=n)
    spec = FrameSpec.for_dtype(n, dtype)
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
    before = encode_batch.launches
    got = encode_batch(spec, x)
    assert encode_batch.launches == before + 1
    for g, w in zip(got, encode_batch_plain(spec, x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,n", CASES)
def test_unpack_kernel_matches_plain(cuda, dtype, n):
    fr = _frames(dtype, n, seed=n + 1)
    spec = FrameSpec.for_dtype(n, dtype)
    widths, words = walk_archive(ncodec.encode(fr), spec)
    wd = torch.from_numpy(widths.astype(np.uint8)).to(cuda)
    wo = torch.from_numpy(words.view(np.int32)).to(cuda)
    for odt in {decoded_dtype(spec), torch.int32}:
        before = decode_batch.launches
        got = decode_batch(spec, wo, wd, odt)
        assert decode_batch.launches == before + 1
        want = decode_batch_plain(spec, wo, wd, odt)
        if odt == torch.uint16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        decode_batch(spec, wo, wd, decoded_dtype(spec)).cpu().numpy()
        .astype(dtype), fr)


def test_signed_target_sign_extends_on_card(cuda):
    fr = _frames(np.uint16, 600, seed=3)
    fr[fr > 2**14] = 2**14
    arch = ncodec.encode(fr)
    out = decompress(arch, dtype=np.int16, device=cuda)
    np.testing.assert_array_equal(out, ncodec.decode(arch, np.int16))


def test_main_path_round_trip(cuda):
    """A batch of 256 512x512 u16 frames takes the untiled kernels."""
    fr = _frames(np.uint16, 512 * 512, seed=9, F=256).reshape(256, 512, 512)
    e0, d0 = encode_batch.launches, decode_batch.launches
    tiled = (encode_batch_tiled.launches, decode_batch_tiled.launches)
    arch = compress(fr, device=cuda)
    assert arch.to_bytes() == ncodec.encode(
        fr.reshape(256, -1), dimensions=(512, 512)).to_bytes()
    np.testing.assert_array_equal(decompress(arch, device=cuda), fr)
    assert encode_batch.launches > e0 and decode_batch.launches > d0
    assert (encode_batch_tiled.launches,
            decode_batch_tiled.launches) == tiled


def _tiled_frames(dtype, n, seed):
    """Frames that cross 64-block tile edges with the hard cases: a
    constant frame (repeat headers at every edge), a first tile of width
    0, and for signed types the widest field at a tile's first and last
    value."""
    fr = _frames(dtype, n, seed, F=4)
    fr[1] = 5
    fr[2, : 64 * 12 + 5] = 0
    info = np.iinfo(dtype)
    if info.min < 0:
        fr[3, 64 * 12] = info.min
        fr[3, 2 * 64 * 12 - 1] = info.min
    return fr


TILED_CASES = [(np.uint8, 64 * 12 * 3 + 100), (np.int8, 64 * 12 * 2),
               (np.uint16, 64 * 12 * 3 + 7), (np.int16, 64 * 12 * 4 + 30),
               (np.uint32, 64 * 12 * 3 + 100), (np.int32, 64 * 12 * 3 + 50)]


@pytest.mark.parametrize("tile_blocks", [64, TILE_BLOCKS])
@pytest.mark.parametrize("dtype,n", TILED_CASES)
def test_tiled_pack_kernel_matches_plain(cuda, dtype, n, tile_blocks):
    fr = _tiled_frames(dtype, n, seed=n)
    spec = FrameSpec.for_dtype(n, dtype)
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
    before = encode_batch_tiled.launches
    got = encode_batch_tiled(spec, x, tile_blocks)
    assert encode_batch_tiled.launches == before + 1
    for g, w in zip(got, encode_batch_tiled_plain(spec, x, tile_blocks)):
        assert torch.equal(g, w)
    for g, w in zip(got, encode_batch_plain(spec, x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tile_blocks", [64, TILE_BLOCKS])
@pytest.mark.parametrize("dtype,n", TILED_CASES)
def test_tiled_unpack_kernel_matches_plain(cuda, dtype, n, tile_blocks):
    fr = _tiled_frames(dtype, n, seed=n + 1)
    spec = FrameSpec.for_dtype(n, dtype)
    widths, words = walk_archive(ncodec.encode(fr), spec)
    wd = torch.from_numpy(widths.astype(np.uint8)).to(cuda)
    wo = torch.from_numpy(words.view(np.int32)).to(cuda)
    for odt in {decoded_dtype(spec), torch.int32}:
        before = decode_batch_tiled.launches
        got = decode_batch_tiled(spec, wo, wd, odt, tile_blocks)
        assert decode_batch_tiled.launches == before + 1
        want = decode_batch_tiled_plain(spec, wo, wd, odt, tile_blocks)
        if odt == torch.uint16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        decode_batch_tiled(spec, wo, wd, decoded_dtype(spec), tile_blocks)
        .cpu().numpy().astype(dtype), fr)


def test_big_frame_path_round_trip(cuda):
    """2048x2048 u32 frames take the tiled kernels and only them."""
    rng = np.random.default_rng(2048)
    fr = rng.poisson(3.0, (2, 2048 * 2048)).astype(np.uint32)
    fr[np.repeat([0, 1], 200), rng.integers(0, fr.shape[1], 400)] = \
        2_000_000_000
    fr = fr.reshape(2, 2048, 2048)
    counts = (encode_batch.launches, decode_batch.launches,
              encode_batch_tiled.launches, decode_batch_tiled.launches)
    arch = compress(fr, device=cuda)
    assert arch.to_bytes() == ncodec.encode(
        fr.reshape(2, -1), dimensions=(2048, 2048)).to_bytes()
    np.testing.assert_array_equal(decompress(arch, device=cuda), fr)
    after = (encode_batch.launches, decode_batch.launches,
             encode_batch_tiled.launches, decode_batch_tiled.launches)
    assert after[:2] == counts[:2]
    assert after[2] > counts[2] and after[3] > counts[3]


def test_stream_encoder_on_card_equals_cpu_run(cuda, tmp_path):
    """Chunks of 5 through two pinned staging buffers (each reused at
    least twice) on the side stream: the same bytes as the CPU run."""
    from trpx_tpu_torch.runtime import StreamingEncoder

    fr = _frames(np.uint16, 5000, seed=31, F=23)
    files = {}
    for dev in ("cuda", "cpu"):
        p = tmp_path / f"{dev}.trpx"
        enc = StreamingEncoder(p, nvalues=5000, dtype=np.uint16, device=dev)
        for lo in range(0, 23, 5):
            enc.add_frames(fr[lo : lo + 5])
        enc.finalize(verify=True, index=True)
        files[dev] = p.read_bytes()
    assert files["cuda"] == files["cpu"]
    assert files["cuda"] == ncodec.encode(fr).to_bytes()


def test_stream_staging_reuse_under_load(cuda, tmp_path):
    """Each staging buffer is rewritten only after the copy that read it:
    six chunks with distinct contents, written while the card is busy."""
    from trpx_tpu_torch.runtime import StreamingEncoder

    rng = np.random.default_rng(32)
    fr = rng.poisson(3.0, (6 * 16, 512 * 512)).astype(np.uint16)
    for k in range(6):
        fr[k * 16 : (k + 1) * 16, :100] = 1000 * (k + 1)
    p = tmp_path / "s.trpx"
    enc = StreamingEncoder(p, nvalues=512 * 512, dtype=np.uint16)
    for k in range(6):
        enc.add_frames(fr[k * 16 : (k + 1) * 16])
    assert enc._staging[0].is_pinned() and enc._staging[1].is_pinned()
    enc.finalize(verify=True)
    assert p.read_bytes() == ncodec.encode(fr).to_bytes()


def test_iter_decode_on_card(cuda):
    from trpx_tpu_torch.runtime import iter_decode

    fr = _frames(np.uint16, 3000, seed=33, F=10)
    arch = ncodec.encode(fr)
    got = np.concatenate(list(iter_decode(arch, np.uint16, 4,
                                          device=cuda)))
    np.testing.assert_array_equal(got, fr)
    parts = []
    for out, nf in iter_decode(arch, np.uint16, 4, device=cuda,
                               fetch=False):
        assert out.is_cuda and out.shape == (nf, 3000)
        parts.append(out[:nf].cpu().numpy())
    np.testing.assert_array_equal(np.concatenate(parts), fr)


def test_iter_decode_failing_launch_raises(cuda, monkeypatch):
    """An undersized words tensor is refused, and the error leaves the
    generator: no fallback to the plain version or the host codec."""
    from trpx_tpu_torch.runtime import iter_decode, stream

    real = stream.decode_dispatch

    def undersized(spec, words, widths, device, **kw):
        return real(spec, words[:, :1].contiguous(), widths, device, **kw)

    monkeypatch.setattr(stream, "decode_dispatch", undersized)
    arch = ncodec.encode(_frames(np.uint16, 1000, seed=34, F=6))
    before = decode_batch.launches
    with pytest.raises(ValueError, match="words"):
        list(iter_decode(arch, np.uint16, 3, device=cuda))
    assert decode_batch.launches == before


def test_kernel_rejects_non_contiguous_input(cuda):
    spec = FrameSpec.for_dtype(100, np.uint16)
    x = torch.zeros((spec.n_padded, 2), dtype=torch.int16,
                    device=cuda).view(torch.uint16).T
    with pytest.raises(ValueError):
        encode_batch(spec, x)
