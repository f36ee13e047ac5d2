"""PyTorch port on a CUDA card: each kernel against its plain version.

Every test here needs a card and skips without one. The module imports
nothing of JAX, so on a machine with a card and without JAX it runs
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact (lossless integer codec). Both pack kernels define
only the words of each frame's stream (``cuda_pack.defined_words``), so
their words are compared through ``stream_words``.
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from trpx_tpu_torch import compress, decompress
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import (
    TILED_MAX_FRAMES,
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
    tiled_pack_geometry,
    tiled_unpack_geometry,
    walk_archive,
)
from trpx_tpu_torch.ops.cuda_pack import (
    block_widths,
    pack_geometry,
    stream_words,
)
from trpx_tpu_torch.ops.cuda_unpack import unpack_geometry
from trpx_tpu_torch.runtime import metrics

from _torch_helpers import pad_batch

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


def _same_pack(got, want):
    """Both packs agree on bits, widths and each frame's defined words."""
    (words, bits, maxw), (pw, pb, pm) = got, want
    assert torch.equal(bits, pb) and torch.equal(maxw, pm)
    assert torch.equal(stream_words(words, bits), pw)


@pytest.mark.parametrize("dtype,n", CASES)
def test_pack_kernel_matches_plain(cuda, dtype, n):
    fr = _frames(dtype, n, seed=n)
    spec = FrameSpec.for_dtype(n, dtype)
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    before = encode_batch.launches
    got = encode_batch(spec, x)
    assert encode_batch.launches == before + 1
    _same_pack(got, encode_batch_plain(spec, x))


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


def _one_pass_frames(dtype, n, kind, block=12):
    """Inputs of the one-pass kernels' hard cases: every value at the
    dtype's extreme (the widest stream a tile can hold; 33-bit fields for
    int32), all zero, and frames whose tile edges (of the wrapper's tile
    size) fall on a width change and on a repeated width."""
    info = np.iinfo(dtype)
    if kind == "max":
        return np.full((2, n), info.min if info.min < 0 else info.max, dtype)
    if kind == "zero":
        return np.zeros((2, n), dtype)
    fr = _frames(dtype, n, seed=n + len(kind), F=2)
    tb = pack_geometry(FrameSpec.for_dtype(n, dtype, block))[0]
    edge = tb * block
    if kind == "edge change":
        fr[0, :] = 3
        fr[0, edge : edge + block] = info.max   # new width at the edge
        fr[1, edge - block : edge] = 0          # width 0 just before it
    else:                                       # "edge repeat"
        fr[:] = 5                               # 1-bit headers everywhere
    return fr


ONE_PASS_CASES = [
    (dt, n, kind)
    for dt in (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32)
    for n, kind in ((1, "max"), (13, "zero"), (1001, "max"),
                    (40_000, "max"), (40_000, "zero"),
                    (40_000, "edge change"), (40_000, "edge repeat"))]


@pytest.mark.parametrize("dtype,n,kind", ONE_PASS_CASES)
def test_one_pass_kernels_match_plain(cuda, dtype, n, kind):
    """pack.cu and unpack.cu against their plain versions on the worst
    case, an all-zero frame, tiny and partial-block frames and tile
    edges."""
    fr = _one_pass_frames(dtype, n, kind)
    spec = FrameSpec.for_dtype(n, dtype)
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    want = encode_batch_plain(spec, x)
    _same_pack(encode_batch(spec, x), want)
    wd = block_widths(spec, x)[1].to(torch.uint8).contiguous()
    for odt in {decoded_dtype(spec), torch.int32}:
        got = decode_batch(spec, want[0], wd, odt)
        ref = decode_batch_plain(spec, want[0], wd, odt)
        if odt == torch.uint16:
            got, ref = got.view(torch.int16), ref.view(torch.int16)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("block", [3, 7, 64])
@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_one_pass_kernels_other_blocks(cuda, dtype, block):
    """The generic-block instances of both kernels (block 12 is a
    compile-time constant), across several tiles."""
    n = 3 * pack_geometry(FrameSpec.for_dtype(10**5, dtype, block))[0] \
        * block + 5
    fr = _frames(dtype, n, seed=block)
    spec = FrameSpec.for_dtype(n, dtype, block)
    assert unpack_geometry(spec)[0] >= 32
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    want = encode_batch_plain(spec, x)
    _same_pack(encode_batch(spec, x), want)
    wd = block_widths(spec, x)[1].to(torch.uint8).contiguous()
    got = decode_batch(spec, want[0], wd, decoded_dtype(spec))
    np.testing.assert_array_equal(got.cpu().numpy().astype(dtype), fr)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_wide_blocks_on_card(cuda, dtype):
    """Blocks of 1,024 32-bit values, too large for a tile of the one-pass
    pack: the tiled pack, and the one-pass unpack at its smallest tiles
    (the generic-block instance) and the tiled unpack, against their plain
    versions across several tiles, worst-case fields included."""
    block = 1024
    spec0 = FrameSpec.for_dtype(10**6, dtype, block)
    # every encode of them takes the tiled pack; the one-pass unpack can
    # tile them (batches of TILED_MAX_FRAMES frames take it)
    assert spec0.tiled_pack(TILED_MAX_FRAMES)
    assert not spec0.tiled(TILED_MAX_FRAMES)
    n = 3 * unpack_geometry(spec0)[0] * block + 5
    fr = _frames(dtype, n, seed=7)
    info = np.iinfo(dtype)
    fr[1, block * 40 : block * 41] = info.min if info.min < 0 else info.max
    spec = FrameSpec.for_dtype(n, dtype, block)
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    got = encode_batch_tiled_plain(spec, x)
    _same_pack(encode_batch_tiled(spec, x), got)
    wd = block_widths(spec, x)[1].to(torch.uint8).contiguous()
    for odt in {decoded_dtype(spec), torch.int32}:
        want = decode_batch_plain(spec, got[0], wd, odt)
        assert torch.equal(decode_batch(spec, got[0], wd, odt), want)
        assert torch.equal(decode_batch_tiled(spec, got[0], wd, odt), want)
    np.testing.assert_array_equal(
        decode_batch(spec, got[0], wd, decoded_dtype(spec)).cpu().numpy()
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


# 64-block tiles, and the default geometry (None)
@pytest.mark.parametrize("tile_blocks", [64, None])
@pytest.mark.parametrize("dtype,n", TILED_CASES)
def test_tiled_pack_kernel_matches_plain(cuda, dtype, n, tile_blocks):
    fr = _tiled_frames(dtype, n, seed=n)
    spec = FrameSpec.for_dtype(n, dtype)
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    before = encode_batch_tiled.launches
    got = encode_batch_tiled(spec, x, tile_blocks)
    assert encode_batch_tiled.launches == before + 1
    _same_pack(got, encode_batch_tiled_plain(spec, x, tile_blocks))
    _same_pack(got, encode_batch_plain(spec, x))


@pytest.mark.parametrize("tile_blocks", [64, None])
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


def _both_tiled_kernels(spec, fr, cuda):
    """Both tiled kernels at their default geometry against their plain
    versions (and the untiled plain pack) on frames `fr`, and the decode
    against the frames."""
    x = torch.from_numpy(pad_batch(fr, spec)).to(cuda)
    want = encode_batch_tiled_plain(spec, x)
    _same_pack(encode_batch_tiled(spec, x), want)
    _same_pack(encode_batch_tiled(spec, x), encode_batch_plain(spec, x))
    wd = block_widths(spec, x)[1].to(torch.uint8).contiguous()
    for odt in {decoded_dtype(spec), torch.int32}:
        got = decode_batch_tiled(spec, want[0], wd, odt)
        ref = decode_batch_tiled_plain(spec, want[0], wd, odt)
        if odt == torch.uint16:
            got, ref = got.view(torch.int16), ref.view(torch.int16)
        assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        decode_batch_tiled(spec, want[0], wd, decoded_dtype(spec)).cpu()
        .numpy().astype(fr.dtype), fr)


@pytest.mark.parametrize("dtype,block", [(np.uint8, 9000), (np.int16, 4097),
                                         (np.uint32, 5000),
                                         (np.int32, 12345)])
def test_tiled_kernels_block_larger_than_a_tile(cuda, dtype, block):
    """Blocks larger than the tiles' value budget: one-block tiles, packed
    and unpacked in chunks; a partial last block, a zero block (no
    fields), and the widest field at a chunk's edge."""
    n = 3 * block + 17
    spec = FrameSpec.for_dtype(n, dtype, block)
    assert tiled_pack_geometry(spec)[0] == 1
    assert tiled_unpack_geometry(spec)[0] == 1
    fr = _frames(dtype, n, seed=block)
    info = np.iinfo(dtype)
    fr[1, block : 2 * block] = 0
    fr[2, 4096] = info.min if info.min < 0 else info.max
    fr[2, block + 4095] = info.min if info.min < 0 else info.max
    _both_tiled_kernels(spec, fr, cuda)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_tiled_kernels_tiles_of_few_bits(cuda, dtype):
    """Tiles of fewer than 32 bits (a few all-zero blocks of 1,024 values,
    1-4 header bits each), so many tiles share a word, beside tiles of
    data."""
    block = 1024
    n = 200 * block + 100
    spec = FrameSpec.for_dtype(n, dtype, block)
    fr = np.zeros((3, n), dtype)
    fr[0, 5 * block + 3] = 7
    fr[1, -1] = np.iinfo(dtype).max
    fr[2, 17 * block : 18 * block] = 1
    fr[2, 100 * block :] = _frames(dtype, n - 100 * block, seed=5, F=1)[0]
    _both_tiled_kernels(spec, fr, cuda)


def test_big_frame_path_round_trip(cuda):
    """Two 2048x2048 u32 frames, fewer than TILED_PACK_MAX_FRAMES frames of
    TILED_MIN_BLOCKS blocks or more and fewer than TILED_MAX_FRAMES, take
    the tiled pack and the tiled unpack."""
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
    assert after[2] > counts[2] and after[3] > counts[3]
    assert (after[0], after[1]) == (counts[0], counts[1])


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
    assert all(enc._staging._buf[k].is_pinned() for k in (0, 1))
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


def test_two_process_encode_shards_on_card(cuda, tmp_path):
    """Two gloo ranks on the one card encode their shards
    (``ShardedCodec.encode_shards``) into one shared file
    (``write_shard_file``): the native codec's bytes, through the pack
    kernel."""
    from test_torch_multiprocess import last_json, launch, shard_frames

    out = tmp_path / "multi.trpx"
    runs = launch("shard", out, device="cuda")
    for rc, o, e in runs:
        assert rc == 0, f"worker failed:\n{o}\n{e}"
        assert last_json(o)["launches"]["pack"] >= 1
    assert out.read_bytes() == ncodec.encode(shard_frames()).to_bytes()


def test_cli_default_device_on_card(cuda, tmp_path):
    """The CLI's default device is the card: encode through the pack
    kernel to the native codec's bytes, decode through the unpack back to
    the TIFF's pixels."""
    from trpx_tpu_torch.cli.main import main
    from trpx_tpu_torch.io import read_tiff, write_tiff

    fr = _frames(np.uint16, 64 * 64, 5, F=6).reshape(6, 64, 64)
    src = tmp_path / "m.tif"
    write_tiff(fr, src)
    encode_batch.launches = decode_batch_tiled.launches = 0
    assert main(["encode", str(src)]) == 0
    assert (tmp_path / "m.trpx").read_bytes() == ncodec.encode(
        fr.reshape(6, -1), dimensions=(64, 64)).to_bytes()
    assert encode_batch.launches >= 1
    assert main(["decode", str(tmp_path / "m.trpx"), "--out-dir",
                 str(tmp_path / "o")]) == 0
    np.testing.assert_array_equal(read_tiff(tmp_path / "o" / "m.tif")
                                  .as_array(), fr)
    assert decode_batch_tiled.launches >= 1


def _launches():
    return {"pack": encode_batch.launches,
            "pack_tiled": encode_batch_tiled.launches,
            "unpack": decode_batch.launches,
            "unpack_tiled": decode_batch_tiled.launches}


def _zero_launches():
    encode_batch.launches = encode_batch_tiled.launches = 0
    decode_batch.launches = decode_batch_tiled.launches = 0


def test_bench_on_card(cuda):
    """The bench's guards pass on the card (archives equal the native
    codec's bytes, decodes return the frames) and its batches take their
    routes: 16 x 512x512 u16 the one-pass pack and the tiled unpack, 2 x
    2048x2048 u32 both tiled kernels."""
    from trpx_tpu_torch import bench

    _zero_launches()
    r = bench.bench_512(16, 1, cuda, n2=2)
    assert (r["pack"], r["unpack"]) == ("encode_batch", "decode_batch_tiled")
    rb = bench.bench_big(1, 2048, 2, cuda, n2=2)
    assert (rb["pack"], rb["unpack"]) == ("encode_batch_tiled",
                                          "decode_batch_tiled")
    got = _launches()
    assert got["pack"] >= 1 and got["pack_tiled"] >= 1 \
        and got["unpack_tiled"] >= 1 and got["unpack"] == 0
    for res in (r, rb):
        assert all(res[k] > 0 for k in ("enc_fps", "dec_fps", "walk_fps",
                                        "foreign_fps", "pipelined_fps"))


@pytest.mark.parametrize("row", range(6))
def test_campaign_route_rows_on_card(cuda, row):
    """The campaign's route rows on the card: byte for byte, lossless, and
    each on the route ``FrameSpec`` gives it."""
    from trpx_tpu_torch.tools import differential_campaign as camp

    vals, block = camp.smoke_values(camp.ROUTE_TRIALS[row])
    spec = FrameSpec.for_dtype(vals.shape[1], vals.dtype, block)
    F = vals.shape[0]
    want = {"pack_tiled" if spec.tiled_pack(F) else "pack",
            "unpack_tiled" if spec.tiled(F) else "unpack"}
    _zero_launches()
    camp.run_trial(vals, block, cuda)
    got = _launches()
    assert {k for k, v in got.items() if v} == want


def test_entry_on_card(cuda):
    """``entry()`` runs the pack kernel on the card, equal to its plain
    version on the words each frame defines."""
    from trpx_tpu_torch.graft_entry import entry

    fn, (frames,) = entry()
    assert frames.is_cuda
    before = encode_batch.launches
    got = fn(frames)
    assert encode_batch.launches == before + 1
    _same_pack(got, encode_batch_plain(FrameSpec.for_dtype(512 * 512,
                                                           np.uint16),
                                       frames))


def test_dryrun_multichip_on_card(cuda):
    """Two ranks share the card; each runs the pack, the tiled pack and
    the tiled unpack."""
    from trpx_tpu_torch.graft_entry import dryrun_multichip

    ranks = dryrun_multichip(2)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        got = r["launches"]
        assert got["pack"] and got["pack_tiled"] and got["unpack_tiled"]


def test_scaling_on_card(cuda):
    """The scaling tool on the card(s): a positive one-card rate; with one
    card, a null efficiency."""
    from trpx_tpu_torch.parallel import default_devices
    from trpx_tpu_torch.tools import scaling

    devices = default_devices()
    res = scaling.run(devices, frames_per_dev=8, reps=2)
    assert res["frames_per_s"]["1"] > 0
    if len(devices) == 1:
        assert res["scaling_efficiency"] is None
        assert res["reason"] == "one card"


# ------------------------------------------------------ hostile tables ---

#: mutations of a batch's tables: those of the JAX tiled-route test
#: (tests/test_fuzz_decode.py:test_tiled_route_hostile_tables), widths of
#: 33-255 (past an i32 target's fields), and a run of 255-bit blocks longer
#: than any tile, whose CTAs' staged words cannot hold it
HOSTILE_KINDS = ("over-claim", "negative", "zero tail", "word flips",
                 "over 33", "dense")


def hostile_tables(widths: np.ndarray, words: np.ndarray, kind: str, rng):
    """A mutated copy of a batch's (F, nb) uint8 ``widths`` and (F, W)
    uint32 ``words``: ``kind`` of :data:`HOSTILE_KINDS`, drawn from
    ``rng``. Negative widths wrap into uint8 (156-255)."""
    wd, wo = widths.copy(), words.copy()
    F, nb = wd.shape
    if kind == "over-claim":
        wd[rng.integers(0, F), rng.integers(0, nb, 5)] = rng.integers(17, 256,
                                                                      5)
    elif kind == "negative":
        wd[rng.integers(0, F), rng.integers(0, nb, 3)] = \
            -int(rng.integers(1, 100)) % 256
    elif kind == "zero tail":
        wd[:, int(rng.integers(0, nb)):] = 0
    elif kind == "word flips":
        v = wo.view(np.uint8)
        for _ in range(8):
            v[rng.integers(0, v.shape[0]), rng.integers(0, v.shape[1])] ^= \
                int(rng.integers(1, 256))
    elif kind == "over 33":
        wd[rng.integers(0, F), rng.integers(0, nb, 5)] = rng.integers(33, 256,
                                                                      5)
    else:
        b = int(rng.integers(0, max(1, nb - 2048)))
        wd[rng.integers(0, F), b : b + 2048] = 255
    return wd, wo


def _outcome(fn):
    """("ok", output) of a call, or ("error", the exception's class)."""
    try:
        return "ok", fn()
    except (ValueError, TypeError, OverflowError, KeyError,
            IndexError) as e:
        return "error", type(e)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.int32])
def test_unpack_kernels_on_hostile_tables(cuda, dtype):
    """Hostile tables fed straight to both unpack kernels (the one-pass
    and the tiled at their default tiles, the tiled also at 64-block
    tiles), widths up to 255 where the target's fields hold at most 8, 16
    or 33 bits: each output equals its plain version on the card exactly
    (the plain versions clamp word reads as the kernels do), or both
    raise the same clean error. Then an untouched batch decodes exactly,
    so no fault poisoned the context. Frames of 40,000 values keep every
    bit offset of 255-bit fields under 2**31."""
    n = 40_000
    fr = _frames(dtype, n, seed=23)
    spec = FrameSpec.for_dtype(n, dtype)
    widths, words = walk_archive(ncodec.encode(fr), spec)
    widths = widths.astype(np.uint8)
    calls = [(decode_batch, decode_batch_plain, ()),
             (decode_batch_tiled, decode_batch_tiled_plain, ()),
             (decode_batch_tiled, decode_batch_tiled_plain, (64,))]
    rng = np.random.default_rng(5)
    for trial in range(4 * len(HOSTILE_KINDS)):
        kind = HOSTILE_KINDS[trial % len(HOSTILE_KINDS)]
        wd, wo = hostile_tables(widths, words, kind, rng)
        wd = torch.from_numpy(wd).to(cuda)
        wo = torch.from_numpy(wo.view(np.int32)).to(cuda)
        for odt in {decoded_dtype(spec), torch.int32}:
            for fn, plain, tile in calls:
                got = _outcome(lambda: fn(spec, wo, wd, odt, *tile))
                want = _outcome(lambda: plain(spec, wo, wd, odt, *tile))
                assert got[0] == want[0], (kind, fn.__name__, got, want)
                if got[0] == "error":
                    assert got[1] is want[1], (kind, fn.__name__)
                    continue
                g, w = got[1], want[1]
                if odt == torch.uint16:
                    g, w = g.view(torch.int16), w.view(torch.int16)
                assert torch.equal(g, w), (kind, fn.__name__, tile, odt)
    torch.cuda.synchronize()
    wd = torch.from_numpy(widths).to(cuda)
    wo = torch.from_numpy(words.view(np.int32)).to(cuda)
    for fn in (decode_batch, decode_batch_tiled):
        np.testing.assert_array_equal(
            fn(spec, wo, wd, decoded_dtype(spec)).cpu().numpy().astype(dtype),
            fr)


# ------------------------------------------- launches from many threads ---


def _smoke():
    """``chip_smoke.py``, whose phases 11(a) and 11(b) these tests run."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_launchers_from_many_threads(cuda):
    """``chip_smoke.py`` phase 11(b) at 200 calls a thread: four host
    threads launch at once (the ctypes launchers release the GIL), each
    taking in turn both unpacks of u8, u16, i16 and i32 batches (kernel
    instances shared by several targets at different shared-memory
    sizes) and both packs of u8 and u16 frames; every result exact, every
    call made."""
    _smoke().race_drill(cuda, torch.cuda.get_device_name(cuda), calls=200)


def test_hostile_corpus_on_card(cuda, tmp_path):
    """``chip_smoke.py`` phase 11(a): the fuzz suite's mutations of a
    3 x 1,000 u16 archive (the tiled unpack) and of a 256 x 4,096 one (the
    one-pass unpack), and those past the first chunk of a 520 x 1,024 one
    (the pipelined decode: chunks of 256, 256 and 8 frames) with its
    crafted sidecars, ``fetch=False`` through a stream that ends early and
    abandoned pipelines, through the public decode on the card, each
    outcome that of the plain versions, then a clean round trip."""
    _smoke().hostile_phase(torch.cuda.get_device_name(cuda), tmp_path)


# ------------------------------------------- the caller's current device ---


def _driver_device() -> int:
    """The device of the calling thread's current CUDA driver context: the
    state that the kernel library's own (static) CUDA runtime sets, and
    that code on the driver API or on another runtime picks up."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ctx, dev = ctypes.c_void_p(), ctypes.c_int()
    assert cu.cuCtxGetCurrent(ctypes.byref(ctx)) == 0 and ctx.value
    assert cu.cuCtxGetDevice(ctypes.byref(dev)) == 0
    return dev.value


def test_launchers_leave_the_current_device(cuda, tmp_path):
    """Each kernel launched on a card that is not the thread's current
    one leaves the current device as it was (``csrc/common.cuh``
    ``DeviceGuard``): torch's and the driver's current device, so a later
    ``StreamingEncoder(device=None)`` and ``torch.empty(1,
    device="cuda")`` land on the original card. Needs two cards: on one,
    every launch is on the current card and the fault cannot show."""
    from trpx_tpu_torch.runtime import StreamingEncoder

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cur = torch.cuda.current_device()
    other = torch.device("cuda", (cur + 1) % torch.cuda.device_count())
    n = 5000
    fr = _frames(np.uint16, n, seed=41)
    spec = FrameSpec.for_dtype(n, np.uint16)
    x = torch.from_numpy(pad_batch(fr, spec)).to(other)
    widths, words = walk_archive(ncodec.encode(fr), spec)
    wd = torch.from_numpy(widths.astype(np.uint8)).to(other)
    wo = torch.from_numpy(words.view(np.int32)).to(other)
    odt = decoded_dtype(spec)
    torch.empty(1, device="cuda")
    assert _driver_device() == cur
    for name, fn in (("pack", lambda: encode_batch(spec, x)),
                     ("pack_tiled", lambda: encode_batch_tiled(spec, x)),
                     ("unpack", lambda: decode_batch(spec, wo, wd, odt)),
                     ("unpack_tiled",
                      lambda: decode_batch_tiled(spec, wo, wd, odt))):
        fn()
        assert _driver_device() == cur, name
        assert torch.cuda.current_device() == cur, name
    torch.cuda.synchronize(other)
    enc = StreamingEncoder(tmp_path / "s.trpx", nvalues=n, dtype=np.uint16)
    assert enc._stream.device == torch.device("cuda", cur)
    assert torch.empty(1, device="cuda").device == torch.device("cuda", cur)


# ------------------------------------------------------ the sharded path ---


def _big_u32(F, seed):
    """F 2048x2048 u32 frames, Poisson(3) with 200 hot pixels a frame."""
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, (F, 2048 * 2048)).astype(np.uint32)
    fr[np.repeat(np.arange(F), 200), rng.integers(0, fr.shape[1], F * 200)] = \
        2_000_000_000
    return fr


def test_sharded_dispatch_leaves_work_queued(cuda):
    """``ShardedCodec._dispatch_local`` of 32 x 2048x2048 u32 over two
    shards of ``cuda:0`` returns while the card still works: the uploads
    run on a side stream and the tables come back into pinned memory, so
    no warm dispatch waits for its kernel. Its staging is pinned, and
    the collected archive is the native codec's bytes, from a cold codec
    and from a warm one."""
    from trpx_tpu_torch.ops import coding
    from trpx_tpu_torch.parallel import ShardedCodec

    dev = torch.device("cuda", 0)
    fr = _big_u32(32, 12)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    codec = ShardedCodec(spec, [dev, dev])
    want = ncodec.encode(fr, dimensions=(2048, 2048)).to_bytes()
    for warm in (False, True):
        torch.cuda.synchronize(dev)
        if warm:
            # the kernels queue behind ~0.5 s of spin: a dispatch that
            # waited for its kernel would return with the stream idle (a
            # cold one may: allocating device or pinned memory can
            # synchronize the card)
            torch.cuda._sleep(1 << 30)
        flights = codec._dispatch_local(fr)
        if warm:
            assert not torch.cuda.current_stream(dev).query()
        assert [p.pin for _, _, p in flights] == [True, True]
        words, bits, maxw = codec._collect_local(flights)
        arch = coding.assemble_archive(spec, words, bits, maxw, (2048, 2048))
        assert arch.to_bytes() == want
    assert all(t.is_pinned() for t in codec._staging._buf.values())


def test_sharded_staging_is_bounded_on_card(cuda, monkeypatch):
    """With bounce buffers of a few frames, a reused two-shard codec of
    ``cuda:0`` encodes 13 x 512x512 u16 to the native codec's bytes and
    decodes them exactly into pageable memory, twice with other data;
    every bounce buffer is pinned and within ``BOUNCE_BYTES``."""
    from trpx_tpu_torch.ops import staging
    from trpx_tpu_torch.parallel import ShardedCodec

    monkeypatch.setattr(staging, "BOUNCE_BYTES", 3 * 512 * 512 * 2)
    dev = torch.device("cuda", 0)
    codec = ShardedCodec(FrameSpec.for_dtype(512 * 512, np.uint16),
                         [dev, dev])
    for seed, F in ((15, 13), (16, 9)):
        fr = _frames(np.uint16, 512 * 512, seed, F=F)
        arch = codec.encode(fr, (512, 512))
        assert arch.to_bytes() == ncodec.encode(
            fr, dimensions=(512, 512)).to_bytes()
        back = codec.decode(arch, np.uint16)
        np.testing.assert_array_equal(back, fr)
        assert not torch.from_numpy(back).is_pinned()
    for t in codec._staging._buf.values():
        assert t.is_pinned()
        assert t.numel() * t.element_size() <= staging.BOUNCE_BYTES


def test_sharded_codec_on_every_card(cuda):
    """``ShardedCodec`` over every card: bytes equal the native codec's,
    pixels exact, and the calling thread stays on its current device.
    Needs two cards."""
    from trpx_tpu_torch.parallel import ShardedCodec, default_devices

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    devices = default_devices()
    cur = torch.cuda.current_device()
    for fr, side in ((_frames(np.uint16, 512 * 512, 13, F=64), 512),
                     (_big_u32(4 * len(devices), 14), 2048)):
        spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype)
        codec = ShardedCodec(spec, devices)
        arch = codec.encode(fr, (side, side))
        assert arch.to_bytes() == ncodec.encode(
            fr, dimensions=(side, side)).to_bytes()
        np.testing.assert_array_equal(codec.decode(arch, fr.dtype), fr)
        assert torch.cuda.current_device() == cur


# ------------------------------------------ the encode's kept staging ---

def _quad512(seed):
    """256 x 512x512 u16 frames, Poisson(3) with 200 hot pixels a frame
    at 60,000."""
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, (256, 512, 512)).astype(np.uint16)
    hot = 256 * 200
    fr[np.repeat(np.arange(256), 200), rng.integers(0, 512, hot),
       rng.integers(0, 512, hot)] = 60_000
    return fr


def _native_stack(fr):
    return ncodec.encode(fr.reshape(len(fr), -1),
                         dimensions=(fr.shape[2], fr.shape[1])).to_bytes()


def _pinned(call, names=("pinned_bytes.",)):
    """(call(), its change of the counters whose names start with one of
    `names`: by default the ``pinned_bytes.*`` counters)."""
    before = metrics.counters()
    out = call()
    after = metrics.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith(names) and v != before.get(k, 0)}


def _in_new_thread(fn):
    """fn() in a thread of its own, whose encode staging starts empty."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # raised below, in the caller
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["out"]


@pytest.mark.parametrize("before", [None, "4 x 2048x2048 u32"])
def test_compress_through_kept_pinned_buffers(cuda, before):
    """``compress`` of 256 x 512x512 u16 on the card, twice in a new
    thread, after nothing or a 4-frame 2048x2048 u32 call (the tiled
    pack's route, whose values then fill the bounce buffers): the native
    codec's bytes every time. The thread pins its two bounce buffers in
    the first call of a dtype and shape, and a second call pins nothing."""
    from trpx_tpu_torch.ops import staging

    fr = _quad512(41)
    want = _native_stack(fr)
    big = _big_u32(4, 42).reshape(4, 2048, 2048) if before else None

    def run():
        if before:
            arch, _ = _pinned(lambda: compress(big, device=cuda))
            assert arch.to_bytes() == _native_stack(big)
        pins = []
        for _ in range(2):
            arch, got = _pinned(lambda: compress(fr, device=cuda))
            assert arch.to_bytes() == want
            pins.append(got)
        return pins

    first, second = _in_new_thread(run)
    cols = FrameSpec.for_dtype(512 * 512, np.uint16).n_padded
    rows = staging._chunk_rows(cols, torch.uint16)
    assert first == {"pinned_bytes.trpx.encode.h2d": 2 * rows * cols * 2}
    assert second == {}


def test_staging_pins_a_buffer_made_pageable(cuda):
    """A thread's staging serves CPU and card encodes alike: a buffer
    first made pageable (a CPU device's request) is pinned anew for the
    first CUDA copy that asks for it, and counted then."""
    from trpx_tpu_torch.ops import staging

    stage = staging.Staging()
    src = np.arange(12, dtype=np.uint16).reshape(3, 4) + 1
    assert not stage.rows("x", src, 6, torch.uint16, False).is_pinned()
    with metrics.span("trpx.test.pin") as s:
        view, got = _pinned(
            lambda: stage.rows("x", src, 6, torch.uint16, True, s))
    assert view.is_pinned()
    assert got == {"pinned_bytes.trpx.test.pin": 3 * 6 * 2}
    np.testing.assert_array_equal(view.numpy(),
                                  np.pad(src, ((0, 0), (0, 2))))


def test_compress_from_two_threads_on_card(cuda):
    """Two threads compress 256 x 512x512 u16 stacks on the card at once,
    twice each, the other thread's stack second: each thread stages
    through its own pinned buffers and side stream, and every archive is
    the native codec's bytes."""
    stacks = [_quad512(43), _quad512(44)]
    wants = [_native_stack(fr) for fr in stacks]
    start = threading.Barrier(2)
    got, errors = {}, []

    def run(t):
        try:
            start.wait()
            for k in range(2):
                got[t, k] = compress(stacks[(t + k) % 2],
                                     device=cuda).to_bytes()
        except Exception as e:   # reported below with the thread
            errors.append((t, e))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert got == {(t, k): wants[(t + k) % 2]
                   for t in range(2) for k in range(2)}


# ------------------------------ the synchronous decode's lent results ---

def _gapped_u32(seed, h=1024, w=2048):
    """An (h, w) u32 image of 8 MiB: Poisson(0.5) under rows and columns
    of masked pixels at 2^32-1, as a detector's module gaps."""
    rng = np.random.default_rng(seed)
    img = rng.poisson(0.5, (h, w)).astype(np.uint32)
    img[500:538] = img[:, 1030:1042] = np.iinfo(np.uint32).max
    return img


def _image_blob(img):
    return ncodec.encode(img.reshape(1, -1),
                         dimensions=(img.shape[1], img.shape[0])).to_bytes()


def _native(blob, dtype):
    return ncodec.decode(TrpxArchive.from_bytes(blob), dtype)


def _pageable(blob, dtype=None):
    """``blob`` decoded on the card with no room for a lent result."""
    from trpx_tpu_torch.ops import staging

    with pytest.MonkeyPatch.context() as m:
        m.setattr(staging, "PINNED_RESULT_BYTES", 0)
        out = decompress(blob, dtype, device="cuda")
    assert not torch.from_numpy(out).is_pinned()
    return out


def _result_counts(call):
    """(call(), its change of the counters of the decode's copy back)."""
    return _pinned(call, ("results.", "pinned_bytes.trpx.decode.d2h",
                          "fresh_bytes.trpx.decode.d2h"))


def _same_pixels(got, img, blob):
    """``got`` equals the image, the native codec's decode and the
    pageable path's."""
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(
        got.reshape(-1), _native(blob, img.dtype).reshape(-1))
    np.testing.assert_array_equal(got, _pageable(blob, img.dtype))


def test_decode_results_stay_separate(cuda):
    """An image's result, kept while another image decodes, keeps its
    pixels: each lent result has its own pinned block. Once the first is
    dropped, its block serves the next decode, which is right too."""
    imgs = [_gapped_u32(61), _gapped_u32(62)]
    blobs = [_image_blob(i) for i in imgs]
    a = decompress(blobs[0], device=cuda)
    b = decompress(blobs[1], device=cuda)
    assert torch.from_numpy(a).is_pinned()
    assert torch.from_numpy(b).is_pinned()
    assert a.ctypes.data != b.ctypes.data
    _same_pixels(a, imgs[0], blobs[0])
    _same_pixels(b, imgs[1], blobs[1])
    del a
    c = decompress(blobs[0], device=cuda)
    _same_pixels(c, imgs[0], blobs[0])
    _same_pixels(b, imgs[1], blobs[1])


def test_warm_decodes_pin_nothing(cuda):
    """Decodes whose results are dropped before the next call find their
    block in torch's cache: each counts ``results.pinned`` and pins no
    byte anew, allocates no fresh pageable bytes, and hands its loan
    back when its result dies."""
    from trpx_tpu_torch.ops import staging

    img = _gapped_u32(63)
    blob = _image_blob(img)
    lent = staging.RESULTS.lent
    decompress(blob, device=cuda)
    for _ in range(3):
        out, got = _result_counts(lambda: decompress(blob, device=cuda))
        assert got == {"results.pinned": 1}
        assert staging.RESULTS.lent == lent + img.nbytes
        _same_pixels(out, img, blob)
        del out
        assert staging.RESULTS.lent == lent


def test_decode_over_the_budget_is_pageable(cuda, monkeypatch):
    """With room for two lent results, a third decode while both are held
    returns pageable memory (``results.pageable``, its bytes fresh), with
    the right pixels; once they are dropped, decodes are lent again."""
    from trpx_tpu_torch.ops import staging

    img = _gapped_u32(64)
    blob = _image_blob(img)
    monkeypatch.setattr(staging, "PINNED_RESULT_BYTES",
                        staging.RESULTS.lent + 2 * img.nbytes)
    held = [decompress(blob, device=cuda) for _ in range(2)]
    assert all(torch.from_numpy(h).is_pinned() for h in held)
    out, got = _result_counts(lambda: decompress(blob, device=cuda))
    assert got == {"results.pageable": 1,
                   "fresh_bytes.trpx.decode.d2h": img.nbytes}
    assert not torch.from_numpy(out).is_pinned()
    _same_pixels(out, img, blob)
    held.clear()
    out, got = _result_counts(lambda: decompress(blob, device=cuda))
    assert got == {"results.pinned": 1}
    assert torch.from_numpy(out).is_pinned()
    _same_pixels(out, img, blob)


@pytest.mark.parametrize("dtype,pinned", [
    (np.uint32, True), (np.int32, True), (np.uint16, True),
    (np.uint8, False), (np.int16, False), (np.int8, False)])
def test_decode_result_memory_by_dtype(cuda, dtype, pinned):
    """Results in the unpack's own lanes (u16; i32, and i32 lanes read as
    u32) are views of the lent pinned block; a narrowing into a smaller
    type copies into pageable memory, and the block's loan ends with the
    call. Pixels equal the frames, the native codec's and the pageable
    path's either way."""
    from trpx_tpu_torch.ops import staging

    fr = _frames(dtype, 512 * 512, 71)
    blob = ncodec.encode(fr).to_bytes()
    lent = staging.RESULTS.lent
    out, got = _result_counts(lambda: decompress(blob, dtype, device=cuda))
    assert got["results.pinned"] == 1
    assert out.dtype == dtype
    assert torch.from_numpy(out).is_pinned() == pinned
    assert (staging.RESULTS.lent > lent) == pinned
    _same_pixels(out, fr, blob)
    del out
    assert staging.RESULTS.lent == lent


# ------------------------------------------------- the header walk ---


def _walk_frame_of(shape: str):
    """One frame of the card walk's checks: a 4362x4148 u32 image on the
    EIGER2 X 16M's module grid, or a 2048x2048 u32 frame, Poisson(3) with
    hot pixels at 2,000,000,000."""
    from trpx_tpu_torch.tools import walk_bench

    if shape == "eiger":
        return walk_bench.gapped_image(seed=1)
    return walk_bench.synth(1, 2048 * 2048, np.uint32, 2_000_000_000, seed=3)


def _same_walks(got, want):
    assert (got.rounds, got.headers, got.wmax, got.end_bit) == (
        want.rounds, want.headers, want.wmax, want.end_bit)
    if got.rounds is not None:
        k = min(got.headers, got.widths.shape[1])
        assert torch.equal(got.widths[:, :k], want.widths[:, :k])


@pytest.mark.parametrize("shape", ["eiger", "2048_u32"])
def test_walk_kernel_matches_plain_and_host(cuda, shape):
    """``csrc/walk.cu`` against its plain version on the card (rounds,
    counts, widths, end, widest block) at two part sizes, and against the
    host walk; then ``decompress`` of the frame takes the card walk and
    the tiled unpack and returns the frame."""
    from test_torch_walk import _walk_parts
    from trpx_tpu_torch import native
    from trpx_tpu_torch.ops import cuda_walk
    from trpx_tpu_torch.ops.cuda_walk import (
        upload_stream,
        walk_frame,
        walk_frame_plain,
    )

    fr = _walk_frame_of(shape)
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    P = arch.meta.memory_size
    words = upload_stream(arch.payload, cuda)
    assert torch.equal(words.cpu(), upload_stream(arch.payload, "cpu"))
    rows, _, fst = native.walk_chunk(native.padded_buffer(arch.payload), 0,
                                     1, spec.n, spec.block, max_width=32)
    for L in (2048, cuda_walk.WALK_BITS):
        before = walk_frame.launches
        with _walk_parts(L):
            got = walk_frame(spec, words, P)
            assert walk_frame.launches > before
            _same_walks(got, walk_frame_plain(spec, words, P))
        assert got.rounds is not None
        np.testing.assert_array_equal(got.widths.cpu().numpy(),
                                      rows.astype(np.uint8))
        assert got.wmax == rows.max() and 1 + got.end_bit // 8 == fst[1]
    metrics.reset_counters()
    out = decompress(arch.to_bytes(), device=cuda)
    np.testing.assert_array_equal(out.reshape(-1), fr[0])
    c = metrics.counters()
    assert c["walks.card"] == 1 and c["frames.decode_batch_tiled"] == 1
    assert "walks.unsynced" not in c


def test_walk_kernel_on_hostile_payloads(cuda):
    """The one-frame hostile payloads of ``test_torch_walk.py`` (flips,
    truncations, bursts): the kernel's walk is its plain version's, and
    the host walk's outcome; at a round cap of 2 and 128-bit parts neither
    converges."""
    from test_torch_walk import _host, _hostile_payloads, _walk_parts
    from trpx_tpu_torch.ops.cuda_walk import (
        check_walk,
        upload_stream,
        walk_frame,
        walk_frame_plain,
    )

    spec = FrameSpec.for_dtype(3000, np.uint16)
    for payload in _hostile_payloads():
        words = upload_stream(payload, cuda)
        with _walk_parts(2048):
            got = walk_frame(spec, words, len(payload))
            _same_walks(got, walk_frame_plain(spec, words, len(payload)))
        want = _host(payload, spec, 16)
        try:
            check_walk(got, spec.nb, len(payload), 16)
            assert want[0] == "ok"
            np.testing.assert_array_equal(got.widths[0].cpu().numpy(),
                                          want[1])
        except ValueError as e:
            assert want == ("raise", str(e))
    fr = _walk_frame_of("2048_u32")
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    words = upload_stream(arch.payload, cuda)
    with _walk_parts(128, 2):
        got = walk_frame(spec, words, len(arch.payload))
        assert got.rounds is None and got.widths is None
        _same_walks(got, walk_frame_plain(spec, words, len(arch.payload)))


def test_decode_walked_on_card_leaves_the_host_walks_tables(cuda):
    """``ops.decode`` on the card walk leaves the archive's width table
    (uint8, from pinned memory) and frame index equal to the host walk's,
    and a second decode of that archive proves them and walks nothing."""
    from trpx_tpu_torch.ops import coding

    img = _gapped_u32(65)
    blob = _image_blob(img)
    a = TrpxArchive.from_bytes(blob)
    assert coding.walks_on_card(a, FrameSpec.for_dtype(img.size, np.uint32))
    out = coding.decode(a, np.uint32, device=cuda)
    np.testing.assert_array_equal(out.reshape(img.shape), img)
    b = TrpxArchive.from_bytes(blob)
    coding.walk_archive(b, FrameSpec.for_dtype(img.size, np.uint32))
    assert a.width_table.dtype == np.uint8
    np.testing.assert_array_equal(a.width_table, b.width_table)
    np.testing.assert_array_equal(a.frame_index, b.frame_index)
    metrics.reset_counters()
    np.testing.assert_array_equal(
        coding.decode(a, np.uint32, device=cuda).reshape(img.shape), img)
    assert "walks.card" not in metrics.counters()
