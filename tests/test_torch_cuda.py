"""PyTorch port on a CUDA card: each kernel against its plain version.

Every test here needs a card and skips without one. The module imports
nothing of JAX, so on a machine with a card and without JAX it runs
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact (lossless integer codec). Both pack kernels define
only the words of each frame's stream (``cuda_pack.defined_words``), so
their words are compared through ``stream_words``.
"""

import numpy as np
import pytest
import torch

from trpx_tpu_torch import compress, decompress
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
from trpx_tpu_torch.ops.coding import _pad_batch
from trpx_tpu_torch.ops.cuda_pack import (
    block_widths,
    pack_geometry,
    stream_words,
)
from trpx_tpu_torch.ops.cuda_unpack import unpack_geometry

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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
    x = torch.from_numpy(_pad_batch(fr, spec)).to(cuda)
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
