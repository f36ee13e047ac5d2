"""PyTorch port, ``parallel/``: ``ShardedCodec`` over lists of CPU devices
(the kernels' plain versions), shard files, run manifests, shard recovery
and the chunked ``StreamingShardEncoder``, held against
``trpx_tpu.parallel`` on the suite's 8-device virtual CPU mesh and against
the JAX package's ``pycodec``. Tolerance: exact: archive, file and
manifest bytes, tables and pixels must be equal.
"""

import functools
import json

import numpy as np
import pytest
import torch

import trpx_tpu
import trpx_tpu.parallel as jpar
import trpx_tpu_torch
import trpx_tpu_torch.parallel as tpar
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.ops.coding import FrameSpec as JFrameSpec
from trpx_tpu.parallel import distributed as jdist
from trpx_tpu_torch.ops import FrameSpec
from trpx_tpu_torch.parallel import ShardedCodec, decode_sharded, encode_sharded
from trpx_tpu_torch.parallel import distributed as tdist
from trpx_tpu_torch.runtime import StreamingEncoder


def _stack(F, seed, shape=(16, 16)):
    rng = np.random.default_rng(seed)
    return rng.poisson(3.0, size=(F, *shape)).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _jax_sharded(F):
    return jpar.encode_sharded(_stack(F, F))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("F", [1, 3, 8, 13])
def test_sharded_encode_matches_jax(F, k):
    frames = _stack(F, F)
    ours = encode_sharded(frames, devices=["cpu"] * k)
    ref = _jax_sharded(F)
    assert ours.to_bytes() == ref.to_bytes()
    assert ours.to_bytes() == jpycodec.encode(
        list(frames.reshape(F, -1)), dimensions=(16, 16)).to_bytes()
    np.testing.assert_array_equal(ours.frame_index, ref.frame_index)
    np.testing.assert_array_equal(
        decode_sharded(ours, np.uint16, devices=["cpu"] * k),
        frames.reshape(F, -1))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32])
def test_sharded_roundtrip_dtypes(dtype):
    rng = np.random.default_rng(42)
    info = np.iinfo(dtype)
    lo = max(info.min, -1000) if np.dtype(dtype).kind == "i" else 0
    hi = min(info.max, 4000)
    frames = rng.integers(lo, hi, size=(11, 100), dtype=dtype)
    arch = encode_sharded(frames, devices=["cpu"] * 3)
    assert arch.to_bytes() == jpycodec.encode(list(frames)).to_bytes()
    np.testing.assert_array_equal(
        decode_sharded(arch, dtype, devices=["cpu"] * 4), frames)


def test_sharded_partial_blocks_and_hot_pixels():
    rng = np.random.default_rng(7)
    frames = rng.poisson(3.0, size=(9, 50)).astype(np.uint16)  # 50 % 12 != 0
    frames[rng.integers(0, 9, 15), rng.integers(0, 50, 15)] = 65535
    arch = encode_sharded(frames, devices=["cpu", "cpu"])
    assert arch.to_bytes() == jpycodec.encode(list(frames)).to_bytes()
    np.testing.assert_array_equal(
        decode_sharded(arch, np.uint16, devices=["cpu"] * 5), frames)


def _shard_inputs(F=16, n=600, seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[rng.random((F, n)) < 0.003] = 60000
    return frames


def _both_shard_results(frames):
    F, n = frames.shape
    jspec = JFrameSpec.for_dtype(n, frames.dtype, cap_ratio=0.5)
    jres = jpar.ShardedCodec(jspec, jpar.default_mesh()).encode_shards(
        frames, F)
    spec = FrameSpec.for_dtype(n, frames.dtype)
    tres = ShardedCodec(spec, ["cpu"] * 3).encode_shards(frames, F)
    return (jspec, jres), (spec, tres)


def _frame_bytes(res, f):
    words = np.ascontiguousarray(res.words)
    row = words.view(np.uint8).reshape(words.shape[0], -1)[f - res.frame_lo]
    return row[: int(res.nbytes[f])].tobytes()


def test_shard_result_tables_match_jax():
    frames = _shard_inputs()
    (_, jres), (_, tres) = _both_shard_results(frames)
    for name in ("nbytes", "offsets"):
        np.testing.assert_array_equal(getattr(tres, name),
                                      getattr(jres, name))
        assert getattr(tres, name).dtype == np.int64
    assert (tres.total_bytes, tres.prolix_bits, tres.frame_lo,
            tres.frame_hi) == (jres.total_bytes, jres.prolix_bits,
                               jres.frame_lo, jres.frame_hi)
    for f in range(len(frames)):
        assert _frame_bytes(tres, f) == _frame_bytes(jres, f)


def test_shard_files_and_run_manifest_match_jax(tmp_path):
    frames = _shard_inputs()
    F = len(frames)
    (jspec, jres), (spec, tres) = _both_shard_results(frames)
    dims = (30, 20)
    jdist.write_shard_file(tmp_path / "j.trpx", jres, jspec, F, dims)
    tdist.write_shard_file(tmp_path / "t.trpx", tres, spec, F, dims)
    blob = (tmp_path / "t.trpx").read_bytes()
    assert blob == (tmp_path / "j.trpx").read_bytes()
    assert blob == jpycodec.encode(list(frames), dimensions=dims).to_bytes()
    assert tdist.local_archive(tres, spec, F, dims).to_bytes() == \
        jdist.local_archive(jres, jspec, F, dims).to_bytes()
    for dtype in (None, np.uint16):
        jdist.write_run_manifest(tmp_path / "j.trpx", jres, jspec, F, dims,
                                 dtype=dtype)
        tdist.write_run_manifest(tmp_path / "t.trpx", tres, spec, F, dims,
                                 dtype=dtype)
        assert (tmp_path / "t.trpx.runmanifest").read_bytes() == \
            (tmp_path / "j.trpx.runmanifest").read_bytes()
    assert vars(tdist.meta_for(spec, F, tres.total_bytes, tres.prolix_bits,
                               dims)) == vars(jdist.meta_for(
                                   jspec, F, jres.total_bytes,
                                   jres.prolix_bits, dims))
    with pytest.raises(ValueError):
        tdist.local_archive(tdist.ShardResult(
            frame_lo=4, frame_hi=F, words=tres.words[4:], nbytes=tres.nbytes,
            offsets=tres.offsets, total_bytes=tres.total_bytes,
            prolix_bits=tres.prolix_bits), spec, F)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_shard_across_packages(tmp_path, writer):
    """One package writes the shared file and its run manifest, the back
    half of the payload is lost, the other package recovers it from the
    manifest alone; altered frames are refused."""
    frames = _shard_inputs(F=8, seed=9)
    F = len(frames)
    (jspec, jres), (spec, tres) = _both_shard_results(frames)
    out = tmp_path / "x.trpx"
    if writer == "jax":
        jdist.write_shard_file(out, jres, jspec, F)
        jdist.write_run_manifest(out, jres, jspec, F, dtype=frames.dtype)
        res = jres
    else:
        tdist.write_shard_file(out, tres, spec, F)
        tdist.write_run_manifest(out, tres, spec, F, dtype=frames.dtype)
        res = tres
    ref = out.read_bytes()
    blob = bytearray(ref)
    start = len(ref) - res.total_bytes + int(res.offsets[F // 2])
    blob[start:] = bytes(len(blob) - start)
    out.write_bytes(bytes(blob))
    if writer == "jax":
        tdist.recover_shard(out, frames[F // 2 :], F // 2, device="cpu")
    else:
        jdist.recover_shard(out, frames[F // 2 :], frame_lo=F // 2)
    assert out.read_bytes() == ref
    bad = frames[F // 2 :].copy()
    bad[1, 7] ^= 4095
    with pytest.raises(ValueError):
        tdist.recover_shard(out, bad, F // 2, device="cpu")
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(str(out), device="cpu"), frames)


def _stream_state(path):
    return (json.loads(path.with_name(path.name + ".manifest").read_text()),
            path.with_name(path.name + ".part").read_bytes(),
            path.with_name(path.name + ".part.idx").read_bytes())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_streaming_shard_encoder_resumes_across_packages(tmp_path, first):
    """One package streams the first chunk and stops; the other resumes
    from the manifest and finalizes. The on-disk state after each chunk
    equals the JAX encoder's, and the file equals ``pycodec``'s."""
    frames = _shard_inputs(F=24, n=500, seed=11)
    n = frames.shape[1]
    jcodec = jpar.ShardedCodec(
        JFrameSpec.for_dtype(n, np.uint16, cap_ratio=0.5), jpar.default_mesh())
    tcodec = ShardedCodec(FrameSpec.for_dtype(n, np.uint16), ["cpu"] * 3)
    make = {"jax": lambda p: jdist.StreamingShardEncoder(p, jcodec, np.uint16,
                                                         dimensions=(25, 20)),
            "port": lambda p: tdist.StreamingShardEncoder(p, tcodec, np.uint16,
                                                          dimensions=(25, 20))}
    second = "port" if first == "jax" else "jax"
    out, ref = tmp_path / "s.trpx", tmp_path / "ref.trpx"
    enc, renc = make[first](out), make["jax"](ref)
    enc.add_chunk(frames[:8], 8)
    renc.add_chunk(frames[:8], 8)
    assert _stream_state(out) == _stream_state(ref)
    del enc
    enc = make[second](out)
    assert enc.frames_done == 8
    for lo in (8, 16):
        enc.add_chunk(frames[lo : lo + 8], 8)
        renc.add_chunk(frames[lo : lo + 8], 8)
        assert _stream_state(out) == _stream_state(ref)
    enc.finalize()
    renc.finalize()
    assert out.read_bytes() == ref.read_bytes()
    assert out.read_bytes() == jpycodec.encode(
        list(frames), dimensions=(25, 20)).to_bytes()
    assert not out.with_name("s.trpx.manifest").exists()


def test_streaming_shard_encoder_refuses_other_configuration(tmp_path):
    frames = _shard_inputs(F=4, n=120)
    codec = ShardedCodec(FrameSpec.for_dtype(120, np.uint16), ["cpu"])
    enc = tdist.StreamingShardEncoder(tmp_path / "c.trpx", codec, np.uint16)
    enc.add_chunk(frames, 4)
    other = ShardedCodec(FrameSpec.for_dtype(120, np.int16), ["cpu"])
    with pytest.raises(ValueError, match="manifest"):
        tdist.StreamingShardEncoder(tmp_path / "c.trpx", other, np.int16)
    (tmp_path / "c.trpx.part").write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        tdist.StreamingShardEncoder(tmp_path / "c.trpx", codec, np.uint16)


def test_encode_shards_single_process_tables():
    """Without a process group the world is this process: the counts must
    sum to ``n_frames``, uneven local shards keep frame order, and
    ``meta_for`` plus the words rebuild the archive."""
    frames = _shard_inputs(F=7, n=333, seed=3)
    spec = FrameSpec.for_dtype(333, np.uint16)
    codec = ShardedCodec(spec, ["cpu"] * 3)
    with pytest.raises(ValueError, match="n_frames"):
        codec.encode_shards(frames, 8)
    res = codec.encode_shards(frames, 7)
    assert (res.frame_lo, res.frame_hi) == (0, 7)
    assert tdist.local_archive(res, spec, 7).to_bytes() == \
        jpycodec.encode(list(frames)).to_bytes()
    assert codec.ndev == 3 and all(d.type == "cpu" for d in codec.devices)


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    """The card is the default everywhere: without one, ``ShardedCodec``,
    ``default_devices``, ``recover_shard`` and ``StreamingEncoder`` raise
    RuntimeError (never a fall to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = FrameSpec.for_dtype(100, np.uint16)
    match = r"device='cpu'.*device=False"
    with pytest.raises(RuntimeError, match=match):
        ShardedCodec(spec)
    with pytest.raises(RuntimeError, match=match):
        tpar.default_devices()
    with pytest.raises(RuntimeError, match=match):
        encode_sharded(np.zeros((2, 100), np.uint16))
    frames = _shard_inputs(F=4, n=100)
    out = tmp_path / "r.trpx"
    res = ShardedCodec(spec, ["cpu"]).encode_shards(frames, 4)
    tdist.write_shard_file(out, res, spec, 4)
    tdist.write_run_manifest(out, res, spec, 4, dtype=np.uint16)
    with pytest.raises(RuntimeError, match=match):
        tdist.recover_shard(out, frames[2:], 2)
    for device in (None, True):
        with pytest.raises(RuntimeError, match=match):
            StreamingEncoder(tmp_path / "s.trpx", nvalues=100,
                             dtype=np.uint16, device=device)
    with pytest.raises(ValueError, match="backend='host'"):
        StreamingEncoder(tmp_path / "s.trpx", nvalues=100, dtype=np.uint16,
                         device=False)
    with pytest.raises(ValueError, match="torch devices"):
        ShardedCodec(spec, [False])


def test_public_names_match_jax():
    import trpx_tpu.cli as jcli
    import trpx_tpu.io as jio
    import trpx_tpu_torch.cli as tcli
    import trpx_tpu_torch.io as tio

    assert trpx_tpu_torch.__all__ == trpx_tpu.__all__
    assert trpx_tpu_torch.TrpxArchive is \
        trpx_tpu_torch.format.pycodec.TrpxArchive
    assert [("default_mesh" if n == "default_devices" else n)
            for n in tpar.__all__] == jpar.__all__
    assert tcli.__all__ == jcli.__all__
    assert set(jio.__all__) <= set(tio.__all__)
    for name in ("ShardResult", "meta_for", "write_shard_file",
                 "local_archive", "StreamingShardEncoder",
                 "write_run_manifest", "recover_shard", "init_from_env"):
        assert callable(getattr(tdist, name)), name


def test_init_from_env_without_variables(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_from_env() is False


# ------------------------------------------- dispatch, collect, staging ---


def _hot_stack(F, seed, shape=(5, 10)):
    """(F, 5, 10) u16 frames (50 values: a partial last block of 12) with
    hot pixels, so that stale staging rows would change the bytes."""
    rng = np.random.default_rng(seed)
    frames = rng.poisson(3.0, size=(F, *shape)).astype(np.uint16)
    frames[rng.random(frames.shape) < 0.1] = 65535
    return frames


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_every_shard_dispatched_before_any_collected(monkeypatch, direction,
                                                     k):
    """``ShardedCodec`` dispatches every shard before it waits for any:
    an encode dispatch passes ``pin`` true exactly on CUDA devices (false
    on these CPU ones) and its collect waits for each shard after the
    last dispatch; a decode dispatch fetches nothing, and the shards'
    pixels are fetched together after the last dispatch."""
    from trpx_tpu_torch.ops import coding, staging

    frames = _stack(13, 13).reshape(13, -1)
    spec = FrameSpec.for_dtype(frames.shape[1], np.uint16)
    codec = ShardedCodec(spec, ["cpu"] * k)
    arch = codec.encode(frames)
    calls = []
    name = f"{direction}_dispatch"
    dispatch = getattr(coding, name)

    def recording(*a, **kw):
        p = dispatch(*a, **kw)
        dev = a[3] if direction == "decode" else a[1].device
        calls.append(("dispatch", kw, dev.type))
        return p

    wait, fetch = coding.InFlight.wait, staging.fetch
    monkeypatch.setattr(coding, name, recording)
    monkeypatch.setattr(coding.InFlight, "wait",
                        lambda p: (calls.append(("wait",)), wait(p)))
    monkeypatch.setattr(staging, "fetch", lambda stage, parts, out: (
        calls.append(("fetch", len(parts))), fetch(stage, parts, out)))
    if direction == "encode":
        assert codec.encode(frames).to_bytes() == arch.to_bytes()
        assert calls == ([("dispatch", {"pin": False}, "cpu")] * k
                         + [("wait",)] * k)
    else:
        np.testing.assert_array_equal(codec.decode(arch, np.uint16), frames)
        assert calls == ([("dispatch", {"fetch": False}, "cpu")] * k
                         + [("fetch", k)])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_staging_is_pinned_exactly_for_cuda(device):
    """``ops.staging.upload`` asks for pinned bounce buffers exactly for a
    CUDA device; on a machine without one the pinned request raises
    (there is no fall back to pageable memory). A buffer is zeroed when
    allocated, written in its first columns only, kept while requests fit
    and grown when one does not."""
    from trpx_tpu_torch.ops import staging

    stage = staging.Staging()
    src = np.arange(12, dtype=np.uint16).reshape(3, 4) + 1
    pin = device == "cuda"
    if pin and not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            stage.rows("x", src, 6, torch.uint16, pin=True)
        return
    x = staging.upload(stage, "x", src, 6, torch.uint16, torch.device(device))
    assert x.device.type == device and x.shape == (3, 6)
    np.testing.assert_array_equal(x[:, :4].cpu().numpy(), src)
    assert not x[:, 4:].any()
    assert stage._buf[("x", 0)].is_pinned() == pin
    view = stage.rows("y", src, 6, torch.uint16, pin)
    assert view.is_pinned() == pin and view.shape == (3, 6)
    buf = view.untyped_storage().data_ptr()
    again = stage.rows("y", src[:2] + 7, 6, torch.uint16, pin)
    assert again.untyped_storage().data_ptr() == buf
    np.testing.assert_array_equal(again[:, :4].numpy(), src[:2] + 7)
    assert not again[:, 4:].any()
    grown = stage.rows("y", np.ones((4, 4), np.uint16), 6, torch.uint16, pin)
    assert grown.untyped_storage().data_ptr() != buf
    assert grown.is_pinned() == pin
    np.testing.assert_array_equal(grown.numpy(),
                                  np.pad(np.ones((4, 4)), ((0, 0), (0, 2))))


@pytest.mark.parametrize("rows", [1, 2, 5, 64])
def test_upload_and_fetch_in_bounded_chunks(monkeypatch, rows):
    """``upload`` and ``fetch`` move batches of any length through two
    bounce buffers a slot of at most ``BOUNCE_BYTES``: the rows and the
    zero tail arrive intact, a second, shorter batch of other data
    leaves no stale row, and every part lands in its own rows of the
    output."""
    from trpx_tpu_torch.ops import staging

    monkeypatch.setattr(staging, "BOUNCE_BYTES", rows * 6 * 2)
    rng = np.random.default_rng(rows)
    stage = staging.Staging()
    cpu = torch.device("cpu")
    for F in (13, 4):
        src = rng.integers(1, 60000, (F, 4)).astype(np.uint16)
        x = staging.upload(stage, "x", src, 6, torch.uint16, cpu)
        np.testing.assert_array_equal(x.numpy(), np.pad(src, ((0, 0),
                                                              (0, 2))))
        parts = [(("p", i), lo, torch.from_numpy(src[lo:hi] + i))
                 for i, (lo, hi) in enumerate(((0, F // 2), (F // 2, F)))]
        out = torch.full((F, 4), 7, dtype=torch.uint16)
        staging.fetch(stage, parts, out)
        np.testing.assert_array_equal(
            out.numpy(), np.concatenate([src[: F // 2], src[F // 2 :] + 1]))
    assert {k[1] for k in stage._buf} == ({0, 1} if rows < 13 else {0})
    assert all(b.numel() * 2 <= staging.BOUNCE_BYTES
               for b in stage._buf.values())


def _kind(slot):
    """A staging slot's kind: the name in ((kind, shard), turn)."""
    return slot[0][0]


def _staging_buffers(codec, kind=None):
    return {slot: t.untyped_storage().data_ptr()
            for slot, t in codec._staging._buf.items()
            if kind is None or _kind(slot) == kind}


@pytest.mark.parametrize("bounce", [None, 250])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_reused_codec_encodes_as_jax(monkeypatch, k, bounce):
    """A codec reused across calls keeps its staging buffers: a second
    call with fewer frames, other data and uneven shards still gives the
    JAX package's archive (no stale rows, a zero tail past n = 50), also
    when each shard goes up in chunks of two frames."""
    from trpx_tpu_torch.ops import staging

    if bounce:
        monkeypatch.setattr(staging, "BOUNCE_BYTES", bounce)
    first, second = _hot_stack(13, 1), _stack(11, 2, shape=(5, 10))
    spec = FrameSpec.for_dtype(50, np.uint16)
    codec = ShardedCodec(spec, ["cpu"] * k)
    for frames in (first, second):
        ours = codec.encode(frames.reshape(len(frames), -1), (10, 5))
        assert ours.to_bytes() == jpar.encode_sharded(frames).to_bytes()
        if frames is first:
            kept = _staging_buffers(codec)
    assert _staging_buffers(codec) == kept
    assert {s[0][1] for s in kept if _kind(s) == "frames"} == set(
        range(min(k, 13)))


@pytest.mark.parametrize("bounce", [None, 250])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_reused_codec_decodes_as_jax(monkeypatch, k, bounce):
    """The same for ``decode``: a reused codec keeps its widths buffers,
    no buffer outgrows its bound, and a second archive of fewer frames,
    narrower streams and uneven shards decodes to the JAX package's
    pixels, also in chunks of a few frames."""
    from trpx_tpu_torch.ops import staging

    if bounce:
        monkeypatch.setattr(staging, "BOUNCE_BYTES", bounce)
    first, second = _hot_stack(13, 3), _stack(11, 4, shape=(5, 10))
    spec = FrameSpec.for_dtype(50, np.uint16)
    codec = ShardedCodec(spec, ["cpu"] * k)
    for frames in (first, second):
        blob = jpar.encode_sharded(frames).to_bytes()
        ours = codec.decode(trpx_tpu_torch.TrpxArchive.from_bytes(blob),
                            np.uint16)
        ref = jpar.decode_sharded(trpx_tpu.TrpxArchive.from_bytes(blob),
                                  np.uint16)
        np.testing.assert_array_equal(ours, np.asarray(ref))
        np.testing.assert_array_equal(ours, frames.reshape(len(frames), -1))
        if frames is first:
            kept = _staging_buffers(codec, "widths")
    assert _staging_buffers(codec, "widths") == kept
    assert {s[0][1] for s in kept} == set(range(min(k, 13)))
    for slot, t in codec._staging._buf.items():
        row = {"words": 64 * 4, "widths": spec.nb, "pixels": 2 * 50}[
            _kind(slot)]
        assert t.numel() * t.element_size() <= max(staging.BOUNCE_BYTES, row)


@pytest.mark.parametrize("k", [1, 3])
def test_encode_local_words_outlive_the_next_call(k):
    """The words of ``_encode_local`` (``encode_shards``,
    ``recover_shard``) are the caller's: a first result stays intact
    through a second call of narrower data, which a buffer kept on the
    codec would take."""
    codec = ShardedCodec(FrameSpec.for_dtype(50, np.uint16), ["cpu"] * k)
    a, b = _hot_stack(9, 5).reshape(9, -1), _stack(9, 6, (5, 10)).reshape(
        9, -1)
    words, bits, _ = codec._encode_local(a)
    keep = words.copy()
    codec._encode_local(b)
    np.testing.assert_array_equal(words, keep)
    assert codec.encode(a, (10, 5)).to_bytes() == jpar.encode_sharded(
        a.reshape(9, 5, 10)).to_bytes()
    assert bits.shape == (9,)
