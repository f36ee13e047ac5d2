"""PyTorch port: hostile-input fuzzing of the decode surfaces, held against
the JAX package (tests/test_fuzz_decode.py: the same seeds, the same
mutations).

A production decoder ingests untrusted bytes. Every mutated archive goes
through the port's backends: ``decompress(device="cpu")`` (the kernels'
plain versions), ``decompress(device=False)`` (the native host codec),
the native walk and codec, and ``iter_decode`` on "cpu"; mutated tables
also go straight into the unpack kernels' plain versions. Allowed
outcomes, as in the JAX suite: a clean ValueError, TypeError,
OverflowError, KeyError or IndexError, or a decode. Never a crash, a hang
or a native memory fault.

Archives of more than 256 frames take the pipelined decode (chunks of 256
walked, gathered and unpacked while the previous chunk is in flight): the
mutations of chip_smoke.py's 520-frame base past its first chunk, its
crafted sidecars and ``fetch=False`` through a stream that ends early go
through the port's ``iter_decode(device="cpu")`` and the JAX package's
``iter_decode(device=True)``, outcome for outcome.

Parity with the JAX package, exact: the port's "cpu" path gives the
outcome of ``trpx_tpu.api.decompress(device=True)`` (jnp and Pallas in
interpret mode on the CPU), the port's ``device=False`` that of the JAX
``device=False``: the same exception class, or equal pixels. Device paths
are not held to host paths: corrupt streams decode to one kind of garbage
on the device paths and to another on the host codecs, in both packages
alike. Tables fed straight to the plain versions are held to clean
outcomes and the output's shape only: they are the CUDA kernels'
specification for clamping reads (tests/test_torch_cuda.py), not the TPU
kernel's.
"""

import functools
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cuda import HOSTILE_KINDS, hostile_tables
from trpx_tpu import api as japi
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.io.trpx import read_trpx as jread_trpx
from trpx_tpu.runtime import iter_decode as jiter_decode
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch import native
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.io.trpx import read_index_full, read_trpx, write_index
from trpx_tpu_torch.io.trpx import write_trpx
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import FrameSpec, walk_archive
from trpx_tpu_torch.ops.cuda_unpack import (
    decode_batch_plain,
    decode_batch_tiled_plain,
)
from trpx_tpu_torch.runtime import iter_decode

OK_ERRORS = (ValueError, TypeError, OverflowError, KeyError, IndexError)


def _base_archive(seed: int = 7, frames: int = 3, n: int = 1000) -> bytes:
    rng = np.random.default_rng(seed)
    stack = rng.poisson(3.0, size=(frames, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 20)] = 65535  # hot pixels: wide blocks
    blob = pycodec.encode(list(stack)).to_bytes()
    assert blob == jpycodec.encode(list(stack)).to_bytes()
    return blob


def _outcome(fn):
    """The exception class a call raised, or its output as an array."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.asarray(fn())
    except OK_ERRORS as e:
        return type(e)


def _same(got, want, what: str) -> None:
    if isinstance(want, type) or isinstance(got, type):
        assert got is want, f"{what}: {got} vs {want}"
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def _try_decode_all(blob: bytes) -> None:
    """Every backend of the port decodes or raises a clean error, and each
    path gives the outcome of its JAX counterpart."""
    _same(_outcome(lambda: tapi.decompress(blob, device="cpu")),
          _outcome(lambda: japi.decompress(blob, device=True)), "device")
    _same(_outcome(lambda: tapi.decompress(blob, device=False)),
          _outcome(lambda: japi.decompress(blob, device=False)), "host")
    # the native walk and codec (C code parsing the payload)
    _outcome(lambda: ncodec.decode(TrpxArchive.from_bytes(blob), np.uint16))
    # the chunked device pipeline on the plain versions
    _outcome(lambda: np.concatenate(list(iter_decode(
        blob, tapi.output_dtype(TrpxArchive.from_bytes(blob).meta), 2,
        device="cpu"))))


def _flips(n: int = 120):
    base = bytearray(_base_archive())
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        blob = bytearray(base)
        i = int(rng.integers(hdr_end, len(blob)))
        blob[i] ^= int(rng.integers(1, 256))
        out.append(bytes(blob))
    return out


@pytest.mark.parametrize("part", range(4))
def test_payload_byte_flips(part):
    """The JAX suite's 120 flips (seed 0), in four parts of 30."""
    for blob in _flips()[30 * part : 30 * (part + 1)]:
        _try_decode_all(blob)


def _truncations():
    base = _base_archive()
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(1)
    cuts = set(int(rng.integers(0, len(base))) for _ in range(40))
    cuts |= {0, 1, hdr_end - 1, hdr_end, hdr_end + 1, len(base) - 1}
    return [base[:cut] for cut in sorted(cuts)]


def test_payload_truncations():
    for blob in _truncations():
        _try_decode_all(blob)


def _tampered():
    base = _base_archive()
    hdr_end = base.index(b"/>") + 2
    hdr, payload = base[:hdr_end].decode("latin1"), base[hdr_end:]
    tampered = [
        hdr.replace('number_of_values="1000"', 'number_of_values="100000"'),
        hdr.replace('number_of_values="1000"', 'number_of_values="0"'),
        hdr.replace('number_of_values="1000"', 'number_of_values="-5"'),
        hdr.replace('number_of_frames="3"', 'number_of_frames="1000000"'),
        hdr.replace('number_of_frames="3"', 'number_of_frames="0"'),
        hdr.replace('block="12"', 'block="0"'),
        hdr.replace('block="12"', 'block="-1"'),
        hdr.replace('block="12"', 'block="1000000000"'),
        hdr.replace('prolix_bits="16"', 'prolix_bits="200"'),
        hdr.replace('prolix_bits="16"', 'prolix_bits="-3"'),
        hdr.replace('signed="0"', 'signed="1"'),
        *(hdr.replace(f'memory_size="{len(payload)}"', f'memory_size="{v}"')
          for v in (0, 1, len(payload) * 100, -1)),
    ]
    assert all(h != hdr for h in tampered)
    return [h.encode("latin1") + payload for h in tampered]


def test_header_attribute_tampering():
    for blob in _tampered():
        _try_decode_all(blob)


def _garbage():
    """Random blobs, then a plausible header followed by random bytes."""
    rng = np.random.default_rng(2)
    out = [rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
           for size in (0, 1, 7, 100, 4096)]
    out.append(b'<Terse prolix_bits="16" signed="0" block="12" '
               b'memory_size="512" number_of_values="1000" '
               b'number_of_frames="2"/>'
               + rng.integers(0, 256, size=512, dtype=np.uint8).tobytes())
    return out


def test_random_garbage_blobs():
    *blobs, junk = _garbage()
    for blob in blobs:
        for device in ("cpu", False):
            got = _outcome(lambda: tapi.decompress(blob, device=device))
            assert isinstance(got, type) and issubclass(got, OK_ERRORS)
    _try_decode_all(junk)


def test_smoke_drives_this_corpus_on_the_card():
    """chip_smoke.py phase 11(a) feeds the card the flips, truncations,
    tamperings and garbage of this suite's base archive, in this order,
    then its bursts (seeds 0-3, 16 each)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    corpus = smoke.hostile_corpus(_base_archive(), garbage=True)
    kinds = [k for k, _ in corpus]
    assert kinds == (["flip"] * 120 + ["truncation"] * len(_truncations())
                     + ["tamper"] * 15 + ["burst"] * 64 + ["garbage"] * 6)
    blobs = [b for k, b in corpus if k != "burst"]
    assert blobs == _flips() + _truncations() + _tampered() + _garbage()


def test_signed_flip_into_unsigned_refused():
    """signed=1 flipped onto an unsigned stream hits the type gate on both
    paths, not the sign extension."""
    blob = _base_archive().replace(b'signed="0"', b'signed="1"')
    for device in ("cpu", False):
        with pytest.raises(TypeError):
            tapi.decompress(blob, dtype=np.uint16, device=device)
    with pytest.raises(TypeError):
        japi.decompress(blob, dtype=np.uint16)


def test_width_over_prolix_bits_detected():
    """A payload with blocks wider than the header's prolix_bits is
    corrupt (Terse.hpp:516): the port's walk rejects it as the JAX
    package's does."""
    from trpx_tpu.ops.coding import FrameSpec as JFrameSpec
    from trpx_tpu.ops.coding import walk_archive as jwalk_archive
    from trpx_tpu.io.trpx import TrpxArchive as JTrpxArchive

    rng = np.random.default_rng(3)
    stack = rng.poisson(3.0, size=(2, 1000)).astype(np.uint16)
    stack[0, 5] = 65535  # width-16 block
    blob = pycodec.encode(list(stack)).to_bytes()
    tampered = blob.replace(b'prolix_bits="16"', b'prolix_bits="3"')
    assert tampered != blob
    with pytest.raises(ValueError, match="prolix_bits"):
        walk_archive(TrpxArchive.from_bytes(tampered),
                     FrameSpec.for_dtype(1000, np.uint8))
    with pytest.raises(ValueError, match="prolix_bits"):
        jwalk_archive(JTrpxArchive.from_bytes(tampered),
                      JFrameSpec.for_dtype(1000, np.uint8))


def test_native_walk_max_width_kwarg():
    assert native.available()
    rng = np.random.default_rng(4)
    stack = rng.poisson(3.0, size=(2, 500)).astype(np.uint16)
    stack[1, 3] = 4095  # width 12
    arch = pycodec.encode(list(stack))
    # passes at the true bound, raises below it
    native.walk(arch.payload, 2, 500, 12, max_width=12)
    with pytest.raises(ValueError, match="exceeds"):
        native.walk(arch.payload, 2, 500, 12, max_width=11)
    fs = native.walk(arch.payload, 2, 500, 12)[2]
    native.walk_indexed(arch.payload, fs[:-1], 500, 12, max_width=12)
    with pytest.raises(ValueError, match="exceeds"):
        native.walk_indexed(arch.payload, fs[:-1], 500, 12, max_width=11)


@pytest.mark.parametrize("seed", range(4))
def test_multi_byte_corruption_bursts(seed):
    """Bursts of 8-64 corrupt bytes: the walk terminates (runaway widths
    are caught within one refill window)."""
    base = bytearray(_base_archive(seed=seed + 100, frames=2, n=3000))
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(seed)
    for _ in range(16):
        blob = bytearray(base)
        start = int(rng.integers(hdr_end, len(blob) - 64))
        ln = int(rng.integers(8, 64))
        blob[start:start + ln] = rng.integers(
            0, 256, size=ln, dtype=np.uint8).tobytes()
        _try_decode_all(bytes(blob))


def test_sidecar_fuzz(tmp_path):
    """Random mutations of the .trpx.idx sidecar: its CRC32 rejects every
    one at load, in both packages, and decodes (host, and every tenth on
    the walk-free device path) stay exact."""
    rng = np.random.default_rng(77)
    stack = rng.poisson(3.0, size=(6, 500)).astype(np.uint16)
    arch = pycodec.encode(list(stack))
    p = tmp_path / "f.trpx"
    write_trpx(arch, p, index=True)
    idx = (tmp_path / "f.trpx.idx").read_bytes()
    for trial in range(60):
        blob = bytearray(idx)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(blob)))
            blob[i] ^= int(rng.integers(1, 256))
        (tmp_path / "f.trpx.idx").write_bytes(bytes(blob))
        loaded = read_trpx(p)
        assert loaded.frame_index is None, (
            "CRC32 must reject any corrupted sidecar")
        assert jread_trpx(p).frame_index is None
        out = _outcome(lambda: tapi.decompress(loaded, device=False))
        if not isinstance(out, type):
            np.testing.assert_array_equal(out, stack)
        if trial % 10 == 0:
            np.testing.assert_array_equal(
                tapi.decompress(read_trpx(p), device="cpu"), stack)


# ---------------------------------------------------- hostile tables ---


def _tiled_base(seed=21, frames=3, n=3000):
    rng = np.random.default_rng(seed)
    stack = rng.poisson(3.0, size=(frames, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 30)] = 65535
    return stack, pycodec.encode(list(stack))


@pytest.mark.parametrize("kind", HOSTILE_KINDS)
def test_hostile_tables_into_the_plain_unpacks(kind):
    """The JAX tiled-route test's hostile tables (and the card tests'
    kinds) into both unpack kernels' plain versions, the tiled one at
    64-block tiles as the JAX test runs it and at its default tiles:
    clean outcomes, and (F, n) outputs."""
    stack, arch = _tiled_base()
    spec = FrameSpec.for_dtype(3000, np.uint16)
    widths, words = walk_archive(arch, spec)
    widths = widths.astype(np.uint8)
    wo = torch.from_numpy(words.view(np.int32))
    # sane baseline first: the 64-block tiles are exact
    out = decode_batch_tiled_plain(spec, wo, torch.from_numpy(widths),
                                   torch.uint16, 64)
    np.testing.assert_array_equal(out.numpy(), stack)
    rng = np.random.default_rng(5 + HOSTILE_KINDS.index(kind))
    for _ in range(6):
        wd, w2 = hostile_tables(widths, words, kind, rng)
        wd = torch.from_numpy(wd)
        w2 = torch.from_numpy(w2.view(np.int32))
        for odt in (torch.uint16, torch.int32):
            for fn in (lambda: decode_batch_plain(spec, w2, wd, odt),
                       lambda: decode_batch_tiled_plain(spec, w2, wd, odt,
                                                        64),
                       lambda: decode_batch_tiled_plain(spec, w2, wd, odt)):
                got = _outcome(fn)
                assert isinstance(got, type) or got.shape == (3, 3000)


def test_stale_sidecar_rejected(tmp_path):
    """A CRC-valid but stale sidecar (the archive re-encoded in place with
    the same shape) is not trusted: the table cross-check
    (``ops.coding.validate_tables``) walks instead, and the decode is
    exact on both paths, as in the JAX package."""
    rng = np.random.default_rng(31)
    old = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    new = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    new[0, 0] = 60001  # different widths and sizes somewhere
    p = tmp_path / "s.trpx"
    write_trpx(pycodec.encode(list(old)), p, index=True)
    p.write_bytes(pycodec.encode(list(new)).to_bytes())
    for device in ("cpu", False):
        out = tapi.decompress(read_trpx(p), dtype=np.uint16, device=device)
        np.testing.assert_array_equal(out.reshape(5, 1200), new)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = japi.decompress(jread_trpx(p), dtype=np.uint16, device=True)
    np.testing.assert_array_equal(np.asarray(ref).reshape(5, 1200), new)


def test_crafted_sidecar_inconsistent_tables(tmp_path):
    """A crafted sidecar with in-range widths (CRC, shape and widths <=
    prolix_bits all pass at load) that disagree with the stream is
    distrusted by ``decompress`` and by the chunked ``iter_decode``: both
    walk again and decode exactly."""
    rng = np.random.default_rng(32)
    stack = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    stack[:, rng.integers(0, 1200, 20)] = 65535   # prolix_bits = 16
    arch = pycodec.encode(list(stack))
    assert arch.meta.prolix_bits == 16
    p = tmp_path / "c.trpx"
    write_trpx(arch, p, index=True)
    good = read_trpx(p)
    assert good.frame_index is not None and good.width_table is not None
    bad_w = np.asarray(good.width_table).copy()
    bad_w[2, 3] = 6 if bad_w[2, 3] != 6 else 5   # <= prolix_bits, wrong
    write_index(p, np.asarray(good.frame_index), arch.meta.memory_size,
                widths=bad_w)
    offs, wt = read_index_full(p, 5, arch.meta.memory_size)
    assert offs is not None and np.array_equal(wt, bad_w)
    loaded = read_trpx(p)
    assert loaded.width_table is not None  # every load-time gate passed
    out = tapi.decompress(loaded, dtype=np.uint16, device="cpu")
    np.testing.assert_array_equal(out.reshape(5, 1200), stack)
    got = np.concatenate(list(iter_decode(read_trpx(p), np.uint16,
                                          chunk_frames=2, device="cpu")))
    np.testing.assert_array_equal(got, stack)


# ------------------------------------------- the pipelined decode, >256 ---


@functools.lru_cache(maxsize=1)
def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@functools.lru_cache(maxsize=1)
def _pipeline_base():
    """chip_smoke.py phase 11(a)'s third base (520 x 1,024 u16: chunks of
    256, 256 and 8 frames) and its corpus past the first chunk."""
    smoke = _smoke()
    (F, n), seed = smoke.HOSTILE_BASES[2], smoke.SEED + 14
    stack, base = smoke._hostile_base(F, n, seed)
    return stack, base, smoke.pipeline_corpus(base)


def _chunks(fn):
    """The concatenated chunks of an iter_decode, or its exception class."""
    return _outcome(lambda: np.concatenate(list(fn())))


PIPE_PARTS = 8


@pytest.mark.parametrize("part", range(PIPE_PARTS))
def test_pipelined_decode_past_the_first_chunk_matches_jax(part):
    """Every mutation of the 520-frame base past its first chunk (flips,
    streams that end inside chunks 2 and 3, bursts) through both
    packages' pipelined decode at chunks of 256: the same clean error, or
    equal pixels; in eight parts."""
    _, _, corpus = _pipeline_base()
    assert len(corpus) > 200
    for kind, blob in corpus[part::PIPE_PARTS]:
        ours = _chunks(lambda: iter_decode(blob, np.uint16, 256,
                                           device="cpu"))
        theirs = _chunks(lambda: jiter_decode(blob, np.uint16, 256,
                                              device=True))
        _same(ours, theirs, kind)


def test_pipeline_corpus_lies_past_the_first_chunk():
    """Each mutation leaves the first chunk's 256 frames as they were: the
    flips and bursts change bytes of frames 256 and later, the
    truncations end the stream inside chunk 2 or 3 with the header's
    memory_size set to the cut."""
    _, base, corpus = _pipeline_base()
    smoke = _smoke()
    starts = smoke._frame_starts(base)
    hdr_end = base.index(b"/>") + 2
    first = hdr_end + int(starts[256])
    kinds = [k for k, _ in corpus]
    assert kinds == (["flip"] * 120 + ["truncation"] * kinds.count(
        "truncation") + ["burst"] * 64)
    assert kinds.count("truncation") >= 40
    for kind, blob in corpus:
        meta = TrpxArchive.from_bytes(blob).meta
        if kind == "truncation":
            assert int(starts[256]) <= meta.memory_size < int(starts[-1])
            cut_hdr = blob.index(b"/>") + 2
            assert blob[cut_hdr:] == base[hdr_end:hdr_end
                                          + meta.memory_size]
        else:
            assert len(blob) == len(base) and blob != base
            assert blob[:first] == base[:first]


@pytest.mark.parametrize("kind", ["width", "offsets"])
def test_pipelined_decode_crafted_sidecar_matches_jax(tmp_path, kind):
    """chip_smoke.py's crafted sidecars of the 520-frame base (a width in
    a frame of chunk 2; the offsets of chunk 3 a byte late) pass every
    load-time gate; both packages' pipelined decode distrusts them, walks
    and decodes exactly, each with one warning at stream.sidecar_tables."""
    from trpx_tpu import _fallback as jfallback
    from trpx_tpu_torch import _fallback as tfallback

    stack, base, _ = _pipeline_base()
    p = tmp_path / "c.trpx"
    write_trpx(TrpxArchive.from_bytes(base), p, index=True)
    good = read_trpx(p)
    offs = np.asarray(good.frame_index).copy()
    widths = np.asarray(good.width_table).copy()
    if kind == "width":
        widths[300, 3] = 6 if widths[300, 3] != 6 else 5
    else:
        offs[512:] += 1
    write_index(p, offs, good.meta.memory_size, widths=widths)
    assert read_trpx(p).width_table is not None
    assert jread_trpx(p).width_table is not None
    for pkg, fallback, fn, arch in (
            ("trpx_tpu_torch", tfallback,
             lambda a: iter_decode(a, np.uint16, 256, device="cpu"),
             read_trpx),
            ("trpx_tpu", jfallback,
             lambda a: jiter_decode(a, np.uint16, 256, device=True),
             jread_trpx)):
        fallback._seen.discard("stream.sidecar_tables")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = np.concatenate(list(fn(arch(p))))
        np.testing.assert_array_equal(got, stack)
        said = [str(w.message) for w in rec
                if "fallback at stream.sidecar_tables" in str(w.message)]
        assert len(said) == 1 and said[0].startswith(pkg + " fallback")


@pytest.mark.parametrize("chunk", [2, 3])
def test_pipelined_fetch_false_through_an_early_end_matches_jax(chunk):
    """``iter_decode(fetch=False)`` of the 520-frame base ending one byte
    into chunk 2 or 3: the walk of chunk k + 1 precedes the yield of chunk
    k in both packages, so an end inside chunk 2 raises before chunk 1 is
    yielded, and one inside chunk 3 yields chunk 1 (equal to the JAX
    package's) and then raises; the same exception class."""
    stack, base, _ = _pipeline_base()
    smoke = _smoke()
    starts = smoke._frame_starts(base)
    blob = smoke._truncated(base, int(starts[(chunk - 1) * 256]) + 1)
    ours = iter_decode(blob, np.uint16, 256, device="cpu", fetch=False)
    theirs = jiter_decode(blob, np.uint16, 256, device=True, fetch=False)
    if chunk == 3:
        (out, nf), (jout, jnf) = next(ours), next(theirs)
        assert nf == jnf == 256
        jvals = np.asarray(jout).reshape(256, -1)[:, :1024]
        np.testing.assert_array_equal(out.numpy().astype(np.uint16),
                                      jvals.astype(np.uint16))
        np.testing.assert_array_equal(out.numpy(), stack[:256])
    got = _outcome(lambda: next(ours))
    want = _outcome(lambda: next(theirs))
    assert isinstance(got, type) and got is want


def test_abandoned_pipelines_leave_the_next_decode_exact():
    """Pipelines closed after their first chunk (chunk 2 dispatched), 20
    times; then a decode of the same archive is exact."""
    stack, base, _ = _pipeline_base()
    for _ in range(20):
        gen = iter_decode(base, np.uint16, 256, device="cpu")
        np.testing.assert_array_equal(next(gen), stack[:256])
        gen.close()
    np.testing.assert_array_equal(tapi.decompress(base, device="cpu"), stack)
