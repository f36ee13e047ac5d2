"""PyTorch port, host glue of ops/coding.py against the JAX package:
FrameSpec, the plain plan tables, narrowing, the archive walk, the
sidecar-table validation and its once-per-process warning. Inputs come
from numpy seeds; tolerance exact.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trpx_tpu import _fallback as jfallback
from trpx_tpu import api as japi
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.io.trpx import read_trpx as jread_trpx
from trpx_tpu.ops import coding as jcoding
from trpx_tpu_torch import _fallback as tfallback
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch.io.trpx import read_trpx, write_index, write_trpx
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops import staging
from trpx_tpu_torch.ops.cuda_pack import plan_batch

from _torch_helpers import pad_batch
from test_torch_pack import _any_frames, u16_frames

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 12, 1000, 512 * 512])
def test_frame_spec_matches_jax(dtype, n):
    ours = tcoding.FrameSpec.for_dtype(n, dtype)
    ref = jcoding.FrameSpec.for_dtype(n, dtype)
    for name in ("n", "block", "signed", "max_width", "nb", "n_padded",
                 "worst_bits", "n_words", "max_block_bits"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.torch_dtype.itemsize == np.dtype(dtype).itemsize


def test_frame_spec_guards():
    with pytest.raises(TypeError):
        tcoding.FrameSpec.for_dtype(100, np.uint64)
    with pytest.raises(ValueError, match="32-bit bit offsets"):
        tcoding.FrameSpec.for_dtype(2**26, np.int32)


PLAN_CASES = [("u16", "poisson", 1000), ("u16", "zero", 100),
              ("u16", "hot", 1000), ("u16", "first_block_zero", 1000),
              ("i16", None, 500), ("i32", None, 301), ("u8", None, 97)]


@pytest.mark.parametrize("dt,kind,n", PLAN_CASES)
def test_plan_tables_match_plan_frame(dt, kind, n):
    if dt == "u16":
        fr = u16_frames(kind, n)
    else:
        fr = _any_frames({"i16": np.int16, "i32": np.int32,
                          "u8": np.uint8}[dt], n, seed=n)
    spec = tcoding.FrameSpec.for_dtype(n, fr.dtype)
    jspec = jcoding.FrameSpec.for_dtype(n, fr.dtype)
    padded = pad_batch(fr, spec)
    ours = plan_batch(spec, torch.from_numpy(padded))
    for f in range(fr.shape[0]):
        x = padded[f]
        x = x.view(np.int32) if x.dtype == np.uint32 else x.astype(np.int32)
        ref = jcoding.plan_frame(jspec, jnp.asarray(x))
        for key in ("width", "hb", "hv", "starts"):
            np.testing.assert_array_equal(
                ours[key][f].numpy(), np.asarray(ref[key]).astype(np.int64),
                err_msg=key)
        assert int(ours["total_bits"][f]) == int(ref["total_bits"])


def test_narrow_values_matches_jax():
    rng = np.random.default_rng(3)
    i32 = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    u16 = rng.integers(0, 2**16, 4000).astype(np.uint16)
    for vals in (i32, u16):
        for dtype in DTYPES:
            if vals.dtype == np.uint16 and np.dtype(dtype).kind == "i":
                continue
            np.testing.assert_array_equal(
                tcoding.narrow_values(vals, dtype),
                jcoding.narrow_values(vals, dtype))


def _foreign(arch):
    """The archive as a reader without its sidecar sees it: no tables."""
    return TrpxArchive.from_bytes(arch.to_bytes())


@pytest.mark.parametrize("indexed", [False, True])
def test_walk_archive_matches_jax(indexed):
    fr = u16_frames("hot", 1000)
    arch = ncodec.encode(fr)
    spec = tcoding.FrameSpec.for_dtype(1000, np.uint16)
    jspec = jcoding.FrameSpec.for_dtype(1000, np.uint16)
    a = arch if indexed else _foreign(arch)
    b = jpycodec.TrpxArchive.from_bytes(arch.to_bytes())  # JAX's own object
    if indexed:
        b.frame_index = arch.frame_index
    widths, words = tcoding.walk_archive(a, spec)
    jw, _, jwords = jcoding.walk_archive(b, jspec)
    np.testing.assert_array_equal(widths, jw)
    sizes = np.diff(np.append(arch.frame_index, arch.meta.memory_size))
    for f, nbytes in enumerate(sizes):
        mine = words[f].view(np.uint8)
        np.testing.assert_array_equal(mine[:nbytes],
                                      jwords[f].view(np.uint8)[:nbytes])
        # two zero words of slack past the stream for the word gather
        assert mine.size >= nbytes + 8 and not mine[nbytes:].any()
    np.testing.assert_array_equal(a.frame_index, arch.frame_index)
    np.testing.assert_array_equal(a.width_table, widths.astype(np.uint8))


def test_walk_uses_a_valid_sidecar_table(monkeypatch):
    arch = ncodec.encode(u16_frames("poisson", 1000))
    spec = tcoding.FrameSpec.for_dtype(1000, np.uint16)
    widths, words = tcoding.walk_archive(arch, spec)   # caches the tables

    def no_walk(*a, **k):
        raise AssertionError("walked despite a valid width table")

    monkeypatch.setattr(tcoding.native, "walk_indexed", no_walk)
    monkeypatch.setattr(tcoding.native, "walk", no_walk)
    w2, words2 = tcoding.walk_archive(arch, spec)
    np.testing.assert_array_equal(w2, widths)
    np.testing.assert_array_equal(words2, words)


def test_validate_tables_rejects_stale_or_crafted_tables():
    fr = u16_frames("poisson", 1000)
    arch = ncodec.encode(fr)
    spec = tcoding.FrameSpec.for_dtype(1000, np.uint16)
    widths, _ = tcoding.walk_archive(arch, spec)
    meta = arch.meta
    starts = np.asarray(arch.frame_index)
    ends = np.append(starts[1:], meta.memory_size)
    tcoding.validate_tables(spec, meta, widths, starts, ends)
    bad = widths.copy()
    bad[1, 5] += 1
    with pytest.raises(ValueError, match="disagree"):
        tcoding.validate_tables(spec, meta, bad, starts, ends)
    with pytest.raises(ValueError, match="prolix_bits"):
        tcoding.validate_tables(spec, meta, widths + 20, starts, ends)
    with pytest.raises(ValueError, match="partition"):
        tcoding.validate_tables(spec, meta, widths, starts + 1, ends)


def test_stale_sidecar_table_is_walked_instead():
    fr = u16_frames("hot", 1000)
    arch = ncodec.encode(fr)
    stale = np.zeros((3, tcoding.FrameSpec.for_dtype(1000, np.uint16).nb),
                     np.uint8)
    stale[:, 0] = 3
    arch.width_table = stale
    out = tcoding.decode(arch, np.uint16, device="cpu")
    np.testing.assert_array_equal(out, fr)
    assert not np.array_equal(arch.width_table, stale)


def test_pure_python_walk_matches_native(monkeypatch):
    fr = u16_frames("hot", 100)
    arch = ncodec.encode(fr)
    spec = tcoding.FrameSpec.for_dtype(100, np.uint16)
    w_native, words_native = tcoding.walk_archive(_foreign(arch), spec)
    monkeypatch.setattr(tcoding.native, "available", lambda: False)
    w_py, words_py = tcoding.walk_archive(_foreign(arch), spec)
    np.testing.assert_array_equal(w_py, w_native)
    np.testing.assert_array_equal(words_py, words_native)
    np.testing.assert_array_equal(
        tcoding.decode(_foreign(arch), np.uint16, device="cpu"), fr)


def test_assemble_archive_matches_jax():
    fr = u16_frames("hot", 1000)
    spec = tcoding.FrameSpec.for_dtype(1000, np.uint16)
    from trpx_tpu_torch.ops.cuda_pack import encode_batch_plain

    w, b, m = encode_batch_plain(
        spec, torch.from_numpy(pad_batch(fr, spec)))
    w, b, m = w.numpy().view(np.uint32), b.numpy(), m.numpy()
    jspec = jcoding.FrameSpec.for_dtype(1000, np.uint16)
    ours = tcoding.assemble_archive(spec, w, b, m, (10, 100))
    ref = jcoding.assemble_archive(jspec, w, b, m, (10, 100))
    assert ours.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(ours.frame_index, ref.frame_index)


# ---------------------------------------- rejected sidecar: one warning ---


@pytest.fixture
def fresh_fallbacks(monkeypatch):
    """Neither package has given a fallback warning in this process yet."""
    monkeypatch.setattr(jfallback, "_seen", set())
    monkeypatch.setattr(tfallback, "_seen", set())


def rejected_sidecar(tmp_path, kind: str, F: int = 5, n: int = 1200):
    """A ``.trpx`` file whose v2 sidecar passes every load-time gate (CRC,
    frame count, payload size, increasing offsets, widths <= prolix_bits)
    but whose tables disagree with each other, so that
    ``validate_tables`` rejects them, and the file's frames. ``kind``:
    "width", one width of frame 2 changed; "offsets", frame 3 starting
    one byte late."""
    rng = np.random.default_rng(33)
    stack = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 20)] = 65535
    p = tmp_path / f"{kind}.trpx"
    write_trpx(ncodec.encode(stack), p, index=True)
    good = read_trpx(p)
    offs = np.asarray(good.frame_index).copy()
    widths = np.asarray(good.width_table).copy()
    if kind == "width":
        widths[2, 3] = 6 if widths[2, 3] != 6 else 5
    else:
        offs[3] += 1
    write_index(p, offs, good.meta.memory_size, widths=widths)
    arch = read_trpx(p)
    assert arch.width_table is not None and arch.frame_index is not None
    return p, stack


def fallback_warnings(call, site: str) -> tuple:
    """``call()``'s result and the messages of the fallback warnings at
    ``site`` it gave."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = call()
    return out, [str(w.message) for w in rec
                 if issubclass(w.category, RuntimeWarning)
                 and f"fallback at {site}" in str(w.message)]


@pytest.mark.parametrize("kind", ["width", "offsets"])
def test_rejected_sidecar_warns_once_per_process(tmp_path, kind,
                                                 fresh_fallbacks):
    """``ops.decode`` distrusts the tables, walks, decodes exactly and gives
    one RuntimeWarning at site ``ops.sidecar_tables``, as the JAX package
    does (``trpx_tpu/ops/coding.py``); a second decode gives none in
    either package."""
    p, stack = rejected_sidecar(tmp_path, kind)
    for call in range(2):
        out, ours = fallback_warnings(
            lambda: tcoding.decode(read_trpx(p), np.uint16, device="cpu"),
            "ops.sidecar_tables")
        np.testing.assert_array_equal(out, stack)
        ref, theirs = fallback_warnings(
            lambda: japi.decompress(jread_trpx(p), dtype=np.uint16,
                                    device=True), "ops.sidecar_tables")
        np.testing.assert_array_equal(np.asarray(ref).reshape(stack.shape),
                                      stack)
        assert len(ours) == len(theirs) == (0 if call else 1)
    assert ours == [] and theirs == []


def test_rejected_sidecar_message_is_the_jax_packages(tmp_path,
                                                      fresh_fallbacks):
    """The port's message is the JAX package's, with its own prefix."""
    p, _ = rejected_sidecar(tmp_path, "width")
    _, ours = fallback_warnings(
        lambda: tcoding.decode(read_trpx(p), np.uint16, device="cpu"),
        "ops.sidecar_tables")
    _, theirs = fallback_warnings(
        lambda: japi.decompress(jread_trpx(p), dtype=np.uint16, device=True),
        "ops.sidecar_tables")
    assert ours[0].startswith("trpx_tpu_torch fallback at ops.sidecar_tables"
                              " (revalidating header walk): ValueError: ")
    assert ours[0].replace("trpx_tpu_torch", "trpx_tpu", 1) == theirs[0]


# ------------------------------------------------ the encode's staging ---

def _hot(dtype, shape, seed, low=1):
    """(F, h, w) frames of `dtype`: Poisson(3) plus `low`, with 7 hot
    pixels at the dtype's maximum."""
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, shape) + low
    fr[rng.integers(0, shape[0], 7), rng.integers(0, shape[1], 7), 0] = \
        np.iinfo(dtype).max
    return fr.astype(dtype)


def _native_bytes(fr, block):
    return ncodec.encode(fr.reshape(len(fr), -1), block=block,
                         dimensions=(fr.shape[2], fr.shape[1])).to_bytes()


#: consecutive ``compress`` calls of one thread: (dtype, (F, h, w), block)
#: a call. Each call but the last reuses or grows the buffers of the one
#: before; every call but the last has values of 1,000 and more, the last
#: of a few, so that a pad column that still held an earlier call's value
#: would widen its block and change the bytes
SEQUENCES = {
    "wide_u32_then_narrow_u16": [
        (np.uint32, (6, 40, 50), 12), (np.uint16, (9, 16, 20), 12)],
    "wide_u16_then_narrow_u16": [
        (np.uint16, (6, 40, 50), 12), (np.uint16, (9, 16, 20), 12)],
    "256_frames_then_tiled_2048_u32_then_256": [
        (np.uint32, (256, 64, 64), 12), (np.uint32, (1, 2048, 2048), 12),
        (np.uint32, (256, 64, 64), 12)],
    "pad_of_11": [
        (np.uint16, (6, 30, 50), 12), (np.uint16, (5, 25, 49), 12)],
    "block_64_then_block_16": [
        (np.int16, (5, 30, 41), 64), (np.int16, (5, 30, 41), 16)],
}


@pytest.mark.parametrize("calls", list(SEQUENCES))
def test_consecutive_compress_calls_leave_no_stale_pad(calls):
    """Consecutive ``compress`` calls of one thread, of other shapes,
    dtypes and blocks, stage through the thread's kept bounce buffers
    (``ops.staging.upload``): each archive is the native codec's bytes."""
    last = len(SEQUENCES[calls]) - 1
    for k, (dtype, shape, block) in enumerate(SEQUENCES[calls]):
        fr = _hot(dtype, shape, k, 1 if k == last else 1000)
        got = tapi.compress(fr, block=block, device="cpu")
        assert got.to_bytes() == _native_bytes(fr, block), k


def test_compress_keeps_its_thread_staging():
    """A second call of the same shape writes into the first call's
    bounce buffers: the thread's staging allocates nothing new."""
    fr = _hot(np.uint16, (9, 16, 20), 3)
    tapi.compress(fr, device="cpu")
    stage = tcoding._thread_staging()
    kept = {k: t.data_ptr() for k, t in stage._buf.items()}
    assert tapi.compress(fr[::-1], device="cpu").to_bytes() == \
        _native_bytes(fr[::-1], 12)
    assert tcoding._thread_staging() is stage
    assert {k: t.data_ptr() for k, t in stage._buf.items()} == kept


def test_threads_compress_at_once():
    """Four threads compress distinct stacks at once, three shapes each:
    each thread stages through its own buffers, and every archive is the
    native codec's bytes."""
    shapes = [(np.uint16, (9, 40, 50), 12), (np.uint16, (7, 16, 20), 12),
              (np.uint32, (5, 25, 49), 12)]
    start = threading.Barrier(4)
    out, stagings, errors = {}, {}, []

    def run(t):
        try:
            start.wait()
            for k, (dtype, shape, block) in enumerate(shapes):
                fr = _hot(dtype, shape, 10 * t + k)
                out[t, k] = (fr, block, tapi.compress(
                    fr, block=block, device="cpu").to_bytes())
            stagings[t] = tcoding._thread_staging()
        except Exception as e:   # reported below with the thread
            errors.append((t, e))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    for (t, k), (fr, block, got) in out.items():
        assert got == _native_bytes(fr, block), (t, k)
    assert len({id(st) for st in stagings.values()}) == 4
    assert tcoding._thread_staging() not in stagings.values()


@pytest.mark.parametrize("first", [(3, 6), (5, 9), (2, 4)])
def test_rows_zero_the_pad_of_a_reused_buffer(first):
    """``Staging.rows`` zeroes the columns past the rows it copies, also
    in a buffer whose last rows were wider or filled those columns."""
    stage = staging.Staging()
    stage.rows("x", np.full(first, 7, np.uint16), first[1], torch.uint16,
               False)
    buf = stage._buf["x"].data_ptr()
    view = stage.rows("x", np.ones((2, 3), np.uint16), 4, torch.uint16,
                      False)
    assert view.data_ptr() == buf
    np.testing.assert_array_equal(
        view.numpy(), np.pad(np.ones((2, 3), np.uint16), ((0, 0), (0, 1))))
