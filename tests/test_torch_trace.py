"""PyTorch port, tracing: every host step of ``compress``, ``decompress``
(the chunked stream, one batch, a path with a v2 sidecar) and
``ShardedCodec`` runs in a leaf ``trpx.*`` span of
``runtime.metrics.span``, and the spans' and calls' counters are exact.

Each path runs on ``device="cpu"`` (the kernels' plain versions) under a
CPU ``torch.profiler``: it must show its expected span names, and no two
``trpx.*`` ranges may overlap on one thread (the benchmark sums the idle
time under every ``trpx.*`` name, so a nested span would count twice).
Counts are compared as the change over one call, so other tests of the
same process do not matter.
"""

import collections
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trpx_tpu_torch import TrpxArchive, api, native
from trpx_tpu_torch.io.trpx import write_trpx
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import FrameSpec
from trpx_tpu_torch.parallel import ShardedCodec
from trpx_tpu_torch.runtime import metrics

H, W = 16, 20            # 320 values a frame: 27 blocks of 12, 4 of pad
BLOCK = 12
N_PADDED = 27 * BLOCK


def _stack(F, seed=0, shape=(H, W)):
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, (F, *shape)).astype(np.uint16)
    fr[rng.integers(0, F, 5), rng.integers(0, shape[0], 5), 0] = 65535
    return fr


def _archive(F, shape=(H, W)):
    return ncodec.encode(_stack(F, F, shape).reshape(F, -1), block=BLOCK,
                         dimensions=shape[::-1])


def _blob(F, shape=(H, W)):
    return _archive(F, shape).to_bytes()


def _with_sidecar(tmp_path, F, shape=(H, W)):
    p = tmp_path / "in.trpx"
    write_trpx(_archive(F, shape), p, index=True)
    return p


def _sharded(F):
    spec = FrameSpec.for_dtype(H * W, np.uint16, BLOCK)
    codec = ShardedCodec(spec, ["cpu", "cpu"])
    frames = _stack(F, F).reshape(F, -1)

    def run():
        arch = codec.encode(frames, (W, H))
        np.testing.assert_array_equal(codec.decode(arch, np.uint16), frames)
    return run


#: id -> (the call, on a tmp_path; the trpx.* names it must show)
PATHS = {
    "compress": (
        lambda tmp: api.compress(_stack(9), block=BLOCK, device="cpu"),
        {"trpx.encode.h2d", "trpx.encode.kernel", "trpx.encode.d2h",
         "trpx.encode.assemble"}),
    "decompress_stream": (
        lambda tmp: api.decompress(_blob(300), device="cpu"),
        {"trpx.api.parse", "trpx.stream.buffer", "trpx.stream.walk",
         "trpx.stream.gather", "trpx.decode.h2d", "trpx.decode.kernel",
         "trpx.decode.d2h", "trpx.decode.narrow", "trpx.api.consume"}),
    "decompress_batch": (
        lambda tmp: api.decompress(_blob(9), device="cpu"),
        {"trpx.api.parse", "trpx.stream.buffer", "trpx.stream.walk",
         "trpx.stream.gather", "trpx.decode.h2d", "trpx.decode.kernel",
         "trpx.decode.d2h", "trpx.decode.narrow"}),
    "decompress_path": (
        lambda tmp: api.decompress(str(_with_sidecar(tmp, 9)),
                                   device="cpu"),
        {"trpx.api.parse", "trpx.stream.buffer", "trpx.stream.walk",
         "trpx.stream.gather", "trpx.decode.h2d", "trpx.decode.kernel",
         "trpx.decode.d2h", "trpx.decode.narrow"}),
    "sharded": (
        lambda tmp: _sharded(9)(),
        {"trpx.stage.upload", "trpx.encode.kernel", "trpx.encode.d2h",
         "trpx.encode.assemble", "trpx.stream.buffer", "trpx.stream.walk",
         "trpx.stream.gather", "trpx.decode.h2d", "trpx.decode.kernel",
         "trpx.decode.d2h", "trpx.stage.fetch", "trpx.decode.narrow"}),
}


def _traced(call):
    """``call()`` under a CPU profiler -> [(name, thread, start, end)] of
    its ``trpx.*`` ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("trpx.")]


def _delta(call):
    """``call()``'s change of every counter -> {name: change}, nonzero
    changes only."""
    before = metrics.counters()
    out = call()
    after = metrics.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_step_in_a_leaf_span(path, tmp_path):
    assert native.available()
    call, want = PATHS[path]
    ranges = _traced(lambda: call(tmp_path))
    assert {n for n, *_ in ranges} == want
    by_thread: dict = {}
    for name, thread, start, end in sorted(ranges, key=lambda r: r[2]):
        last = by_thread.get(thread)
        assert last is None or start >= last[1], (
            f"{name} opens inside {last[0]}")
        by_thread[thread] = (name, end)


@pytest.mark.parametrize("path", list(PATHS))
def test_calls_counted_once_a_call(path, tmp_path):
    call, _ = PATHS[path]
    _, got = _delta(lambda: call(tmp_path))
    calls = {k: v for k, v in got.items() if k.startswith("calls.")}
    assert calls == ({} if path == "sharded" else
                     {"calls.api.compress": 1} if path == "compress" else
                     {"calls.api.decompress": 1})


def test_encode_counts():
    fr = _stack(9)
    api.compress(fr, block=BLOCK, device="cpu")     # the buffers made
    arch, got = _delta(lambda: api.compress(fr, block=BLOCK, device="cpu"))
    # the rows and their zero pad, written into the kept bounce buffers:
    # nothing allocated, nothing pinned anew
    assert got["host_bytes.trpx.encode.h2d"] == 9 * N_PADDED * 2
    assert "fresh_bytes.trpx.encode.h2d" not in got
    assert not [k for k in got if k.startswith("pinned_bytes.")]
    # a CPU device's words are not copied at collect, but made contiguous
    # at assembly (each row as wide as the longest frame), then the packed
    # array and its bytes
    size = arch.meta.memory_size
    longest = np.diff(np.append(arch.frame_index, size)).max()
    words = 9 * 4 * -(-longest // 4)
    assert got["fresh_bytes.trpx.encode.assemble"] == words + 2 * size
    assert got["host_bytes.trpx.encode.assemble"] == words + 2 * size
    assert "fresh_bytes.trpx.encode.d2h" not in got


def test_stream_decode_counts():
    F = 300
    arch = _archive(F)
    blob = arch.to_bytes()
    out, got = _delta(lambda: api.decompress(blob, device="cpu"))
    assert out.shape == (F, H, W)
    size = arch.meta.memory_size
    assert got["host_bytes.trpx.api.consume"] == F * H * W * 2
    assert got["fresh_bytes.trpx.api.consume"] == F * H * W * 2
    assert got["fresh_bytes.trpx.stream.buffer"] == size + native.SLACK
    assert got["host_bytes.trpx.stream.buffer"] == size
    # bytes handed over as they are: only the payload's slice is new
    assert got["fresh_bytes.trpx.api.parse"] == size
    # the words of every chunk, pageable for a CPU device, each row two
    # words past its chunk's longest frame; the widths are views of the
    # walk's table
    sizes = np.diff(np.append(arch.frame_index, size))
    words = sum(len(c) * 4 * -(-(int(c.max()) + 8) // 4)
                for c in (sizes[:256], sizes[256:]))
    assert got["host_bytes.trpx.stream.gather"] == words
    assert got["fresh_bytes.trpx.stream.gather"] == words


def test_path_parse_counts_the_file_and_the_payload(tmp_path):
    p = _with_sidecar(tmp_path, 9)
    _, got = _delta(lambda: api.decompress(p, device="cpu"))
    size = TrpxArchive.from_bytes(p.read_bytes()).meta.memory_size
    # and the sidecar's width table, read then copied without its checksum
    table = 9 * (N_PADDED // BLOCK)
    assert got["fresh_bytes.trpx.api.parse"] == (
        p.stat().st_size + size + 2 * table)
    # a buffer other than bytes is copied first
    _, got = _delta(lambda: api.decompress(bytearray(p.read_bytes()),
                                           device="cpu"))
    assert got["fresh_bytes.trpx.api.parse"] == p.stat().st_size + size


def test_sharded_counts():
    F = 9
    spec = FrameSpec.for_dtype(H * W, np.uint16, BLOCK)
    codec = ShardedCodec(spec, ["cpu", "cpu"])
    frames = _stack(F).reshape(F, -1)
    arch, got = _delta(lambda: codec.encode(frames, (W, H)))
    words = got["fresh_bytes.trpx.encode.d2h"]
    assert words % (4 * F) == 0 and words >= arch.meta.memory_size
    out, got = _delta(lambda: codec.decode(arch, np.int16))
    assert out.dtype == np.int16
    # uint16 lanes clamped, then cast to int16: two new arrays
    assert got["fresh_bytes.trpx.decode.narrow"] == 2 * frames.nbytes


def test_count_and_reset(monkeypatch):
    monkeypatch.setattr(metrics, "_COUNTS", {})
    metrics.count("calls.x")
    metrics.count("calls.x", 4)
    with metrics.span("trpx.test.step") as s:
        s.host(3)
        s.fresh(7)
    assert metrics.counters() == {
        "calls.x": 5, "host_bytes.trpx.test.step": 3,
        "fresh_bytes.trpx.test.step": 7}
    metrics.reset_counters()
    assert metrics.counters() == {}


def test_a_span_counts_without_a_profiler():
    before = metrics.counters().get("host_bytes.trpx.test.bare", 0)
    with metrics.span("trpx.test.bare") as s:
        s.host(4)
    assert metrics.counters()["host_bytes.trpx.test.bare"] - before == 4


def test_stream_walk_counts_its_tables():
    F = 300
    _, got = _delta(lambda: api.decompress(_blob(F), device="cpu"))
    nb = N_PADDED // BLOCK
    # each chunk's int32 widths, and the uint8 table the walk leaves
    assert got["fresh_bytes.trpx.stream.walk"] == F * nb * 4 + F * nb
    assert got["host_bytes.trpx.stream.walk"] == F * nb * 4 + F * nb


#: frames of the allocation check: 6,400 values, so that every counted
#: array is tens of KiB or more, above the few KiB of Python objects a
#: span makes
BIG = (64, 100)


def _big_call(path, tmp_path, device="cpu"):
    """(the call of ``path`` on ``BIG`` frames on ``device``, its input
    made beforehand; its frame count)."""
    F = 300 if path == "decompress_stream" else 64
    if path == "compress":
        fr = _stack(F, 0, BIG)
        return lambda: api.compress(fr, block=BLOCK, device=device), F
    if path == "sharded":
        spec = FrameSpec.for_dtype(BIG[0] * BIG[1], np.uint16, BLOCK)
        codec = ShardedCodec(spec, ["cpu", "cpu"])
        fr = _stack(F, 0, BIG).reshape(F, -1)
        return lambda: codec.decode(codec.encode(fr, BIG[::-1]),
                                    np.int16), F
    if path == "decompress_path":
        p = str(_with_sidecar(tmp_path, F, BIG))
        return lambda: api.decompress(p, device=device), F
    blob = _blob(F, BIG)
    return lambda: api.decompress(blob, device=device), F


#: spans whose CPU tensors stand for a card's memory (the kernels' inputs
#: and outputs, the sharded upload's), which host counts leave out
DEVICE_SPANS = ("trpx.encode.h2d", "trpx.encode.kernel",
                "trpx.decode.h2d", "trpx.decode.kernel",
                "trpx.stage.upload")


def _allocated(call):
    """``call()``'s host allocations in each ``trpx.*`` span -> {span:
    bytes}: the rise of ``tracemalloc``'s peak over the span (numpy's
    buffers and Python's bytes), plus the net bytes of torch's CPU
    allocator in it (the profiler's memory records)."""
    rise = collections.Counter()
    enter, leave = metrics.span.__enter__, metrics.span.__exit__
    mark = []

    def measured_enter(self):
        mark.append(tracemalloc.get_traced_memory()[0])
        tracemalloc.reset_peak()
        return enter(self)

    def measured_exit(self, *exc):
        leave(self, *exc)
        rise[self.name] += tracemalloc.get_traced_memory()[1] - mark.pop()

    metrics.span.__enter__ = measured_enter
    metrics.span.__exit__ = measured_exit
    tracemalloc.start()
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            call()
    finally:
        tracemalloc.stop()
        metrics.span.__enter__, metrics.span.__exit__ = enter, leave
    for e in prof.events():
        if e.name.startswith("trpx.") and e.name not in DEVICE_SPANS:
            rise[e.name] += e.cpu_memory_usage
    return rise


@pytest.mark.parametrize("path", [
    "compress", "decompress_stream", "decompress_batch", "decompress_path",
    "sharded"])
def test_fresh_bytes_are_the_allocations(path, tmp_path):
    """Each span's declared fresh bytes are what it allocates, but for
    Python's objects and a few numbers a frame: a copy taken away, or
    added, without its count fails here."""
    _check_fresh_bytes(*_big_call(path, tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("path", [
    "compress", "decompress_stream", "decompress_batch"])
def test_fresh_bytes_are_the_allocations_on_card(path, tmp_path):
    """As above on a card, where the words, the pixels and the chunks
    cross through pageable or pinned host memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_fresh_bytes(*_big_call(path, tmp_path, "cuda"))


def _check_fresh_bytes(call, F):
    call()                                # caches and buffers made
    allocated, got = _delta(lambda: _allocated(call))
    declared = {k.removeprefix("fresh_bytes."): v for k, v in got.items()
                if k.startswith("fresh_bytes.")}
    slack = (16 << 10) + 64 * F
    for name in (set(allocated) | set(declared)) - set(DEVICE_SPANS):
        assert abs(declared.get(name, 0) - allocated[name]) <= slack, (
            name, declared.get(name, 0), allocated[name])
