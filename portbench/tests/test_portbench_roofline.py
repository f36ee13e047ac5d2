"""Roofline byte counts and the trace's reduction, from shapes, archive
sizes and made-up events alone."""

from types import SimpleNamespace as NS

import pytest

from portbench import readers, roofline, run
from portbench import trace as tr

H100 = "NVIDIA H100 80GB HBM3"


def test_counts_follow_from_shapes_and_archive_sizes():
    # 256 x 512x512 u16 in, a 28.5 MB payload out
    assert roofline.encode_bytes(256, 512 * 512, 2, 28_500_000) == (
        256 * 512 * 512 * 2 + 28_500_000)
    # 32 x 2048x2048 u32 out of a 60 MB payload
    assert roofline.decode_bytes(32, 2048 * 2048, 4, 60_000_000) == (
        60_000_000 + 32 * 2048 * 2048 * 4)


def test_share_of_the_peak():
    assert roofline.share_pct(3.35e9, 1e-3, H100) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 4e-3, H100) == pytest.approx(25.0)
    assert roofline.share_pct(1, 1e-3, "some other card") is None
    assert roofline.share_pct(1, 0.0, H100) is None


def ev(name, dev, start_us, end_us, device="CUDA", annot=False):
    return NS(name=name, device_type=f"DeviceType.{device}",
              device_index=dev, is_user_annotation=annot,
              time_range=NS(start=start_us, end=end_us))


EVENTS = [
    ev(tr.CALL_RANGE, 0, 0, 1000, "CPU", True),
    ev(tr.CALL_RANGE, 0, 1000, 2000, "CPU", True),
    ev("trpx.encode.pad", 0, 0, 600, "CPU", True),
    ev("trpx.encode.h2d", 0, 600, 900, "CPU", True),
    ev("trpx.encode.pad", 0, 1000, 1500, "CPU", True),
    ev("aten::copy_", 0, 600, 900, "CPU"),
    ev("trpx.encode.pad", 0, 0, 600, "CUDA", True),      # a mirror, no work
    ev("Memcpy HtoD (Pageable -> Device)", 0, 600, 900),
    ev("pack_kernel", 0, 900, 1000),
    ev("Memset (Device)", 0, 950, 960),
    ev("pack_kernel", 1, 1700, 1800),
]


def test_the_trace_reduction():
    t = tr.from_events(EVENTS, [0, 1])
    assert t.calls == 2 and t.window == (0.0, 2e-3)
    assert set(t.ranges) == {tr.CALL_RANGE, "trpx.encode.pad",
                             "trpx.encode.h2d"}
    assert [o.kind for o in t.ops] == ["copy", "kernel", "memset", "kernel"]
    assert tr.kernel_s(t) == pytest.approx(210e-6)
    # card 0 busy 400 us, card 1 100 us, of a 2 ms window
    assert tr.busy_s(t) == pytest.approx(250e-6)
    assert tr.range_s(t, ["trpx.encode.pad"]) == pytest.approx(1.1e-3)
    gaps = dict(tr.idle_by_host_range(t))
    assert gaps["trpx.encode.pad"] == pytest.approx(1.1e-3)
    assert gaps["(other host work)"] == pytest.approx(0.5e-3)
    assert tr.top_device_ops(t)[0] == ["Memcpy HtoD (Pageable -> Device)",
                                       pytest.approx(300e-6)]


def test_readers_on_a_trace():
    t = tr.from_events(EVENTS, [0, 1])
    work = [{"frames": 1, "values": 1000, "itemsize": 2,
             "payload_bytes": 500}] * 2
    r = run.Run(9.0, 2e-3, [1e-3, 1e-3], work, H100, trace=t)
    nbytes = 2 * (1000 * 2 + 500)
    assert readers.kernel_roofline(r, {"bytes": "encode_bytes"}) == (
        pytest.approx(100 * nbytes / 3.35e12 / 210e-6))
    assert readers.idle_pct(r, {}) == pytest.approx(87.5)
    assert readers.range_ms_per_call(
        r, {"ranges": ["trpx.encode.pad", "trpx.encode.h2d"]}) == (
        pytest.approx(0.7))
    assert readers.range_ms_per_call(r, {"ranges": ["trpx.nothing"]}) is None
    assert readers.rate(r, {"count": "frames"}) == pytest.approx(1000.0)
    assert readers.latency_quantile(r, {"percent": 95}) == pytest.approx(1.0)
    assert readers.setup(r, {}) == 9.0
