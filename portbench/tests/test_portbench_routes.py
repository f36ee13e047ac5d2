"""The readers of the tiled kernels' roofline shares and of the
synchronous decode's copy back, on a recorded run: made-up events with
the kernels' names as the profiler gives them, and snapshots of the
program's route counters."""

import pytest

from portbench import attribution, roofline, routes, run, spec
from portbench import trace as tr
from portbench.tests.test_portbench_roofline import H100, ev

ROOT = run.ROOT
NS = "trpx::(anonymous namespace)::"

# two calls, 0-1 ms and 1-2 ms; kernels of both tiled routes, of the
# one-pass ones, a memset and a copy, which no tiled share counts
EVENTS = [
    ev(tr.CALL_RANGE, 0, 0, 1000, "CPU", True),
    ev(tr.CALL_RANGE, 0, 1000, 2000, "CPU", True),
    ev("trpx.decode.d2h", 0, 100, 300, "CPU", True),
    ev("trpx.decode.narrow", 0, 300, 340, "CPU", True),
    ev("trpx.decode.d2h", 0, 1100, 1300, "CPU", True),
    ev(f"void {NS}plan_tiles<unsigned int, 12>(unsigned int const*, int)",
       0, 10, 30),
    ev(f"{NS}pack_starts(int const*, int const*, unsigned char const*)",
       0, 30, 35),
    ev(f"void {NS}place_tiles<unsigned int, 12>(unsigned int const*, int)",
       0, 35, 75),
    ev(f"void {NS}pack_kernel<unsigned short, 12>(unsigned short const*)",
       0, 80, 90),
    ev(f"void {NS}tile_part_bits(unsigned char const*, int, int)",
       0, 1010, 1015),
    ev(f"void {NS}tile_starts(int const*, unsigned char const*, int)",
       0, 1015, 1020),
    ev(f"void {NS}unpack_tiles<int, false, 12>(unsigned int const*)",
       0, 1020, 1050),
    ev(f"void {NS}tile_offsets(unsigned char const*, int)", 0, 1050, 1060),
    ev("Memset (Device)", 0, 1060, 1070),
    ev("Memcpy DtoH (Device -> Pageable)", 0, 1100, 1300),
]
WORK = [{"frames": 1, "values": 1000, "itemsize": 4,
         "payload_bytes": 600}] * 2


def _run(trace=True):
    t = tr.from_events(EVENTS, [0]) if trace else None
    return run.Run(9.0, 2e-3, [1e-3, 1e-3], WORK, H100, trace=t)


@pytest.mark.parametrize("name,wrapper,kernel_us,count", [
    ("encode.tiled_pack_roofline", "encode_batch_tiled", 20 + 5 + 40,
     roofline.encode_bytes),
    ("decode.tiled_unpack_roofline", "decode_batch_tiled", 5 + 5 + 30,
     roofline.decode_bytes),
])
def test_a_tiled_share_reads_its_kernels_alone(monkeypatch, name, wrapper,
                                              kernel_us, count):
    monkeypatch.setattr(attribution, "program_counters",
                        lambda: {"frames." + wrapper: 5,
                                 "calls.api.compress": 5})
    nbytes = 2 * count(1, 1000, 4, 600)
    got = spec.Bench(ROOT).reader(name)(_run())
    assert got == pytest.approx(100 * nbytes / 3.35e12 / (kernel_us * 1e-6))


@pytest.mark.parametrize("name,wrapper,other", [
    ("encode.tiled_pack_roofline", "encode_batch_tiled", "encode_batch"),
    ("decode.tiled_unpack_roofline", "decode_batch_tiled", "decode_batch"),
])
@pytest.mark.parametrize("case", ["both routes", "another route",
                                  "no counters", "no frames", "no trace"])
def test_a_tiled_share_reads_none(monkeypatch, name, wrapper, other, case):
    counters = {"both routes": {"frames." + wrapper: 4, "frames." + other: 1},
                "another route": {"frames." + other: 5},
                "no counters": None,
                "no frames": {"calls.api.compress": 3},
                "no trace": {"frames." + wrapper: 5}}[case]
    monkeypatch.setattr(attribution, "program_counters", lambda: counters)
    r = _run(trace=case != "no trace")
    assert spec.Bench(ROOT).reader(name)(r) is None


def test_only_route_ignores_zero_counts(monkeypatch):
    monkeypatch.setattr(attribution, "program_counters", lambda: {
        "frames.decode_batch_tiled": 2, "frames.decode_batch": 0})
    assert routes.only_route("decode_batch_tiled")
    assert not routes.only_route("decode_batch")


def test_the_synchronous_decodes_copy_back():
    r = _run()
    b = spec.Bench(ROOT)
    # d2h 200 + 200 us and narrow 40 us over two calls
    assert b.reader("decode.collect_ms")(r) == pytest.approx(0.44 / 2)
    r.trace.ranges = {tr.CALL_RANGE: r.trace.ranges[tr.CALL_RANGE]}
    assert b.reader("decode.collect_ms")(r) is None
    assert b.reader("decode.collect_ms")(_run(trace=False)) is None
