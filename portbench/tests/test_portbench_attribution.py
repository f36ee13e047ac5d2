"""The share of a traced window that no program span names, and the
readers of the program's byte counters, from made-up events and counter
snapshots alone."""

import pytest

from portbench import attribution, run, spec
from portbench import trace as tr
from portbench.tests.test_portbench_roofline import H100, ev

ROOT = run.ROOT

# two calls, 0-1 ms and 1.5-2.5 ms, in a 2.5 ms window; 0.5 ms between
# them in which the cards idle outside any call
EVENTS = [
    ev(tr.CALL_RANGE, 0, 0, 1000, "CPU", True),
    ev(tr.CALL_RANGE, 0, 1500, 2500, "CPU", True),
    ev("trpx.api.parse", 0, 0, 50, "CPU", True),
    ev("trpx.api.consume", 0, 300, 600, "CPU", True),
    ev("trpx.stream.gather", 0, 400, 500, "CPU", True),   # nested
    ev("trpx.stream.buffer", 0, 1500, 1550, "CPU", True),
    ev("portbench.other", 0, 2000, 2100, "CPU", True),    # names nothing
    ev("unpack_kernel", 0, 100, 200),
    ev("Memcpy DtoH (Device -> Pinned)", 0, 1600, 1700),
    ev("unpack_kernel", 1, 550, 900),
]


def _run(events, devices):
    t = tr.from_events(events, devices)
    return run.Run(9.0, t.window_s, [1e-3, 1e-3], [], H100, trace=t)


def test_unattributed_share_of_the_window():
    # card 0: the calls' 2,000 us less parse 50, kernel 100, consume 300
    # (the gather inside it once), buffer 50 and the copy 100
    card0 = 2000 - (50 + 100 + 300 + 50 + 100)
    # card 1: its kernel runs on from the consume's end to 900 us
    card1 = 2000 - (50 + 600 + 50)
    want = 100 * (card0 + card1) / 2 / 2500
    r = _run(EVENTS, [0, 1])
    assert attribution.unattributed_pct(r.trace) == pytest.approx(want)
    b = spec.Bench(ROOT)
    for name in ("decode.unattributed_pct", "encode.unattributed_pct"):
        assert b.reader(name)(r) == pytest.approx(want)


def test_one_card_and_idle_time_between_calls():
    r = _run(EVENTS, [0])
    got = attribution.unattributed_pct(r.trace)
    assert got == pytest.approx(100 * 1400 / 2500)
    # the 500 us between the calls is idle, but no call runs there
    assert spec.Bench(ROOT).reader("decode.idle_pct")(r) > got


def test_nothing_to_read():
    assert attribution.unattributed_pct(None) is None
    no_ops = _run([e for e in EVENTS if e.device_type.endswith("CPU")], [0])
    assert attribution.unattributed_pct(no_ops.trace) is None


def test_program_spans_per_call():
    r = _run(EVENTS, [0])
    b = spec.Bench(ROOT)
    assert b.reader("decode.consume_ms")(r) == pytest.approx(0.3 / 2)
    assert b.reader("decode.ingest_ms")(r) == pytest.approx(0.1 / 2)


SNAPSHOT = {
    "calls.api.decompress": 4, "calls.api.compress": 2,
    "fresh_bytes.trpx.api.consume": 4 * 524_288_000,
    "fresh_bytes.trpx.api.parse": 4 * 112_000_000,
    "host_bytes.trpx.api.consume": 4 * 524_288_000,
    "host_bytes.trpx.stream.gather": 4 * 113_000_000,
    "launches.unpack": 16, "fallback.stream.sidecar_tables": 3,
}


@pytest.mark.parametrize("name,want", [
    ("decode.fresh_host_mb", 524.288 + 112.0),
    ("decode.host_write_mb", 524.288 + 113.0),
    ("encode.fresh_host_mb", 2 * (524.288 + 112.0)),
    ("encode.host_write_mb", 2 * (524.288 + 113.0)),
])
def test_counter_readers(monkeypatch, name, want):
    monkeypatch.setattr(attribution, "program_counters", lambda: SNAPSHOT)
    r = _run(EVENTS, [0])
    assert spec.Bench(ROOT).reader(name)(r) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    None,                                         # a program without them
    {"launches.pack": 3},                         # no such call yet
    {"calls.api.decompress": 0, "fresh_bytes.trpx.api.parse": 5},
])
def test_counter_readers_find_nothing(monkeypatch, counters):
    monkeypatch.setattr(attribution, "program_counters", lambda: counters)
    assert spec.Bench(ROOT).reader("decode.fresh_host_mb")(
        _run(EVENTS, [0])) is None


def test_the_programs_own_counters():
    """The program of this checkout keeps counters the readers read."""
    import numpy as np

    from trpx_tpu_torch import api

    frames = np.arange(2 * 300, dtype=np.uint16).reshape(2, 300)
    api.decompress(api.compress(frames, device="cpu").to_bytes(),
                   device="cpu")
    c = attribution.program_counters()
    assert c["calls.api.decompress"] >= 1
    assert attribution.per_call_mb("fresh_bytes",
                                   "calls.api.decompress") > 0
