"""The reduction of a ``torch.profiler`` window to what the metrics read.

A traced run wraps every timed call in a ``portbench.call`` range, so the
window is the span of those ranges. From the profiler's events this keeps:

* the host ranges (``record_function``) by name: the program's ``trpx.*``
  ranges and the benchmark's own;
* every operation on a card: kernels, copies and memsets, by device. The
  ranges that the profiler mirrors onto the card's timeline are
  annotations, not work, and are left out.

Times are seconds on the profiler's clock, which holds host and device
events alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CALL_RANGE = "portbench.call"
#: host ranges that can say what the host did during an idle gap
HOST_PREFIXES = ("trpx.",)


@dataclass
class DeviceOp:
    name: str
    device: int
    start: float
    end: float
    kind: str       # "kernel", "copy" or "memset"


@dataclass
class Trace:
    ranges: dict          # name -> list of (start, end)
    ops: list             # DeviceOp
    window: tuple         # (start, end) of the timed calls
    calls: int
    devices: list         # device indices the run used

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_events(events, devices) -> Trace:
    """A :class:`Trace` from a profiler's ``events()`` over ``devices``
    (device indices)."""
    ranges: dict = {}
    ops = []
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        dev_type = str(e.device_type).rsplit(".", 1)[-1]
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(HOST_PREFIXES + (CALL_RANGE,)))
        if dev_type == "CPU":
            if annotation:
                ranges.setdefault(e.name, []).append((start, end))
        elif dev_type == "CUDA" and not annotation:
            ops.append(DeviceOp(e.name, int(e.device_index), start, end,
                                _kind(e.name)))
    calls = ranges.get(CALL_RANGE, [])
    window = ((min(s for s, _ in calls), max(e for _, e in calls))
              if calls else (0.0, 0.0))
    return Trace(ranges, ops, window, len(calls), list(devices))


def _union(intervals, lo: float, hi: float) -> list:
    """Disjoint sorted intervals covering ``intervals`` clipped to
    [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on a card, the
    mean over the run's cards."""
    lo, hi = trace.window
    per = [sum(e - s for s, e in _union(
        [(o.start, o.end) for o in trace.ops if o.device == d], lo, hi))
        for d in trace.devices]
    return sum(per) / len(per) if per else 0.0


def kernel_s(trace: Trace) -> float:
    """Summed device time of every kernel and memset in the window, on
    every card, whatever its name (copies between host and card are
    transfers, not kernel work)."""
    lo, hi = trace.window
    return sum(max(0.0, min(o.end, hi) - max(o.start, lo))
               for o in trace.ops if o.kind != "copy")


def range_s(trace: Trace, names) -> float:
    """Summed duration of the host ranges ``names`` in the window."""
    lo, hi = trace.window
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for n in names for s, e in trace.ranges.get(n, []))


def top_device_ops(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time,
    summed by name over the cards."""
    tot: dict = {}
    for o in trace.ops:
        tot[o.name] = tot.get(o.name, 0.0) + (o.end - o.start)
    return [[n[:120], s] for n, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_by_host_range(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]]: the time that the first card sat idle in the
    window, split by the host range (``trpx.*``) open meanwhile, with
    what no such range covers under ``(other host work)``."""
    lo, hi = trace.window
    if not trace.devices:
        return []
    busy = _union([(o.start, o.end) for o in trace.ops
                   if o.device == trace.devices[0]], lo, hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = np.array([(s, e) for s, e in zip(edges[::2], edges[1::2])
                     if e > s]).reshape(-1, 2)
    if not len(gaps):
        return []
    gs, ge = gaps[:, 0, None], gaps[:, 1, None]
    tot: dict = {}
    covered = 0.0
    for name, spans in trace.ranges.items():
        if not name.startswith(HOST_PREFIXES):
            continue
        r = np.array(spans).reshape(-1, 2)
        ov = np.clip(np.minimum(ge, r[:, 1]) - np.maximum(gs, r[:, 0]),
                     0.0, None).sum()
        if ov > 0:
            tot[name] = float(ov)
            covered += float(ov)
    rest = float((gaps[:, 1] - gaps[:, 0]).sum()) - covered
    if rest > 0:
        tot["(other host work)"] = rest
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
