"""What the program's own spans and counters leave to the metrics.

* :func:`unattributed_pct`: the share of a traced window in which a call
  runs (a ``portbench.call`` range is open), no operation runs on a card
  and no ``trpx.*`` range is open: host work the program does not name.
  The ranges are taken as one union, so a range inside another counts
  once.
* :func:`per_call_mb`: one kind of the program's byte counters
  (``trpx_tpu_torch.runtime.metrics.counters()``), summed over its spans,
  per call of one entry point, in MB. The counters run over the whole
  process, warm-up calls and the window's alike; a cell's calls all have
  one shape, so the average over them is the window's. A program without
  the counters reads None.
"""

from __future__ import annotations

from . import trace as tr


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two disjoint sorted interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def unattributed_pct(t) -> float | None:
    """Percent of the traced window ``t`` in which a call runs, no device
    operation runs on the card and no ``trpx.*`` range is open, the mean
    over the run's cards; None without a trace, calls or device
    operations."""
    if t is None or t.window_s <= 0 or not t.calls or not t.ops:
        return None
    lo, hi = t.window
    calls = tr._union(t.ranges.get(tr.CALL_RANGE, []), lo, hi)
    named = [iv for n, spans in t.ranges.items()
             if n.startswith(tr.HOST_PREFIXES) for iv in spans]
    per = []
    for d in t.devices:
        covered = tr._union(
            named + [(o.start, o.end) for o in t.ops if o.device == d],
            lo, hi)
        per.append(_length(calls) - _overlap(calls, covered))
    return 100.0 * sum(per) / len(per) / t.window_s


def program_counters() -> dict | None:
    """The program's counters, or None where it keeps none."""
    try:
        from trpx_tpu_torch.runtime import metrics
    except ImportError:
        return None
    read = getattr(metrics, "counters", None)
    return read() if read is not None else None


def per_call_mb(kind: str, calls: str) -> float | None:
    """The program's counters ``<kind>.<span>`` summed over every span,
    per count of ``calls``, in MB (1e6 bytes); None where the program
    keeps no such counters or made no such call."""
    c = program_counters()
    if not c or not c.get(calls):
        return None
    total = sum(v for k, v in c.items() if k.startswith(kind + "."))
    return total / c[calls] / 1e6
