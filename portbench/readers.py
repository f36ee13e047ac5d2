"""Generic readers of the metrics named in ``BENCHMARK.json``.

Each metric has a file ``portbench/metrics/<name>.json`` that names one
of these readers and its parameters, or a file ``<name>.py`` with a
function ``read(run, spec)`` where the arithmetic is new. A reader takes
the finished :class:`portbench.run.Run` and returns a number, or None
when it finds nothing to read: the metric is then left out of the line.
"""

from __future__ import annotations

import statistics

from . import roofline
from . import trace as tr


def setup(run, spec):
    """Seconds from the process's start to the first timed call."""
    return run.setup_s


def rate(run, spec):
    """Work ``spec["count"]`` (a key of the calls' work) completed per
    second, over all the work and all the time of the window."""
    if run.window_s <= 0 or not run.latencies:
        return None
    return run.total(spec["count"]) / run.window_s


def latency_quantile(run, spec):
    """The ``spec["percent"]``th percentile of every call's host-clock
    latency in the window, in ms (``statistics.quantiles``, exclusive
    method, over all calls)."""
    lat = run.latencies
    if len(lat) < 2:
        return None
    q = statistics.quantiles(lat, n=100)[int(spec["percent"]) - 1]
    return 1e3 * q


def range_ms_per_call(run, spec):
    """Summed duration of the host ranges ``spec["ranges"]`` in the traced
    window, ms per call."""
    t = run.trace
    if t is None or not t.calls:
        return None
    if not any(t.ranges.get(n) for n in spec["ranges"]):
        return None
    return 1e3 * tr.range_s(t, spec["ranges"]) / t.calls


def kernel_roofline(run, spec):
    """Percent of the card's peak memory rate: the bytes the traced
    window's calls need moved (``roofline.<spec["bytes"]>`` of their frames,
    values, item size and compressed bytes) over the summed device time
    of every kernel they launched."""
    t = run.trace
    if t is None:
        return None
    count = getattr(roofline, spec["bytes"])
    nbytes = sum(count(w["frames"], w["values"], w["itemsize"],
                       w["payload_bytes"]) for w in run.work)
    return roofline.share_pct(nbytes, tr.kernel_s(t), run.device_name)


def idle_pct(run, spec):
    """Percent of the traced window in which no kernel, copy or memset ran
    on a card, the mean over the run's cards."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s(t) / t.window_s)
