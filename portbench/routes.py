"""The route the program's frames took, and the share of its roofline
that one route's kernels reach.

The program counts the frames of each launch under the kernel wrapper
that took them (``frames.<wrapper>``, ``trpx_tpu_torch.ops.coding``). A
reading of one route's kernels means something only where every frame of
the process took that route: a later change of the program's routing
then leaves the metric without a value instead of with another
kernel's. A program without the counters reads None.
"""

from __future__ import annotations

import re

from . import attribution, roofline
from . import trace as tr


def only_route(wrapper: str) -> bool:
    """True if the program counted frames under ``frames.<wrapper>`` and
    under no other ``frames.*`` counter, over the whole process."""
    c = attribution.program_counters() or {}
    took = {k for k, v in c.items() if k.startswith("frames.") and v}
    return took == {"frames." + wrapper}


def kernel_s(trace: tr.Trace, names) -> float:
    """Summed device time in the window of the kernels whose function is
    one of ``names`` (``...::<name><...>(...)`` or ``...::<name>(...)``
    as the profiler names them), on every card."""
    pattern = re.compile(r"::(?:%s)[<(]" % "|".join(map(re.escape, names)))
    lo, hi = trace.window
    return sum(max(0.0, min(o.end, hi) - max(o.start, lo))
               for o in trace.ops
               if o.kind == "kernel" and pattern.search(o.name))


def roofline_pct(run, wrapper: str, names, count) -> float | None:
    """Percent of the card's peak memory rate: the bytes the traced
    window's calls need moved (``count``, a byte count of ``roofline``)
    over the device time of the kernels ``names`` that ``wrapper``
    launches; None without a trace, or unless every frame of the process
    took ``wrapper``."""
    if run.trace is None or not only_route(wrapper):
        return None
    nbytes = sum(count(w["frames"], w["values"], w["itemsize"],
                       w["payload_bytes"]) for w in run.work)
    return roofline.share_pct(nbytes, kernel_s(run.trace, names),
                              run.device_name)
