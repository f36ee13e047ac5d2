"""Structured per-run metrics: the counterpart of
``trpx_tpu/runtime/metrics.py``.

``StageTimer`` and ``RunReport`` behave as the JAX package's do, so a
report reads the same from either package: frames/s, GB/s of raw data
against the card's HBM peak, compression ratio and scaling efficiency.
``HBM_GBS`` keeps the TPU rows and adds the card this port runs on, keyed
by ``torch.cuda.get_device_name()``. ``profiler_trace`` is a
``torch.profiler`` window in place of ``jax.profiler``. ``event_ms`` and
``device_ms`` time a call on the card: CUDA events around a loop of
calls, with and without the host's share.

:class:`span` is the one way the port opens a ``trpx.*`` range: a
``torch.profiler.record_function`` around the body, so host spans and the
card's operations share the profiler's clock, and a handle for counting
at that span. The counters are plain dict adds, always on and without a
lock. :func:`counters` reads them all. The kernel wrappers keep their
own ``launches``; ``ops.coding`` counts the frames each took.
Spans are leaves: no ``trpx.*`` span opens while another is open on the
same thread, so their durations never hold one another.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

#: HBM peak bandwidth per device, GB/s (public figures)
HBM_GBS = {
    "TPU v5 lite": 819.0,   # v5e
    "TPU v5p": 2765.0,
    "TPU v4": 1228.0,
    "TPU v6 lite": 1640.0,  # v6e / Trillium
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM
}


class StageTimer:
    """Accumulates wall time per named pipeline stage."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (
                self.seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def total(self) -> float:
        return sum(self.seconds.values())


@dataclass
class RunReport:
    """One encode/decode run's metrics, JSON-serializable."""

    operation: str                      # "encode" | "decode"
    frames: int = 0
    raw_bytes: int = 0
    compressed_bytes: int = 0
    device_kind: str = ""
    n_devices: int = 1
    n_hosts: int = 1
    stage_seconds: dict = field(default_factory=dict)

    @property
    def wall_seconds(self) -> float:
        return sum(self.stage_seconds.values())

    @property
    def frames_per_second(self) -> float:
        t = self.wall_seconds
        return self.frames / t if t else 0.0

    @property
    def gb_per_second(self) -> float:
        t = self.wall_seconds
        return self.raw_bytes / t / 1e9 if t else 0.0

    @property
    def compression_ratio(self) -> float:
        return (
            self.compressed_bytes / self.raw_bytes if self.raw_bytes else 0.0
        )

    @property
    def hbm_sol_fraction(self) -> float | None:
        sol = HBM_GBS.get(self.device_kind)
        if not sol or not self.n_devices:
            return None
        return self.gb_per_second / (sol * self.n_devices)

    def scaling_efficiency(self, single_device_fps: float) -> float:
        """fps / (N * single-device fps)."""
        denom = single_device_fps * self.n_devices
        return self.frames_per_second / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = {
            "operation": self.operation,
            "frames": self.frames,
            "raw_bytes": self.raw_bytes,
            "compressed_bytes": self.compressed_bytes,
            "compression_ratio": round(self.compression_ratio, 4),
            "frames_per_second": round(self.frames_per_second, 1),
            "gb_per_second": round(self.gb_per_second, 3),
            "device_kind": self.device_kind,
            "n_devices": self.n_devices,
            "n_hosts": self.n_hosts,
            "stage_seconds": {
                k: round(v, 6) for k, v in self.stage_seconds.items()
            },
        }
        sol = self.hbm_sol_fraction
        if sol is not None:
            d["hbm_sol_fraction"] = round(sol, 4)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def summary(self) -> str:
        parts = [
            f"{self.operation}: {self.frames} frames in "
            f"{self.wall_seconds:.3f}s = {self.frames_per_second:,.0f} "
            f"frames/s ({self.gb_per_second:.2f} GB/s raw)",
            f"compression {self.compression_ratio:.3f}",
        ]
        sol = self.hbm_sol_fraction
        if sol is not None:
            parts.append(f"{100 * sol:.1f}% of HBM SoL")
        stages = ", ".join(
            f"{k} {1e3 * v:.1f}ms" for k, v in self.stage_seconds.items()
        )
        return "; ".join(parts) + (f" [{stages}]" if stages else "")


@contextmanager
def profiler_trace(log_dir: str | None):
    """Optional ``torch.profiler`` window around a region: host ranges and,
    with a card, CUDA kernels and copies. Writes ``trace.json`` (Chrome
    trace format) into ``log_dir``."""
    if not log_dir:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


#: this process's counters by name, from its start or the last
#: :func:`reset_counters`: ``host_bytes.<span>``, ``fresh_bytes.<span>``
#: and ``pinned_bytes.<span>`` (:meth:`span.host`, :meth:`span.fresh`,
#: :meth:`span.pinned`) and the event counters of :func:`count`
#: (``calls.api.*``; ``frames.<kernel wrapper>``, the frames each pack
#: and unpack wrapper took, and ``results.pinned`` / ``results.pageable``,
#: the path of each synchronous decode's result on a card, from
#: ``ops.coding``)
_COUNTS: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`: a dict add without a lock (two
    threads that count at once may lose one add)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


class span:
    """``with span("trpx.<layer>.<step>") as s:`` runs the body in
    ``torch.profiler.record_function(name)`` and gives it ``s`` to count
    at the span: ``s.host(n)``, bytes the host's code writes into host
    memory there (not the copies between a card and the host, nor a
    tensor on a CPU device, which stands for a card's memory), and
    ``s.fresh(n)``, bytes of pageable host arrays allocated anew there
    (pinned buffers come from torch's caching host allocator and are not
    counted). Both count the arrays that grow with a frame's values
    (payloads, words, width tables, pixels) and leave out those of a few
    numbers a frame (offsets, bit counts). ``s.pinned(n)`` counts the
    bytes of a pinned buffer allocated there to be kept across calls
    (``ops.staging``), or that torch's caching host allocator had to pin
    anew there for a decode's copy back (0 when it handed out a cached
    block), apart from both. ``tests/test_torch_trace.py``
    holds each span's fresh bytes to the allocations that ``tracemalloc``
    and the profiler see in it."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        from torch.profiler import record_function

        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)

    def host(self, n: int) -> None:
        count("host_bytes." + self.name, int(n))

    def fresh(self, n: int) -> None:
        count("fresh_bytes." + self.name, int(n))

    def pinned(self, n: int) -> None:
        count("pinned_bytes." + self.name, int(n))


def counters() -> dict:
    """A snapshot of every counter of :func:`count` and :class:`span`."""
    return dict(_COUNTS)


def reset_counters() -> None:
    """Zero every counter of :data:`_COUNTS` (tests)."""
    _COUNTS.clear()


def event_ms(fn, iters: int) -> float:
    """Milliseconds per call of `fn` on the card: CUDA events around a
    loop of `iters` calls after a warm one (host work that outlasts the
    kernels included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of `fn`: CUDA events around `iters`
    calls (after a warm one) that the host queues behind a sleeping
    kernel, so the card runs them back to back and the host's share,
    which a loop of calls shorter than their host work would otherwise
    time, stays hidden. The sleep grows until it outlasts the host's
    queueing; `fn` must not wait for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 24
    for _ in range(5):
        marks[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        marks[1].record()
        for _ in range(iters):
            fn()
        marks[2].record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 4
    raise RuntimeError("the calls kept the host longer than the card slept")
