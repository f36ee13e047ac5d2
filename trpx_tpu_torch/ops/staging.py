"""Host staging buffers for the copies between the host and a device.

A copy between a CUDA device and *pageable* host memory blocks the host:
CUDA stages it through a pinned buffer of its own, and a copy back
returns only once it has landed, after every kernel queued before it. So
the host side of a copy that must not wait goes through pinned memory,
and these buffers are kept across calls rather than pinned anew for each.

:class:`Staging` holds the buffers, one per slot; :func:`upload` and
:func:`fetch` move a batch of rows to and from a device through two
buffers a slot of at most :data:`BOUNCE_BYTES` each, so the pinned memory
stays bounded whatever the batch, and the host's copy of one chunk runs
while the card copies the other. They run in the spans
``trpx.stage.upload`` (or the name the caller gives: the single-card
encode's is ``trpx.encode.h2d``) and ``trpx.stage.fetch``. An upload
counts the bytes the host writes into its bounce buffers (rows and pad)
as ``host_bytes.<span>``; each pinned buffer allocated counts its bytes
once as ``pinned_bytes.<span>``, so a warm call of a shape seen before
counts none.

:class:`Lender` hands out host tensors that outlive the call, within a
budget: the synchronous decode on a card (``ops.coding.decode``) lends
its result from torch's caching host allocator, pinned, while the
results that callers hold stay within :data:`PINNED_RESULT_BYTES`
(:data:`RESULTS`).
"""

from __future__ import annotations

import contextlib
import math
import threading
import warnings
import weakref

import numpy as np
import torch

from ..runtime.metrics import span

#: bytes of each of the two bounce buffers of an upload or fetch slot
BOUNCE_BYTES = 32 << 20

#: most bytes of pinned host memory that the results of synchronous
#: decodes on a card may hold at once (:data:`RESULTS`); a decode whose
#: result would pass it returns pageable memory. A movie of 40 Gatan K3
#: frames (5760x4092 u8, 943 MB) takes a block of 1 GiB: four such
#: blocks let a consumer hold the movie it is processing, and a sample
#: of others, while the next one decodes
PINNED_RESULT_BYTES = 4 << 30


class Lender:
    """Host tensors lent to callers within a budget of bytes. Each counts
    the block torch's caching host allocator hands out for it (the
    request rounded up to a power of two) from its allocation until its
    memory dies with the last tensor or array that views it. The block
    then goes back to torch's cache, where the next request of its size
    finds it with its pages resident; a pinned block is handed out again
    only once the copies recorded on it are done. Safe to call from
    several threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lent = 0

    def take(self, shape, dtype: torch.dtype, pin: bool,
             budget: int) -> torch.Tensor | None:
        """A new host tensor of `shape` and `dtype`, pinned when `pin`, or
        None when its block would bring the bytes lent past `budget`."""
        n = 1 << max(math.prod(shape) * dtype.itemsize - 1, 0).bit_length()
        with self._lock:
            if self.lent + n > budget:
                return None
            self.lent += n
        try:
            t = torch.empty(shape, dtype=dtype, pin_memory=pin)
        except BaseException:
            self._give_back(n)
            raise
        # the storage lives as long as any tensor or numpy array over it
        weakref.finalize(t.untyped_storage(), self._give_back, n)
        return t

    def _give_back(self, n: int) -> None:
        with self._lock:
            self.lent -= n


#: the results of synchronous decodes that callers hold
RESULTS = Lender()


def pinned_total() -> int:
    """Bytes torch's caching host allocator has pinned in this process so
    far: ``allocated_bytes.allocated`` of ``torch.cuda.host_memory_stats``,
    which grows by each block made and not by a cached block handed out
    again (0 where torch has no such call)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return stats().get("allocated_bytes.allocated", 0) if stats else 0


class Staging:
    """Host buffers kept across calls, one per slot (any hashable key).

    A buffer is pinned exactly when the request says so (a CUDA copy will
    read or write it); a failed pinned allocation raises, there is no
    fall back to pageable memory. It is zeroed when allocated and grows
    only when a request needs more than it holds. Before a buffer is
    handed out again, the host waits for the device work that last used
    it (:meth:`used`). A ``Staging`` belongs to one thread at a time."""

    def __init__(self) -> None:
        self._buf: dict = {}
        self._used: dict = {}
        self._side: dict = {}

    def side(self, device: torch.device) -> torch.cuda.Stream:
        """The CUDA stream of `device` that :func:`upload` copies on."""
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def ready(self, slot) -> None:
        """Wait for the device work recorded by :meth:`used` on `slot`."""
        ev = self._used.pop(slot, None)
        if ev is not None:
            ev.synchronize()

    def buffer(self, slot, numel: int, dtype: torch.dtype, pin: bool,
               at: span | None = None) -> torch.Tensor:
        """The first `numel` elements of slot's buffer, once the host may
        write them. A pinned buffer allocated here counts its bytes at the
        open span `at` (:meth:`span.pinned`; None: not counted)."""
        self.ready(slot)
        buf = self._buf.get(slot)
        if (buf is None or buf.numel() < numel or buf.dtype != dtype
                or (pin and not buf.is_pinned())):
            buf = torch.zeros(numel, dtype=dtype, pin_memory=pin)
            self._buf[slot] = buf
            if pin and at is not None:
                at.pinned(buf.nbytes)
        return buf[:numel]

    def rows(self, slot, src: np.ndarray, cols: int, dtype: torch.dtype,
             pin: bool, at: span | None = None) -> torch.Tensor:
        """Copy the host rows `src` (F, c) into the first c columns of
        slot's buffer viewed as (F, `cols`), zero columns c to `cols` (the
        pad to the block grid, which a buffer last used for other rows
        may hold stale values in) and return that view."""
        F, c = src.shape
        view = self.buffer(slot, F * cols, dtype, pin, at).view(F, cols)
        with warnings.catch_warnings():
            # the rows are only read: a read-only input is fine
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(np.ascontiguousarray(src))
        # torch's copy runs on all host threads, numpy's strided copy on
        # one: 28-36 against 106-127 ms per 32 x 2048x2048 u32 chunk on
        # the 8-core host of an H100 80GB HBM3 (PERF.md, section 6)
        view[:, :c].copy_(src)
        if c < cols:
            view[:, c:].zero_()
        return view

    def used(self, slot, stream) -> None:
        """Mark slot's buffer as used by the work queued so far on the
        CUDA `stream` (None: nothing to wait for)."""
        if stream is not None:
            ev = torch.cuda.Event()
            ev.record(stream)
            self._used[slot] = ev


def _chunk_rows(cols: int, dtype: torch.dtype) -> int:
    """Rows of `cols` values of `dtype` in one bounce buffer (at least 1)."""
    return max(1, BOUNCE_BYTES // (cols * dtype.itemsize))


def upload(staging: Staging, slot, src: np.ndarray, cols: int,
           dtype: torch.dtype, device: torch.device,
           name: str = "trpx.stage.upload") -> torch.Tensor:
    """Copy the host rows `src` (F, c) into a new (F, `cols`) tensor on
    `device`, zero past column c, through the bounce buffers ``(slot, 0)``
    and ``(slot, 1)``, which the host fills in turn, in the span `name`.
    For a CUDA device they are pinned and the copies run on the device's
    side stream (:meth:`Staging.side`), which its current stream then
    waits for: the host waits only for an earlier upload from the same
    buffer, never for a kernel. Returns without waiting for the last
    copy."""
    F, _ = src.shape
    pin = device.type == "cuda"
    side = staging.side(device) if pin else None
    R = _chunk_rows(cols, dtype)
    with span(name) as s, \
            torch.cuda.stream(side) if pin else contextlib.nullcontext():
        x = torch.empty((F, cols), dtype=dtype, device=device)
        for j, a in enumerate(range(0, F, R)):
            key = (slot, j % 2)
            b = min(a + R, F)
            x[a:b].copy_(staging.rows(key, src[a:b], cols, dtype, pin, s),
                         non_blocking=True)
            staging.used(key, side)
        s.host(F * cols * dtype.itemsize)
    if pin:
        stream = torch.cuda.current_stream(device)
        stream.wait_stream(side)
        x.record_stream(stream)
    return x


def fetch(staging: Staging, parts: list, out: torch.Tensor) -> None:
    """Copy device tensors into rows of the host tensor `out`: `parts` is
    [(slot, lo, t)], t (hi - lo, ...) on a device whose current stream
    owns it. Each part passes in chunks through its two bounce buffers
    ``(slot, 0)`` and ``(slot, 1)``, pinned for a CUDA device: the next
    chunk of every part is started before the host copies the last ones
    out, so the devices' copies run together and beside the host's.
    Returns when every row has landed."""
    plan = [(slot, lo, t, _chunk_rows(math.prod(t.shape[1:]), t.dtype))
            for slot, lo, t in parts]
    steps = max((-(-len(t) // R) for _, _, t, R in plan), default=0)
    pending = []
    with span("trpx.stage.fetch") as s:
        for j in range(steps + 1):
            started = []
            for slot, lo, t, R in plan:
                a, b = j * R, min((j + 1) * R, len(t))
                if a >= b:
                    continue
                key = (slot, j % 2)
                pin = t.device.type == "cuda"
                buf = staging.buffer(key, t[a:b].numel(), t.dtype, pin, s)
                buf = buf.view(t[a:b].shape)
                stream = torch.cuda.current_stream(t.device) if pin else None
                with (torch.cuda.stream(stream) if pin
                      else contextlib.nullcontext()):
                    buf.copy_(t[a:b], non_blocking=True)
                staging.used(key, stream)
                started.append((key, buf, lo + a, lo + b))
            for key, buf, a, b in pending:
                staging.ready(key)
                out[a:b].copy_(buf)
            pending = started
