"""What every encode cell and every decode cell shares: the inputs made
from the seed, the work each call does, the small record kept of every
call, the comparison with the reference once the window has closed, and
the control that stands in the program's place.

An entry (``portbench/entries/<entry>.py``) subclasses one of these with
its ``Cell`` and adds the timed ``call``.

A cell's check is one count, ``differences``, with the limit 0: the codec
is lossless and its archives are byte-exact, so any difference is a
fault. It adds up what every call got wrong among a seeded sample of its
output, what a seeded sample of calls got wrong anywhere, and the whole
of each call that never answered.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from . import reference, synth

#: the control's precision: the next narrower unsigned type
LOWER = {np.dtype(np.uint16): np.dtype(np.uint8),
         np.dtype(np.uint32): np.dtype(np.uint16)}


def bytes_differing(a: bytes, b: bytes) -> int:
    """Bytes at which ``a`` and ``b`` differ, each byte past the shorter
    one counted."""
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    m = min(len(x), len(y))
    return int(np.count_nonzero(x[:m] != y[:m])) + abs(len(x) - len(y))


def pixels_differing(out, want: np.ndarray) -> int:
    """Pixels of ``out`` that differ from ``want``; every pixel when the
    shape or the type differs."""
    out = np.asarray(out)
    if out.shape != want.shape or out.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(out != want))


def header_fields(meta) -> tuple:
    return (int(meta.prolix_bits), bool(meta.signed), int(meta.block),
            int(meta.memory_size), int(meta.number_of_values),
            tuple(int(d) for d in meta.dimensions),
            int(meta.number_of_frames))


class BaseCell:
    """Inputs from the seed: a pool of frames, and which pool frames each
    of the distinct inputs holds (``synth.plan``). ``reference_s`` holds
    the seconds of set-up that the reference's work took (``by_reference``):
    the run leaves them out of ``setup_s``."""

    def __init__(self, ctx) -> None:
        c, t = ctx.config, ctx.traffic
        self.ctx = ctx
        self.reference_s = 0.0
        self.h, self.w = int(c["height"]), int(c["width"])
        self.n = self.h * self.w
        self.dims = (self.w, self.h)
        self.dtype = np.dtype(c["dtype"])
        self.block = int(c["block"])
        self.F = int(t["frames_per_call"])
        self.distinct = int(t["distinct_inputs"])
        pool = int(t.get("pool_frames") or self.F * self.distinct)
        self.plan = synth.plan(self.distinct, self.F, pool, ctx.seed)
        self.pool = synth.frames(pool, self.n, self.dtype, c["pixels"],
                                 ctx.seed, ctx.devices[0])
        self.rng = np.random.default_rng([ctx.seed, 2])
        self.probe_count = int(t["probe_count"])

    @contextlib.contextmanager
    def by_reference(self):
        """Count the time inside as the reference's set-up work: its
        archives, and the files and sidecars it writes for the program."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.reference_s += time.perf_counter() - t

    def frames_of(self, k: int) -> np.ndarray:
        """(F, n) frames of call ``k``'s input."""
        return self.pool[self.plan[k % self.distinct]]

    def release(self) -> None:
        """Drop what the program holds, before the reference runs."""


class EncodeCell(BaseCell):
    """A cell whose calls turn frames into archives. The check encodes
    every distinct input with the reference after the window; each
    call's header fields and a seeded sample of its payload bytes are
    compared, and the whole archive of a seeded sample of calls."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self.probe_u = self.rng.random(self.probe_count)

    def work(self, k: int, out) -> dict:
        return {"frames": self.F, "values": self.n,
                "itemsize": self.dtype.itemsize,
                "payload_bytes": int(out.meta.memory_size)}

    def probe(self, k: int, out):
        pay = np.frombuffer(out.payload, np.uint8)
        pos = (self.probe_u * len(pay)).astype(np.int64)
        return header_fields(out.meta), pay[pos].copy()

    def references(self) -> list:
        streams = reference.encode_streams(self.pool, self.block,
                                           self.ctx.devices[0])
        return [streams.archive(p, self.dims) for p in self.plan]

    def check(self, kept: list, probes: list, failed: list) -> int:
        """Differences from the reference: each call's header fields (one
        for any that differ) and its probed payload bytes, every byte of
        the sampled calls' archives, every byte of a call that failed."""
        refs = self.references()
        heads = [header_fields(r.meta) for r in refs]
        pays = [np.frombuffer(r.payload, np.uint8) for r in refs]
        diff = 0
        for k, (head, sample) in probes:
            j = k % self.distinct
            diff += head != heads[j]
            pos = (self.probe_u * len(pays[j])).astype(np.int64)
            diff += (int(np.count_nonzero(sample != pays[j][pos]))
                     if len(sample) == len(pos) else len(pos))
        for k, out in kept:
            diff += bytes_differing(out.to_bytes(),
                                    refs[k % self.distinct].to_bytes())
        return diff + sum(len(refs[k % self.distinct].to_bytes())
                          for k in failed)

    def control(self, k: int):
        """The reference in the program's place, on frames narrowed to the
        next narrower type (saturating), in the configuration's type."""
        top = np.iinfo(LOWER[self.dtype]).max
        x = np.minimum(self.frames_of(k), top).astype(self.dtype)
        return reference.encode(x, self.block, self.dims, self.ctx.devices[0])


class DecodeCell(BaseCell):
    """A cell whose calls turn archives, made by the reference from the
    seed's frames, back into pixels. The check compares a seeded sample
    of pixels of every call, and every pixel of a seeded sample of calls,
    with the frames."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        from trpx_tpu_torch import native

        if not native.available():
            # every header walk would run in pure Python
            raise RuntimeError("the program's native host codec did not build")
        idx = self.rng.integers(0, self.F * self.n, self.probe_count)
        self.probe_idx = idx
        # the frames' pixels at the probed places, for each distinct input
        self.probe_want = [self.pool[p[idx // self.n], idx % self.n]
                           for p in self.plan]
        with self.by_reference():
            streams = reference.encode_streams(self.pool, self.block,
                                               ctx.devices[0])
            self.archives = [streams.archive(p, self.dims) for p in self.plan]

    def want(self, k: int) -> np.ndarray:
        return self.frames_of(k).reshape(self.F, self.h, self.w)

    def work(self, k: int, out) -> dict:
        return {"frames": self.F, "values": self.n,
                "itemsize": self.dtype.itemsize,
                "payload_bytes": int(
                    self.archives[k % self.distinct].meta.memory_size)}

    def probe(self, k: int, out):
        out = np.asarray(out)
        if out.size != self.F * self.n or out.dtype != self.dtype:
            return None
        return out.reshape(-1)[self.probe_idx].copy()

    def check(self, kept: list, probes: list, failed: list) -> int:
        """Differences from the frames: each call's probed pixels, every
        pixel of the sampled calls, every pixel of a call that failed."""
        diff = 0
        for k, sample in probes:
            want = self.probe_want[k % self.distinct]
            diff += (len(want) if sample is None
                     else int(np.count_nonzero(sample != want)))
        diff += sum(pixels_differing(out, self.want(k)) for k, out in kept)
        return diff + len(failed) * self.F * self.n

    def control(self, k: int):
        """The reference in the program's place, decoding into the next
        narrower type: the format's clamp (FORMAT.md section 4) saturates
        each pixel there, returned in the configuration's type."""
        top = np.iinfo(LOWER[self.dtype]).max
        return np.minimum(self.want(k), top).astype(self.dtype)
