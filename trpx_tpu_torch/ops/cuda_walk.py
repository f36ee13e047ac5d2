"""The block-header walk of one frame on the card: the wrapper of
``csrc/walk.cu`` and its plain PyTorch version.

A TRPX frame's headers are a chain: each block's header starts where the
block before it ends. The host walks that chain one block after another
(``native``); :func:`walk_frame` walks it on the card, for a frame whose
stream starts at byte 0 of ``words`` (an archive of one frame). The
walker's whole state is (bit position, current width), so the stream's
bits are cut into subsequences of ``WALK_BITS`` bits (a power of two, at
least 128), each walked from its first bit at width 0, then again from its
predecessor's exit, round after round, until a round changes no exit:
from then on every subsequence was walked from its exact entry. A
subsequence whose bits are all ones is absorbed by the one before it,
which crosses it in one step (every header there is a repeat). Only the
number of rounds depends on the data; the rounds are capped at
``WALK_ROUND_CAP``, and a walk still unsynchronised there returns no widths, for
the host to walk the frame.

Its outcome is what the host walk of the frame gives (``native.walk_chunk``
at byte 0): the width of every block, the frame's end bit and the widest
block, and the count of headers that start inside the payload, fewer than
nb of which is the host walk's "ran past end" (:func:`check_walk` raises
as the host walk does). :func:`walk_frame` launches the kernels for a CUDA
tensor and runs :func:`walk_frame_plain`, the same rounds in PyTorch, for
a CPU tensor. :func:`upload_stream` puts an archive's payload on a device
as the words the walk and the unpack read.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build, native

#: bits of a subsequence, from a sweep on an H100 (``tools.walk_bench
#: --card``, PERF.md section 6): at 2,048-16,384 the walk of one frame of
#: 512x512 u16 to 4362x4148 u32 took 0.27-0.75 ms of device time, no size
#: best on every frame; 8,192 takes 3-10 rounds on them, within one batch
#: but for 4096x4096 u32
WALK_BITS = 8192
#: rounds after the speculative walk at most; beyond it the host walks
WALK_ROUND_CAP = 32
#: rounds launched before the host reads whether they converged
WALK_BATCH = 8
#: csrc/walk.cu: kMaxRounds, kMaxBlock (a step's advance and a part's
#: bits stay below 2^31), and the status words before round 1's count
MAX_ROUNDS = 32
MAX_BLOCK = 1 << 20
_CHANGED = 4


@dataclass
class Walk:
    """A frame's header walk: ``widths`` (1, nb) uint8 on the walk's
    device, None when the rounds did not converge within the cap
    (``rounds`` None too); ``headers``, the headers whose first bit lies
    inside the payload; ``wmax``, the widest of the blocks below nb among
    them; ``end_bit``, where block nb - 1 ends (0 unless it starts inside
    the payload); ``rounds``, the rounds after the speculative walk,
    the last of which changed nothing. Widths past ``headers`` are
    undefined."""

    widths: torch.Tensor | None
    headers: int
    wmax: int
    end_bit: int
    rounds: int | None


def stream_words(nbytes: int) -> int:
    """int32 words of a frame's device buffer: the stream and at least
    8 zero bytes past it (two zero words past the last stream word, as the
    unpack kernels read them)."""
    return -(-(nbytes + 8) // 4)


def upload_stream(payload: bytes, device) -> torch.Tensor:
    """``payload`` as the (stream_words,) int32 words of a device buffer,
    zero past the stream: for a card one pageable copy and a memset on the
    current stream (``csrc/walk.cu:trpx_walk_upload``), for the CPU a
    zero-padded copy."""
    device = torch.device(device)
    nbytes = len(payload)
    src = np.frombuffer(payload, np.uint8)
    if device.type == "cpu":
        buf = np.zeros(4 * stream_words(nbytes), np.uint8)
        buf[:nbytes] = src
        return torch.from_numpy(buf.view(np.int32))
    if device.type != "cuda":
        raise ValueError(f"no walk for device {device}")
    words = torch.empty(stream_words(nbytes), dtype=torch.int32,
                        device=device)
    dev = words.device
    rc = _build.load().trpx_walk_upload(
        words.data_ptr(), ctypes.c_void_p(src.ctypes.data), nbytes,
        4 * words.numel(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "walk upload")
    return words


def _params(spec, words, nbytes) -> tuple[int, int]:
    """The part size and the round cap, read from ``WALK_BITS`` and
    ``WALK_ROUND_CAP`` at each call, and checked with the words."""
    L, cap = int(WALK_BITS), int(WALK_ROUND_CAP)
    if L < 128 or L & (L - 1) or L > 1 << 24:
        raise ValueError(f"WALK_BITS must be a power of two in [128, 2^24], "
                         f"got {L}")
    if not 1 <= cap <= MAX_ROUNDS:
        raise ValueError(f"WALK_ROUND_CAP must be in [1, {MAX_ROUNDS}], "
                         f"got {cap}")
    if (words.dtype != torch.int32 or words.ndim != 1
            or not words.is_contiguous()
            or words.numel() < stream_words(nbytes)):
        raise ValueError(f"need (>= {stream_words(nbytes)},) contiguous "
                         f"int32 words, got {tuple(words.shape)} "
                         f"{words.dtype}")
    if nbytes < 0 or spec.n <= 0 or spec.block > MAX_BLOCK:
        raise ValueError(f"no walk of {nbytes} bytes of {spec}")
    return L, cap


def adv_table(device=None) -> torch.Tensor:
    """(4096,) int64: the host walker's advance-table entry of every 12-bit
    window (``native/host_codec.cpp:build_adv_lut``) without the advance:
    the width in bits 16..23, a repeat in bit 24, the header's bits in
    25..29."""
    b = torch.arange(4096, dtype=torch.int64, device=device)
    rep = b & 1
    wf = (b >> 1) & 7
    wf2 = wf + ((b >> 4) & 3)
    w = torch.where(wf < 7, wf,
                    torch.where(wf2 < 10, wf2, wf2 + ((b >> 6) & 63)))
    hb = torch.where(wf < 7, 4, torch.where(wf2 < 10, 6, 12))
    w = torch.where(rep == 1, 0, w)
    hb = torch.where(rep == 1, 1, hb)
    return (w << 16) | (rep << 24) | (hb << 25)


class _Stream:
    """The plain walk's view of a stream: its bits as int64 words, the
    absorbed subsequences and the kept ones' ends."""

    def __init__(self, spec, words, nbytes, L):
        dev = words.device
        self.block = spec.block
        self.nbits = 8 * nbytes
        self.L, self.lg = L, L.bit_length() - 1
        self.S = S = -(-self.nbits // L)
        self.w64 = words.to(torch.int64) & 0xFFFFFFFF
        self.lut = adv_table(dev)
        ones = torch.zeros(S, dtype=torch.bool, device=dev)
        full = self.nbits // L  # subsequences wholly inside the payload
        if full > 1:
            nw = L // 32
            ones[1:full] = (words[nw:full * nw].view(full - 1, nw)
                            == -1).all(1)
        self.absorbed = ones
        self.kept = torch.nonzero(~ones).flatten()
        nxt = torch.cat([self.kept[1:],
                         torch.tensor([S], dtype=torch.int64, device=dev)])
        self.end = torch.clamp(nxt * L, max=self.nbits)

    def run(self, p, w, E, record=None):
        """Walks each (p, w) to the first header at or past E; returns the
        exits and the header counts. ``record(i, p, w, hb, k, d)`` is given
        every header passed: the walks ``i`` it belongs to, its position,
        width and header bits, and for k > 1 a run of k repeats d bits
        apart."""
        p, w = p.clone(), w.clone()
        cnt = torch.zeros_like(p)
        live = p < E
        last = self.w64.numel() - 2
        while bool(live.any()):
            u = (p >> self.lg).clamp(max=self.S - 1)
            jump = live & self.absorbed[u]
            d = 1 + w * self.block
            k = torch.where(jump, (E - p + d - 1) // d, 0)
            if record is not None and bool(jump.any()):
                i = torch.nonzero(jump).flatten()
                record(i, p[i], w[i], torch.ones_like(i), k[i], d[i])
            p = p + k * d
            cnt = cnt + k
            step = live & ~jump
            i = (p >> 5).clamp(0, last)
            s = p & 31
            v = ((self.w64[i] >> s) | (self.w64[i + 1] << (32 - s))) \
                & 0xFFFFFFFF
            # zero-width repeats, one bit each: a run of them at once
            zr = step & (w == 0) & ((v & 1) == 1)
            if bool(zr.any()):
                ones = torch.log2(((~v) & (v + 1)).double()).long()
                n = torch.where(zr, torch.minimum(ones, E - p), 0)
                if record is not None:
                    i = torch.nonzero(zr).flatten()
                    one = torch.ones_like(i)
                    record(i, p[i], w[i], one, n[i], one)
                p = p + n
                cnt = cnt + n
                step = step & ~zr
            v = v & 0xFFF
            e = self.lut[v]
            w = torch.where(step & (((e >> 24) & 1) == 0), (e >> 16) & 255, w)
            hb = e >> 25
            if record is not None:
                i = torch.nonzero(step).flatten()
                record(i, p[i], w[i], hb[i], torch.ones_like(i), None)
            p = torch.where(step, p + hb + w * self.block, p)
            cnt = cnt + step
            live = p < E
        return p, w, cnt


def walk_frame_plain(spec, words: torch.Tensor, nbytes: int) -> Walk:
    """Plain PyTorch walk on the words' device: the subsequences, rounds
    and outcome of the kernels of ``csrc/walk.cu``, whose reference it
    is."""
    L, cap = _params(spec, words, nbytes)
    dev = words.device
    nb = spec.nb
    if nbytes == 0:
        return Walk(torch.zeros((1, nb), dtype=torch.uint8, device=dev),
                    0, 0, 0, 1)
    st = _Stream(spec, words, nbytes, L)
    kept, E = st.kept, st.end
    used_p = kept * L
    used_w = torch.zeros_like(used_p)
    last_p, last_w, cnt = st.run(used_p, used_w, E)
    rounds = None
    for r in range(1, cap + 1):
        # Jacobi: every entry from the exits of the round before
        ep = torch.cat([used_p[:1] * 0, last_p[:-1]])
        ew = torch.cat([used_w[:1] * 0, last_w[:-1]])
        redo = (ep != used_p) | (ew != used_w)
        changed = 0
        if bool(redo.any()):
            i = torch.nonzero(redo).flatten()
            p, w, c = st.run(ep[i], ew[i], E[i])
            moved = (p != last_p[i]) | (w != last_w[i])
            changed = int(moved.sum())
            used_p[i], used_w[i], cnt[i] = ep[i], ew[i], c
            last_p[i], last_w[i] = p, w
        if changed == 0:
            rounds = r
            break
    if rounds is None:
        return Walk(None, 0, 0, 0, None)
    base = torch.cumsum(cnt, 0) - cnt
    widths = torch.zeros(nb, dtype=torch.uint8, device=dev)
    tail = spec.n - (nb - 1) * spec.block
    emitted = torch.zeros_like(base)
    out = {"wmax": 0, "end": 0}

    def record(i, p, w, hb, k, d):
        b = base[i] + emitted[i]
        emitted[i] += k
        keep = b < nb
        if not bool(keep.any()):
            return
        i, p, w, hb = i[keep], p[keep], w[keep], hb[keep]
        k, b = k[keep], b[keep]
        k = torch.minimum(k, nb - b)
        out["wmax"] = max(out["wmax"], int(w.max()))
        if d is None:
            widths[b] = w.to(torch.uint8)
        else:
            for bj, kj, wj in zip(b.tolist(), k.tolist(), w.tolist()):
                widths[bj: bj + kj] = wj
        at = torch.nonzero(b + k == nb).flatten()
        if at.numel():
            j = int(at[0])
            step = 0 if d is None else int(k[j] - 1) * int(d[keep][j])
            out["end"] = (int(p[j]) + step + int(hb[j])
                          + int(w[j]) * tail)

    st.run(used_p, used_w, E, record)
    return Walk(widths[None], int(cnt.sum()), out["wmax"], out["end"],
                rounds)


def walk_frame(spec, words: torch.Tensor, nbytes: int) -> Walk:
    """Walk the headers of the one frame of ``spec`` whose ``nbytes``-byte
    stream is ``words`` (:func:`stream_words` int32 words, zero past the
    stream): the CUDA kernels of ``csrc/walk.cu`` for a CUDA tensor, in
    batches of ``WALK_BATCH`` rounds, each batch followed by one small
    copy of the status to the host, until a round changes nothing or the
    cap is reached; :func:`walk_frame_plain` for a CPU tensor. Counts one
    launch a batch in ``walk_frame.launches``."""
    L, cap = _params(spec, words, nbytes)
    if words.device.type == "cpu" or nbytes == 0:
        return walk_frame_plain(spec, words, nbytes)
    if words.device.type != "cuda":
        raise ValueError(f"no walk kernel for device {words.device}")
    lib = _build.load()
    dev = words.device
    lg = L.bit_length() - 1
    nscratch = lib.trpx_walk_scratch_bytes(nbytes, lg)
    if nscratch < 0:
        raise ValueError(f"no walk of {nbytes} bytes in {L}-bit parts")
    scratch = torch.empty(nscratch, dtype=torch.uint8, device=dev)
    widths = torch.empty((1, spec.nb), dtype=torch.uint8, device=dev)
    status = scratch[: 8 * (_CHANGED + MAX_ROUNDS + 1)].view(torch.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    done, rounds = 0, None
    while rounds is None and done < cap:
        k = min(WALK_BATCH, cap - done)
        rc = lib.trpx_walk_frame(
            words.data_ptr(), nbytes, spec.n, spec.block, lg, done + 1,
            done + k, scratch.data_ptr(), nscratch, widths.data_ptr(),
            dev.index, stream)
        _build.check(rc, "walk")
        _build.count_launch(walk_frame)
        done += k
        head = status[: _CHANGED + done + 1].tolist()
        changed = head[_CHANGED + 1:]
        if 0 in changed:
            rounds = changed.index(0) + 1
    if rounds is None:
        return Walk(None, 0, 0, 0, None)
    return Walk(widths, head[0], head[1], head[2], rounds)


walk_frame.launches = 0


def check_walk(walk: Walk, nb: int, nbytes: int, prolix_bits: int) -> None:
    """Raise as the host walk of the frame raises (``native._check_width``,
    the same messages and precedence): fewer than ``nb`` headers inside
    the payload, or an end byte past it, ran past the end; else a block
    wider than ``prolix_bits`` is corrupt."""
    if walk.headers < nb or 1 + (walk.end_bit >> 3) > nbytes:
        native._check_width(-1, prolix_bits)
    native._check_width(walk.wmax, prolix_bits)
