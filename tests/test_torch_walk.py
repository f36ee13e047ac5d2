"""PyTorch port: the header walk of one frame on the card
(``ops.cuda_walk``), through its plain version on the CPU, against the
host walk (``native.walk_chunk`` of the frame at byte 0, as
``ops.walk_chunks`` runs it), and the route of ``ops.decode`` that takes
it.

Each walk's outcome is held to the host walk's, exactly: every block's
width, the widest block and the frame's end byte, or the same ValueError
with the same message. Frames: Poisson u16, gap-masked u32 on a scaled
down module grid (``portbench.gaps``), a zero-width first block, partial
final blocks, a stream that ends on a byte boundary (a whole terminal
byte), widths 0 to 32, all-zero and all-ones frames (streams of one bits
that the walk crosses in one step), and the hostile corpus of
``test_torch_fuzz_decode.py`` rebuilt on one frame: byte flips,
truncations, a lowered ``prolix_bits``. Subsequences of 128 to 4,096 bits
force from one to tens of rounds; a walk still unsynchronised at its cap
gives no widths, and ``ops.decode`` then walks on the host with the same
pixels and no fallback warning. Seeded.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from portbench.gaps import mask
from trpx_tpu_torch import _fallback as tfallback
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch import native
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.format.spec import header_code
from trpx_tpu_torch.io.trpx import read_trpx, write_trpx
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import FrameSpec, coding, cuda_walk
from trpx_tpu_torch.ops.cuda_walk import (
    adv_table,
    check_walk,
    upload_stream,
    walk_frame,
    walk_frame_plain,
)
from trpx_tpu_torch.runtime import metrics
from trpx_tpu_torch.runtime import stream as tstream


def _host(payload: bytes, spec, prolix: int):
    """The host walk of the frame at byte 0: ("ok", widths, widest, end
    byte) or ("raise", message)."""
    try:
        rows, _, fst = native.walk_chunk(
            native.padded_buffer(payload), 0, 1, spec.n, spec.block,
            max_width=prolix)
    except ValueError as e:
        return ("raise", str(e))
    return ("ok", rows[0].astype(np.uint8), int(rows.max()), int(fst[1]))


@contextlib.contextmanager
def _walk_parts(seq_bits: int, round_cap: int | None = None):
    """A context in which the walk cuts the stream into parts of
    ``seq_bits`` bits (``cuda_walk.WALK_BITS``), capped at ``round_cap``
    rounds (``cuda_walk.WALK_ROUND_CAP``) where given."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_walk, "WALK_BITS", seq_bits)
        if round_cap is not None:
            m.setattr(cuda_walk, "WALK_ROUND_CAP", round_cap)
        yield


def _card(payload: bytes, spec, prolix: int, seq_bits: int, walk=None):
    """The plain card walk's outcome, as :func:`_host` gives it, and the
    walk (``walk``, else one in parts of ``seq_bits`` bits, or of the
    fewest doublings of them at which the rounds converge within the cap:
    they do once there are fewer parts than rounds)."""
    words = upload_stream(payload, "cpu")
    while walk is None:
        with _walk_parts(seq_bits):
            walk = walk_frame(spec, words, len(payload))
        if walk.rounds is None:
            walk, seq_bits = None, 2 * seq_bits
    try:
        check_walk(walk, spec.nb, len(payload), prolix)
    except ValueError as e:
        return ("raise", str(e)), walk
    return ("ok", walk.widths[0].numpy(), walk.wmax,
            1 + (walk.end_bit >> 3)), walk


def _same_walk(payload: bytes, spec, prolix: int, seq_bits: int,
               walk=None):
    want = _host(payload, spec, prolix)
    got, walk = _card(payload, spec, prolix, seq_bits, walk)
    assert got[0] == want[0], (got[:1], want)
    if want[0] == "raise":
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
    return walk


def _frame(kind: str, seed: int = 0) -> np.ndarray:
    """(1, n) frames of each kind of the walk tests."""
    rng = np.random.default_rng(seed)
    if kind == "u16_poisson":
        fr = rng.poisson(3.0, (1, 20000)).astype(np.uint16)
        fr[0, rng.integers(0, 20000, 40)] = 65535
        return fr
    if kind == "gapped_u32":
        gaps = dict(module_columns=2, module_rows=3, module_width=100,
                    module_height=30, gap_columns=12, gap_rows=38)
        h, w = 3 * 68 - 38, 2 * 112 - 12
        fr = rng.poisson(0.5, (h, w)).astype(np.uint32)
        fr.reshape(-1)[rng.integers(0, h * w, 60)] = 10000
        fr[mask(h, w, gaps)] = 2**32 - 1
        return fr.reshape(1, -1)
    if kind == "zero_first":
        fr = rng.poisson(2.0, (1, 6000)).astype(np.uint16)
        fr[0, :30] = 0
        return fr
    if kind == "partial_tail":
        return rng.poisson(1.0, (1, 6001)).astype(np.uint16)
    if kind == "partial_tail_of_one":
        fr = rng.poisson(1.0, (1, 6013)).astype(np.uint32)
        fr[0, -1] = 2**31 + 5
        return fr
    if kind == "widths_to_32":
        n = 12 * 33 * 4
        widths = np.arange(n // 12) % 33
        top = np.where(widths > 0, (1 << widths.astype(np.uint64)) - 1, 0)
        fr = np.repeat(top, 12).astype(np.uint32)
        fr[::7] >>= 1  # not every value at the block's width
        return fr[None]
    if kind == "all_zero":
        return np.zeros((1, 50000), np.uint16)
    if kind == "all_max":
        return np.full((1, 9000), 2**32 - 1, np.uint32)
    raise ValueError(kind)


KINDS = ["u16_poisson", "gapped_u32", "zero_first", "partial_tail",
         "partial_tail_of_one", "widths_to_32", "all_zero", "all_max"]


@pytest.mark.parametrize("seq_bits", [128, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_walk_is_the_host_walk(kind, seq_bits):
    fr = _frame(kind)
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], fr.dtype)
    walk = _same_walk(arch.payload, spec, arch.meta.prolix_bits, seq_bits)
    assert walk.headers >= spec.nb


def test_widths_reach_32_and_stream_ends_on_a_byte():
    """The frame of widths 0 to 32 takes every header form; a search over
    seeds finds streams whose end bit is a multiple of 8 (the terminal
    byte is then wholly padding), walked as the host walks them."""
    fr = _frame("widths_to_32")
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    walk = _same_walk(ncodec.encode(fr).payload, spec, 32, 512)
    assert walk.wmax == 32
    np.testing.assert_array_equal(
        walk.widths[0, :34].numpy(), np.arange(34) % 33)
    found = 0
    for seed in range(64):
        fr = np.random.default_rng(seed).poisson(1.5, (1, 997)).astype(
            np.uint16)
        arch = ncodec.encode(fr)
        spec = FrameSpec.for_dtype(997, np.uint16)
        w = _same_walk(arch.payload, spec, arch.meta.prolix_bits, 128)
        if w.end_bit % 8 == 0:
            found += 1
            assert arch.meta.memory_size == 1 + w.end_bit // 8
    assert found >= 2


def test_gaps_are_crossed_in_one_step_and_rounds_grow_as_parts_shrink():
    """The gap rows are absorbed subsequences at every size; finer parts
    take more rounds (each a part further), coarser ones fewer, the
    outcome the same."""
    fr = _frame("gapped_u32", seed=3)
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint32)
    rounds = {}
    for L in (1024, 4096, 16384):
        words = upload_stream(arch.payload, "cpu")
        st = cuda_walk._Stream(spec, words, arch.meta.memory_size, L)
        assert bool(st.absorbed.any())
        rounds[L] = _same_walk(arch.payload, spec, 32, L).rounds
    assert rounds[1024] >= rounds[4096] >= rounds[16384] >= 1
    assert rounds[1024] >= 4


def _base(seed=7, n=3000) -> TrpxArchive:
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, (1, n)).astype(np.uint16)
    fr[0, rng.integers(0, n, 20)] = 65535
    return ncodec.encode(fr)


def _hostile_payloads():
    """One-frame versions of the fuzz suite's corpus: 60 single-byte
    flips, payload truncations, and 16-byte bursts."""
    base = _base().payload
    rng = np.random.default_rng(0)
    out = []
    for _ in range(60):
        b = bytearray(base)
        b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    cuts = sorted({int(c) for c in rng.integers(0, len(base), 20)}
                  | {0, 1, len(base) - 1})
    out += [base[:c] for c in cuts]
    for _ in range(12):
        b = bytearray(base)
        i = int(rng.integers(0, len(b) - 16))
        b[i:i + 16] = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        out.append(bytes(b))
    return out


def test_hostile_payloads_raise_as_the_host_walk():
    """Flips, truncations and bursts: the same widths, end and widest
    block, or the same error with the same message; a lowered
    prolix_bits is corrupt on both walks, the walk running past the end
    still named first."""
    spec = FrameSpec.for_dtype(3000, np.uint16)
    outcomes = set()
    for payload in _hostile_payloads():
        walk = None
        for prolix in (16, 3):
            want = _host(payload, spec, prolix)
            outcomes.add(want[1][:20] if want[0] == "raise" else "ok")
            walk = _same_walk(payload, spec, prolix, 2048, walk)
    assert {"ok", "malformed TRPX paylo", "corrupt TRPX payload"} <= outcomes


def _blob_variants():
    base = _base()
    blob = base.to_bytes()
    hdr_end = blob.index(b"/>") + 2
    out = [blob]
    for payload in _hostile_payloads()[::4]:
        if len(payload) == len(base.payload):
            out.append(blob[:hdr_end] + payload)
    out.append(blob.replace(b'prolix_bits="16"', b'prolix_bits="3"'))
    return out


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return str(e)


@pytest.fixture
def card_walk(monkeypatch):
    """``ops.decode`` walks single frames of any size on the card (the
    plain walk, on the CPU), and a fallback warning is an error."""
    monkeypatch.setattr(coding, "WALK_ON_CARD_MIN_BLOCKS", 1)
    monkeypatch.setattr(tfallback, "_seen", set())
    metrics.reset_counters()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*fallback at")
        yield


def test_decompress_walked_on_the_card_is_the_host_walks(card_walk,
                                                         monkeypatch):
    """``decompress(device="cpu")`` of one-frame archives, clean and
    hostile: the card walk's pixels, errors and tables are the host
    walk's."""
    cards = []
    for blob in _blob_variants():
        got = _outcome(lambda: tapi.decompress(blob, device="cpu"))
        a = TrpxArchive.from_bytes(blob)
        _outcome(lambda: coding.decode(a, np.uint16, device="cpu"))
        cards.append((got, a))
    card_walks = metrics.counters().get("walks.card", 0)
    monkeypatch.setattr(coding, "WALK_ON_CARD_MIN_BLOCKS", 10**9)
    for blob, (got, a) in zip(_blob_variants(), cards):
        want = _outcome(lambda: tapi.decompress(blob, device="cpu"))
        b = TrpxArchive.from_bytes(blob)
        _outcome(lambda: coding.decode(b, np.uint16, device="cpu"))
        if isinstance(want, str):
            assert got == want
            assert getattr(a, "width_table", None) is None
        else:
            np.testing.assert_array_equal(got, want)
            assert a.width_table.dtype == b.width_table.dtype == np.uint8
            np.testing.assert_array_equal(a.width_table, b.width_table)
            np.testing.assert_array_equal(a.frame_index, b.frame_index)
            assert a.frame_index.dtype == b.frame_index.dtype
    assert card_walks == 2 * len(cards)
    assert metrics.counters().get("walks.card", 0) == card_walks


def _spy(monkeypatch):
    ran = []
    real = coding.walk_chunks

    def walk_chunks(*a, **k):
        ran.append("host")
        return real(*a, **k)

    monkeypatch.setattr(coding, "walk_chunks", walk_chunks)
    return ran


ROUTES = {"one_frame": True, "two_frames": False, "below_threshold": False,
          "sidecar_tables": False, "iter_decode": False,
          "host_codec": False, "wide_blocks": False}


@pytest.mark.parametrize("case", list(ROUTES))
def test_decode_walks_on_the_card_only_where_it_should(case, card_walk,
                                                       monkeypatch,
                                                       tmp_path):
    """The card walk takes an archive of one frame of at least
    ``WALK_ON_CARD_MIN_BLOCKS`` blocks that offers no tables, through
    ``ops.decode``; two frames, fewer blocks, a proven sidecar,
    ``iter_decode``, fields too wide for the kernels and blocks of more
    than ``cuda_walk.MAX_BLOCK`` values do not take it."""
    rng = np.random.default_rng(11)
    fr = rng.poisson(3.0, (2 if case == "two_frames" else 1, 4000))
    fr = fr.astype(np.uint16)
    fr[:, 5] = 60000  # fields wider than a u8 target's lanes
    arch = ncodec.encode(fr)
    if case == "wide_blocks":
        monkeypatch.setattr(cuda_walk, "MAX_BLOCK", 11)
    if case == "below_threshold":
        monkeypatch.setattr(coding, "WALK_ON_CARD_MIN_BLOCKS",
                            FrameSpec.for_dtype(4000, np.uint16).nb + 1)
    if case == "sidecar_tables":
        write_trpx(arch, tmp_path / "f.trpx", index=True)
        arch = read_trpx(tmp_path / "f.trpx")
        assert arch.width_table is not None
    ran = _spy(monkeypatch)
    if case == "iter_decode":
        monkeypatch.setattr(tstream, "walk_chunks",
                            lambda *a, **k: (ran.append("host"),
                                             coding.walk_chunks(*a, **k))[1])
        out = np.concatenate(list(tstream.iter_decode(
            arch, np.uint16, 2, device="cpu")))
    elif case == "host_codec":
        out = coding.decode(arch, np.uint8, device="cpu")
        fr = np.minimum(fr, 255).astype(np.uint8)
    else:
        out = coding.decode(arch, np.uint16, device="cpu")
    np.testing.assert_array_equal(out, fr)
    on_card = metrics.counters().get("walks.card", 0) == 1
    assert on_card == ROUTES[case]
    assert (ran == []) == (ROUTES[case] or case == "host_codec")


def test_round_cap_hands_the_frame_to_the_host_walk(card_walk, monkeypatch):
    """A walk still unsynchronised at its cap gives no widths; ``decode``
    then walks on the host: the same pixels and tables, counted in
    ``walks.unsynced``, no fallback warning."""
    fr = _frame("u16_poisson", seed=5)
    arch = ncodec.encode(fr)
    spec = FrameSpec.for_dtype(fr.shape[1], np.uint16)
    words = upload_stream(arch.payload, "cpu")
    monkeypatch.setattr(cuda_walk, "WALK_BITS", 128)
    monkeypatch.setattr(cuda_walk, "WALK_ROUND_CAP", 2)
    assert walk_frame_plain(spec, words, arch.meta.memory_size).rounds is None
    ran = _spy(monkeypatch)
    out = coding.decode(arch, np.uint16, device="cpu")
    np.testing.assert_array_equal(out, fr)
    c = metrics.counters()
    assert ran == ["host"]
    assert c.get("walks.unsynced") == 1 and "walks.card" not in c
    assert c.get("walks.sync_rounds") == 2
    assert arch.width_table.shape == (1, spec.nb)


def test_advance_table_decodes_every_header():
    """The walk's table (``build_adv_lut``'s packing) reads back every
    header the encoder writes (``format.spec.header_code``): each width
    0 to 73 behind any other, and a repeat."""
    lut = adv_table().tolist()
    for bits in range(4096):
        e = lut[bits]
        if bits & 1:
            assert e == (1 << 24) | (1 << 25)
    for w in range(74):
        value, nbits = header_code(w, w + 1)
        for hi in range(0, 4096, 1 << nbits):
            e = lut[value | hi]
            assert (e >> 16) & 255 == w and (e >> 25) == nbits
            assert not (e >> 24) & 1


def test_walk_arguments_are_checked():
    spec = FrameSpec.for_dtype(100, np.uint16)
    words = torch.zeros(cuda_walk.stream_words(50), dtype=torch.int32)
    for bits, cap in ((100, 2), (64, 2), (1024, 0),
                      (1024, cuda_walk.MAX_ROUNDS + 1)):
        with _walk_parts(bits, cap), pytest.raises(ValueError):
            walk_frame(spec, words, 50)
    with pytest.raises(ValueError):
        walk_frame(spec, words[:-1], 50)
    empty = walk_frame(spec, words, 0)
    assert empty.headers == 0
    with pytest.raises(ValueError, match="ran past end"):
        check_walk(empty, spec.nb, 0, 16)
