"""PyTorch port, gap-masked u32 images (a multi-module detector writes
every pixel between its modules as 2^32 - 1) against the benchmark's plain
reference encoder (``portbench/reference.py``, nothing of the program),
through ``api.compress`` / ``api.decompress`` on the kernels' plain
versions and through the tiled wrappers called directly, which routing
sends only frames of millions of values; and the route counters
(``frames.<wrapper>``) that ``ops.coding`` keeps for every caller.

The grid is the EIGER2 X 16M's scaled down: 2 x 2 modules of 40 x 24
pixels with its gaps of 12 columns and 38 rows, so 92 x 86 pixels. A row
of 92 values ends inside a block of 12, so blocks straddle the rows' ends,
the gap rows' too; the first and last pixels are masked as well, so
32-bit fields open and close each frame. Seeded; exact.
"""

import numpy as np
import pytest
import torch

from portbench import reference
from trpx_tpu_torch import api
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_pack import encode_batch_tiled
from trpx_tpu_torch.ops.cuda_unpack import decode_batch_tiled
from trpx_tpu_torch.runtime import metrics
from trpx_tpu_torch.runtime import stream

FILL = np.uint32(2**32 - 1)
H, W = 2 * 24 + 38, 2 * 40 + 12
BLOCK = 12


def _mask() -> np.ndarray:
    cols = np.arange(W) % (40 + 12) >= 40
    rows = np.arange(H) % (24 + 38) >= 24
    return rows[:, None] | cols[None, :]


def _images(F: int, seed: int = 0) -> np.ndarray:
    """(F, H, W) u32: Poisson(0.5), a few spots at 10,000, the gaps, the
    first and the last pixel at 2^32 - 1."""
    rng = np.random.default_rng(seed)
    fr = rng.poisson(0.5, (F, H, W)).astype(np.uint32)
    fr.reshape(F, -1)[:, rng.integers(0, H * W, 5)] = 10000
    fr[:, _mask()] = FILL
    fr[:, 0, 0] = fr[:, -1, -1] = FILL
    return fr


def _reference(fr: np.ndarray) -> bytes:
    return reference.encode(fr.reshape(len(fr), -1), BLOCK, (W, H)).to_bytes()


def test_the_grid_straddles_blocks_and_rows():
    m = _mask()
    assert m.sum() == 12 * H + 38 * W - 12 * 38
    assert W % BLOCK and (H * W) % BLOCK     # rows and the frame end mid-block
    fr = _images(1)
    assert fr[0, 0, 0] == fr[0, -1, -1] == FILL


@pytest.mark.parametrize("F", [1, 3])
def test_api_round_trip_equals_the_reference(F):
    fr = _images(F, seed=F)
    arch = api.compress(fr[0] if F == 1 else fr, block=BLOCK, device="cpu")
    assert arch.meta.prolix_bits == 32
    assert arch.to_bytes() == _reference(fr)
    out = api.decompress(_reference(fr), device="cpu")
    # one image comes back as (h, w), a stack as (F, h, w)
    assert out.shape == ((H, W) if F == 1 else (F, H, W))
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out.reshape(fr.shape), fr)


@pytest.mark.parametrize("tile_blocks", [None, 1, 7, 64])
@pytest.mark.parametrize("F", [1, 3])
def test_tiled_wrappers_equal_the_reference(F, tile_blocks):
    fr = _images(F, seed=10 + F).reshape(F, -1)
    spec = tcoding.FrameSpec.for_dtype(H * W, np.uint32, BLOCK)
    x = torch.zeros((F, spec.n_padded), dtype=torch.uint32)
    x[:, :spec.n] = torch.from_numpy(fr)
    words, bits, maxw = encode_batch_tiled(spec, x, tile_blocks)
    used = -(-(1 + int(bits.max()) // 8) // 4)
    arch = tcoding.assemble_archive(
        spec, words[:, :used].numpy().view(np.uint32), bits.numpy(),
        maxw.numpy(), (W, H))
    assert arch.to_bytes() == _reference(fr)
    widths, w = tcoding.walk_archive(api._as_archive(_reference(fr)), spec)
    out = decode_batch_tiled(spec, torch.from_numpy(w.view(np.int32)),
                             torch.from_numpy(widths.astype(np.uint8)),
                             torch.int32, tile_blocks)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), fr)


def _frames_counted(call) -> dict:
    """``call()``'s change of the ``frames.*`` counters."""
    before = metrics.counters()
    call()
    after = metrics.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("frames.") and v != before.get(k, 0)}


def test_encodes_count_their_frames_by_route(monkeypatch):
    spec = tcoding.FrameSpec.for_dtype(H * W, np.uint32, BLOCK)
    # frames of this size count as big, so the CPU's plain versions stay
    # quick: fewer than TILED_PACK_MAX_FRAMES of them take the tiled pack
    monkeypatch.setattr(tcoding, "TILED_MIN_BLOCKS", spec.nb)
    small = tcoding.TILED_PACK_MAX_FRAMES - 1
    for F, route in ((1, "encode_batch_tiled"), (small, "encode_batch_tiled"),
                     (small + 1, "encode_batch")):
        fr = _images(F, seed=F)
        got = _frames_counted(
            lambda: api.compress(fr, block=BLOCK, device="cpu"))
        assert got == {"frames." + route: F}
    monkeypatch.setattr(tcoding, "TILED_MIN_BLOCKS", spec.nb + 1)
    assert _frames_counted(lambda: api.compress(
        _images(1), block=BLOCK, device="cpu")) == {"frames.encode_batch": 1}


def test_decodes_count_their_frames_by_route(monkeypatch):
    monkeypatch.setattr(tcoding, "TILED_MAX_FRAMES", 4)
    for F, route in ((1, "decode_batch_tiled"), (3, "decode_batch_tiled"),
                     (4, "decode_batch"), (9, "decode_batch")):
        blob = _reference(_images(F, seed=F))
        got = _frames_counted(lambda: api.decompress(blob, device="cpu"))
        assert got == {"frames." + route: F}


def test_a_streamed_decode_counts_each_chunk(monkeypatch):
    monkeypatch.setattr(tcoding, "TILED_MAX_FRAMES", 4)
    fr = _images(10, seed=3)
    blob = _reference(fr)
    out = []
    got = _frames_counted(lambda: out.extend(stream.iter_decode(
        api._as_archive(blob), np.uint32, 4, device="cpu")))
    # chunks of 4, 4 and 2 frames
    assert got == {"frames.decode_batch": 8, "frames.decode_batch_tiled": 2}
    np.testing.assert_array_equal(np.concatenate(out), fr.reshape(10, -1))
