"""PyTorch port, counted u8 frames as a Gatan K3 in counting mode writes
them (Poisson(0.86) electrons a pixel, saved unnormalized as 8-bit),
decoded in the unpack kernels' u8 lanes: through ``api.compress`` /
``api.decompress(dtype=np.uint8)`` on the kernels' plain versions,
against the benchmark's plain reference (``portbench/reference.py``) and
the JAX package on the CPU; the plain versions' u8 lanes against their
u16 lanes narrowed; the lane rule of ``decoded_dtype``; and the bytes
``decode_dispatch`` counts for each unpack's output.

Rows of 96 u8 values keep every row start 16-byte aligned; rows of 37 x
53 (1,961 values) put row starts at odd bytes, and each frame ends inside
a block of 12. Seeded; exact.
"""

import numpy as np
import pytest
import torch

from portbench import reference
from trpx_tpu import api as japi
from trpx_tpu_torch import api
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_unpack import (
    decode_batch,
    decode_batch_plain,
    decode_batch_tiled_plain,
    decoded_dtype,
)
from trpx_tpu_torch.runtime import metrics

BLOCK = 12
#: (frames, height, width): 16-byte-aligned rows, and rows at odd bytes
SHAPES = [(3, 64, 96), (3, 37, 53)]


def _counted(shape, seed: int) -> np.ndarray:
    """(F, h, w) u8 counted frames: Poisson(0.86), a 12 and a 255 in the
    first frame, the last frame's first 40 pixels 0."""
    rng = np.random.default_rng(seed)
    fr = rng.poisson(0.86, shape).astype(np.uint8)
    flat = fr.reshape(shape[0], -1)
    flat[0, rng.integers(0, flat.shape[1], 2)] = (12, 255)
    flat[-1, :40] = 0
    return fr


def _reference(fr: np.ndarray) -> bytes:
    F, h, w = fr.shape
    return reference.encode(fr.reshape(F, -1), BLOCK, (w, h)).to_bytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_api_round_trip_equals_the_reference_and_jax(shape):
    fr = _counted(shape, seed=shape[2])
    ref = _reference(fr)
    arch = api.compress(fr, block=BLOCK, device="cpu")
    assert arch.to_bytes() == ref
    assert arch.to_bytes() == japi.compress(fr, device=True).to_bytes()
    out = api.decompress(ref, dtype=np.uint8, device="cpu")
    assert out.dtype == np.uint8 and out.shape == shape
    np.testing.assert_array_equal(out, fr)
    np.testing.assert_array_equal(
        out, japi.decompress(ref, dtype=np.uint8, device=True))
    # with no dtype the stream decodes as the prolix CLI picks: uint16
    wide = api.decompress(ref, device="cpu")
    assert wide.dtype == np.uint16
    np.testing.assert_array_equal(wide, fr)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile_blocks", [None, 1, 7, 64])
def test_plain_u8_lanes_equal_the_u16_lanes_narrowed(shape, tile_blocks):
    fr = _counted(shape, seed=shape[1] + 1)
    F = shape[0]
    n = fr[0].size
    spec = tcoding.FrameSpec.for_dtype(n, np.uint8, BLOCK)
    wide = tcoding.FrameSpec.for_dtype(n, np.uint16, BLOCK)
    widths, words = tcoding.walk_archive(
        api._as_archive(_reference(fr)), spec)
    wo = torch.from_numpy(words.view(np.int32))
    wd = torch.from_numpy(widths)
    for u8, u16 in (
            (decode_batch_plain(spec, wo, wd, torch.uint8),
             decode_batch_plain(wide, wo, wd, torch.uint16)),
            (decode_batch_tiled_plain(spec, wo, wd, torch.uint8, tile_blocks),
             decode_batch_tiled_plain(wide, wo, wd, torch.uint16,
                                      tile_blocks))):
        assert u8.dtype == torch.uint8 and u8.shape == (F, n)
        np.testing.assert_array_equal(
            u8.numpy(), tcoding.narrow_values(u16.numpy(), np.uint8))
        np.testing.assert_array_equal(u8.numpy(), fr.reshape(F, -1))


@pytest.mark.parametrize("dtype,lanes", [
    (np.uint8, torch.uint8), (np.uint16, torch.uint16),
    (np.uint32, torch.int32), (np.int8, torch.int32),
    (np.int16, torch.int32), (np.int32, torch.int32)])
def test_the_lanes_of_each_device_dtype(dtype, lanes):
    spec = tcoding.FrameSpec.for_dtype(1000, dtype)
    assert decoded_dtype(spec) is lanes


def test_int32_lanes_of_a_u8_target_still_decode():
    """The wrappers take int32 lanes for any target, u8's too, and no
    other lanes than those and ``decoded_dtype``'s."""
    fr = _counted((2, 37, 53), seed=4)
    spec = tcoding.FrameSpec.for_dtype(37 * 53, np.uint8, BLOCK)
    widths, words = tcoding.walk_archive(
        api._as_archive(_reference(fr)), spec)
    out = decode_batch_plain(spec, torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(widths), torch.int32)
    np.testing.assert_array_equal(out.numpy(), fr.reshape(2, -1))
    with pytest.raises(TypeError, match="no torch.uint16 output"):
        decode_batch(spec, torch.from_numpy(words.view(np.int32)),
                     torch.from_numpy(widths), torch.uint16)


def _delta(call) -> tuple:
    before = metrics.counters()
    out = call()
    after = metrics.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("dtype,lane_bytes", [
    (np.uint8, 1), (np.uint16, 2), (np.int16, 4), (np.uint32, 4)])
def test_the_unpack_counts_the_bytes_it_writes(dtype, lane_bytes):
    """One pixel's lane a value, whatever the caller: the synchronous
    decode, the chunked stream, the sharded decode."""
    from trpx_tpu_torch.parallel import ShardedCodec
    from trpx_tpu_torch.runtime import stream

    fr = _counted((5, 37, 53), seed=9).astype(dtype)
    n = fr[0].size
    blob = api.compress(fr, block=BLOCK, device="cpu").to_bytes()
    key = "unpack_out_bytes.trpx.decode.kernel"
    out, got = _delta(lambda: api.decompress(blob, dtype=dtype,
                                             device="cpu"))
    np.testing.assert_array_equal(out, fr)
    assert got[key] == fr.size * lane_bytes
    assert not [k for k in got if k.startswith("unpack_out_bytes.")
                and k != key]
    _, got = _delta(lambda: list(stream.iter_decode(
        api._as_archive(blob), dtype, 2, device="cpu")))
    assert got[key] == fr.size * lane_bytes
    spec = tcoding.FrameSpec.for_dtype(n, dtype, BLOCK)
    codec = ShardedCodec(spec, ["cpu", "cpu"])
    out, got = _delta(lambda: codec.decode(api._as_archive(blob), dtype))
    np.testing.assert_array_equal(out, fr.reshape(5, -1))
    assert got[key] == fr.size * lane_bytes


def test_u8_lanes_need_no_narrowing_copy():
    """A u8 decode returns its lanes as they are: the narrowing span
    counts no new array, where u16 lanes narrowed to u8 would count
    two."""
    fr = _counted((3, 37, 53), seed=11)
    blob = _reference(fr)
    out, got = _delta(lambda: api.decompress(blob, dtype=np.uint8,
                                             device="cpu"))
    np.testing.assert_array_equal(out, fr)
    assert got.get("fresh_bytes.trpx.decode.narrow", 0) == 0
    assert got.get("host_bytes.trpx.decode.narrow", 0) == 0
