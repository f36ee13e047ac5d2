"""PyTorch port, decode: the unpack kernel's plain version (CPU tensors)
against the JAX package and the host codecs.

Inputs are made with numpy from fixed seeds and go to both packages. The
tolerance is exact (lossless integer codec). The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from test_torch_pack import U16_CASES, _any_frames, u16_frames
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.ops import coding as jcoding
from trpx_tpu.ops import pallas_unpack
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops.cuda_unpack import (
    decode_batch,
    decode_batch_plain,
    decoded_dtype,
)


def _foreign(arch):
    """The archive as a reader of its bytes sees it: no frame index."""
    return pycodec.TrpxArchive.from_bytes(arch.to_bytes())


def _jax(arch):
    """The same bytes as an archive of the JAX package."""
    return jpycodec.TrpxArchive.from_bytes(arch.to_bytes())


@pytest.mark.parametrize("kind,n", U16_CASES)
def test_u16_decode_matches_pallas_interpret(kind, n):
    fr = u16_frames(kind, n)
    arch = ncodec.encode(fr)
    ours = tcoding.decode(_foreign(arch), np.uint16, device="cpu")
    ref = pallas_unpack.decode(_jax(arch), np.uint16, interpret=True)
    assert ours.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, fr)


def test_flagship_512_u16_decode_matches_native():
    rng = np.random.default_rng(513)
    fr = rng.poisson(3.0, (2, 512 * 512)).astype(np.uint16)
    fr[:, rng.integers(0, 512 * 512, 200)] = 65535
    arch = ncodec.encode(fr)
    np.testing.assert_array_equal(
        tcoding.decode(_foreign(arch), np.uint16, device="cpu"), fr)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint32,
                                   np.int32])
@pytest.mark.parametrize("n", [1, 13, 1001])
def test_other_dtypes_decode_losslessly(dtype, n):
    fr = _any_frames(dtype, n, seed=n + 1)
    arch = ncodec.encode(fr)
    out = tcoding.decode(_foreign(arch), dtype, device="cpu")
    assert out.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, fr)


@pytest.mark.parametrize("target", [np.int16, np.int32])
def test_unsigned_stream_into_signed_target_sign_extends(target):
    """B4: decoding into a signed target sign-extends each field, as the
    reference and the JAX package do (SURVEY §2.1)."""
    rng = np.random.default_rng(4)
    fr = rng.integers(0, 2**15, (3, 500)).astype(np.uint16)
    fr[0, :12] = [1, 3, 7, 15, 31, 0, 2, 5, 6, 12, 100, 2**14]
    arch = ncodec.encode(fr)
    ours = tcoding.decode(_foreign(arch), target, device="cpu")
    np.testing.assert_array_equal(ours, ncodec.decode(arch, target))
    np.testing.assert_array_equal(
        ours, jcoding.decode(_jax(arch), target))


def test_wide_stream_routes_to_host_codec():
    """Fields wider than the target's lanes take the host codec, which
    clamps (Bit_pointer.hpp:747-762)."""
    fr = np.array([[0, 1, 300, 70000, 5] * 5], np.uint32)
    arch = ncodec.encode(fr)
    out = tcoding.decode(_foreign(arch), np.uint16, device="cpu")
    np.testing.assert_array_equal(out, ncodec.decode(arch, np.uint16))
    assert out.max() == 65535


def _inputs(fr, dtype):
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], dtype)
    widths, words = tcoding.walk_archive(ncodec.encode(fr), spec)
    return (spec, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(widths.astype(np.uint8)))


def test_int32_output_matches_u16_output():
    spec, words, widths = _inputs(u16_frames("hot", 1000), np.uint16)
    assert decoded_dtype(spec) == torch.uint16
    u16 = decode_batch(spec, words, widths, torch.uint16)
    i32 = decode_batch(spec, words, widths, torch.int32)
    np.testing.assert_array_equal(u16.numpy().astype(np.int32), i32.numpy())


def test_inconsistent_tables_stay_inside_the_rows():
    """Widths that claim more bits than the stream holds read clamped
    words, never past a row (the kernel clamps the same way)."""
    spec, words, widths = _inputs(u16_frames("poisson", 1000), np.uint16)
    out = decode_batch_plain(spec, words, torch.full_like(widths, 33),
                             torch.int32)
    assert out.shape == (3, 1000)


def test_wrapper_checks_inputs():
    spec, words, widths = _inputs(u16_frames("poisson", 100), np.uint16)
    with pytest.raises(TypeError):
        decode_batch(spec, words.to(torch.int64), widths, torch.uint16)
    with pytest.raises(TypeError):
        decode_batch(spec, words, widths, torch.int16)
    with pytest.raises(ValueError):
        decode_batch(spec, words, widths[:, 1:], torch.uint16)
    with pytest.raises(ValueError):
        decode_batch(spec, words[:, ::2], widths, torch.uint16)
    signed = tcoding.FrameSpec.for_dtype(100, np.int16)
    with pytest.raises(TypeError):
        decode_batch(signed, words, widths, torch.uint16)
    with pytest.raises(ValueError, match="no unpack kernel"):
        decode_batch(spec, words.to("meta"), widths.to("meta"),
                     torch.uint16)
