"""PyTorch port, encode: the pack kernel's plain version (CPU tensors)
against the JAX package and the host codecs.

Inputs are made with numpy from fixed seeds and go to both packages. The
tolerance is exact: TRPX is a lossless integer codec, so archives must be
byte-identical. The CUDA kernel itself is held against the plain version
in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from trpx_tpu.ops import coding as jcoding
from trpx_tpu.ops import pallas_pack
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_pack import encode_batch, encode_batch_plain

from _torch_helpers import pad_batch


def u16_frames(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Three Poisson(3) u16 frames, shaped by ``kind``."""
    rng = np.random.default_rng(seed + n)
    fr = rng.poisson(3.0, (3, n)).astype(np.uint16)
    if kind == "zero":
        fr[:] = 0
    elif kind == "hot":
        # a 65535 pixel gives width 16 and a 12-bit header
        fr[rng.integers(0, 3, 12), rng.integers(0, n, 12)] = 65535
    elif kind == "first_block_zero":
        # a zero-width first block is a bare repeat bit (SURVEY App. A, v3)
        fr[:, :12] = 0
        fr[1, :40] = 0
    return fr


U16_CASES = [
    ("poisson", 100),
    ("poisson", 1000),   # 1000 % 12 != 0: partial final block
    ("poisson", 5000),
    ("zero", 1000),
    ("hot", 1000),
    ("first_block_zero", 1000),
]


@pytest.mark.parametrize("kind,n", U16_CASES)
def test_u16_archive_matches_pallas_interpret(kind, n):
    fr = u16_frames(kind, n)
    ours = tcoding.encode(fr, device="cpu")
    ref = pallas_pack.encode(fr, interpret=True)
    assert ours.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(ours.frame_index, ref.frame_index)


@pytest.mark.parametrize("kind,n", U16_CASES)
def test_u16_archive_matches_jnp_tree(kind, n):
    fr = u16_frames(kind, n)
    ours = tcoding.encode(fr, device="cpu")
    assert ours.to_bytes() == jcoding.encode(fr).to_bytes()
    assert ours.to_bytes() == ncodec.encode(fr).to_bytes()


def test_flagship_512_u16_matches_native():
    rng = np.random.default_rng(512)
    fr = rng.poisson(3.0, (2, 512, 512)).astype(np.uint16)
    fr[:, rng.integers(0, 512, 200), rng.integers(0, 512, 200)] = 65535
    ours = tcoding.encode(fr, device="cpu")
    ref = ncodec.encode(fr.reshape(2, -1), dimensions=(512, 512))
    assert ours.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(ours.frame_index, ref.frame_index)


def _any_frames(dtype, n, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-300, 300, (3, n)).clip(info.min, info.max)
        fr = fr.astype(dtype)
        fr[0, 0] = info.min   # widest field incl. sign (33 bits for i32)
    else:
        fr = rng.poisson(3.0, (3, n)).astype(dtype)
        fr[0, -1] = info.max
    fr[1, : min(n, 30)] = 0
    return fr


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint32,
                                   np.int32])
@pytest.mark.parametrize("n", [1, 13, 1001])
def test_other_dtypes_match_host_codecs(dtype, n):
    fr = _any_frames(dtype, n, seed=n)
    ours = tcoding.encode(fr, device="cpu")
    assert ours.to_bytes() == ncodec.encode(fr).to_bytes()
    assert ours.to_bytes() == pycodec.encode(list(fr)).to_bytes()


def test_plain_words_match_jnp_encode_batch_device():
    """Word for word against the JAX jnp encoder's worst-case buffer, with
    the totals and widths beside them, on int32 frames: their sign bit is
    bit 32 of a 33-bit field."""
    import jax

    dtype = np.int32
    fr = _any_frames(dtype, 777, seed=7)
    jspec = jcoding.FrameSpec.for_dtype(777, dtype)
    padded = np.zeros((3, jspec.n_padded), dtype)
    padded[:, :777] = fr
    jw, jb, jm, _ = jax.device_get(jcoding.encode_batch_device(jspec, padded))
    spec = tcoding.FrameSpec.for_dtype(777, dtype)
    w, b, m = encode_batch_plain(spec, torch.from_numpy(padded))
    w = w.numpy().view(np.uint32)
    assert w.shape[1] >= jw.shape[1]
    np.testing.assert_array_equal(w[:, : jw.shape[1]], jw)
    assert not w[:, jw.shape[1]:].any()
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(m.numpy(), jm)


def test_terminal_byte_and_tail_are_zero():
    """Bits past each frame's total are zero, so the terminal byte of
    ``1 + bits // 8`` is clean (Terse.hpp:547)."""
    fr = u16_frames("hot", 1000)
    spec = tcoding.FrameSpec.for_dtype(1000, np.uint16)
    w, b, _ = encode_batch_plain(
        spec, torch.from_numpy(pad_batch(fr, spec)))
    w = w.numpy().view(np.uint32).astype(np.int64)
    for f in range(3):
        bits = int(b[f])
        word, phase = divmod(bits, 32)
        assert w[f, word] >> phase == 0
        assert not w[f, word + 1:].any()


def test_wrapper_checks_inputs():
    spec = tcoding.FrameSpec.for_dtype(100, np.uint16)
    good = torch.zeros((2, spec.n_padded), dtype=torch.uint16)
    with pytest.raises(TypeError):
        encode_batch(spec, good.view(torch.int16))
    with pytest.raises(ValueError):
        encode_batch(spec, good[:, :100])
    with pytest.raises(ValueError):
        encode_batch(spec, torch.zeros((spec.n_padded, 2),
                                       dtype=torch.uint16).T)
    # no fallback: a device without a pack kernel raises
    with pytest.raises(ValueError, match="no pack kernel"):
        encode_batch(spec, good.to("meta"))


def test_cpu_tensors_take_the_plain_version():
    spec = tcoding.FrameSpec.for_dtype(100, np.uint16)
    x = torch.from_numpy(pad_batch(u16_frames("hot", 100), spec))
    before = encode_batch.launches
    got = encode_batch(spec, x)
    want = encode_batch_plain(spec, x)
    assert encode_batch.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
