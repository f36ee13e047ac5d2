"""PyTorch port, ``Terse`` adapter against ``trpx_tpu.Terse`` on the same
numpy-seeded frames: serialized bytes, every ``prolix(i)``, the metadata
accessors, appends after ``from_stream`` and the validation errors. The
port runs on ``device="cpu"`` (the kernels' plain versions) and on the
host codec; its default, the card, raises here. Tolerance: exact (lossless
codec).
"""

import functools
import io

import numpy as np
import pytest

import trpx_tpu
import trpx_tpu_torch
from trpx_tpu.format import pycodec
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch import ops as tops

DEVICES = ["cpu", False]


def _stack(F, h, w, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-400, 400, (F, h, w)).clip(info.min, info.max)
    else:
        fr = rng.poisson(3.0, (F, h, w))
    fr = fr.astype(dtype)
    fr[0, 0, 0] = info.max
    return fr


def _written(t) -> bytes:
    buf = io.BytesIO()
    t.write(buf)
    return buf.getvalue()


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.uint8])
def test_push_back_write_prolix_match_jax(device, dtype):
    fr = _stack(5, 12, 20, dtype, seed=np.dtype(dtype).itemsize)
    ours = trpx_tpu_torch.Terse(device=device)
    ref = trpx_tpu.Terse()
    for t in (ours, ref):
        t.push_back(fr[0])          # one image
        t.push_back(fr[1:4])        # a stack
        t.push_back(fr[4])
    for name in ("number_of_frames", "size", "is_signed", "bits_per_val",
                 "terse_size", "block"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.dim() == ref.dim() == (20, 12)
    blob = _written(ours)
    assert blob == _written(ref)
    assert blob == pycodec.encode(list(fr.reshape(5, -1)),
                                  dimensions=(20, 12)).to_bytes()
    for i in range(5):
        got = ours.prolix(i)
        np.testing.assert_array_equal(got, ref.prolix(i))
        np.testing.assert_array_equal(got, fr[i])


@pytest.mark.parametrize("device", DEVICES)
def test_from_stream_then_append(device):
    first = _stack(3, 16, 16, seed=1)
    more = _stack(2, 16, 16, seed=2)
    more[1, 3, 3] = 41000
    blob = _written(trpx_tpu.Terse(first))
    ours = trpx_tpu_torch.Terse.from_stream(blob, device=device)
    ref = trpx_tpu.Terse.from_stream(blob)
    assert ours.number_of_frames == 3 and ours.dim() == (16, 16)
    for t in (ours, ref):
        t.push_back(more)
    assert ours.number_of_frames == ref.number_of_frames == 5
    out = _written(ours)
    assert out == _written(ref)
    allf = np.concatenate([first, more])
    assert out == pycodec.encode(list(allf.reshape(5, -1)),
                                 dimensions=(16, 16)).to_bytes()
    for i in range(5):
        np.testing.assert_array_equal(ours.prolix(i), allf[i])


def test_device_dtypes_encode_through_ops(monkeypatch):
    calls = []
    real = tops.encode

    def spy(stack, **kw):
        calls.append((stack.shape, str(kw["device"])))
        return real(stack, **kw)

    monkeypatch.setattr(tops, "encode", spy)
    fr = _stack(2, 8, 8, seed=3)
    t = trpx_tpu_torch.Terse(fr, device="cpu")
    assert t.terse_size == trpx_tpu.Terse(fr).terse_size
    assert calls == [((2, 64), "cpu")]
    # 64-bit frames and device=False take the host codec
    calls.clear()
    trpx_tpu_torch.Terse(fr.astype(np.int64), device="cpu").terse_size
    trpx_tpu_torch.Terse(fr, device=False).terse_size
    assert calls == []


def test_float_frames_truncate_like_jax():
    fr = np.array([[1.9, -2.7, 300.2]])
    assert _written(trpx_tpu_torch.Terse(fr, device="cpu")) == \
        _written(trpx_tpu.Terse(fr))


@pytest.mark.parametrize("bad,err", [
    (np.arange(11, dtype=np.uint16), ValueError),        # frame size
    (np.arange(10, dtype=np.int16), ValueError),         # signedness
    (np.arange(10, dtype=np.uint16).reshape(5, 2), ValueError),  # dims
    (np.zeros((1, 1, 1, 10), np.uint16), ValueError),    # 4-D
    (np.array(["x"] * 10), TypeError),                   # not integral
])
def test_validation_matches_jax(bad, err):
    for cls in (functools.partial(trpx_tpu_torch.Terse, device=False),
                trpx_tpu.Terse):
        t = cls(np.arange(10, dtype=np.uint16).reshape(2, 5))
        with pytest.raises(err):
            t.push_back(bad)
        assert t.number_of_frames == 1


def test_empty_and_out_of_range():
    for cls in (functools.partial(trpx_tpu_torch.Terse, device=False),
                trpx_tpu.Terse):
        with pytest.raises(ValueError, match="empty"):
            cls().prolix()
        t = cls(np.arange(10, dtype=np.uint16))
        with pytest.raises(IndexError):
            t.prolix(1)
        with pytest.raises(IndexError):
            t.prolix(-1)
        assert cls(np.arange(-500, 500, dtype=np.int32)).is_signed


def test_default_device_needs_a_card(monkeypatch):
    """Terse(device=None) encodes and decodes on the card: without one,
    the first encode and from_stream's prolix raise, naming the CPU ways;
    64-bit frames still take the host codec."""
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: False)
    fr = _stack(2, 8, 8, seed=4)
    t = trpx_tpu_torch.Terse(fr)
    assert t.number_of_frames == 2          # pushing needs no device
    with pytest.raises(RuntimeError, match=r"device='cpu'.*device=False"):
        t.terse_size
    blob = _written(trpx_tpu.Terse(fr))
    with pytest.raises(RuntimeError, match="device=False"):
        trpx_tpu_torch.Terse.from_stream(blob).prolix(1)
    wide = trpx_tpu_torch.Terse(fr.astype(np.int64))
    assert _written(wide) == _written(trpx_tpu.Terse(fr.astype(np.int64)))
