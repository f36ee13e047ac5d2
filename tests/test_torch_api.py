"""PyTorch port, public API: compress/decompress with device="cpu" against
``trpx_tpu.api`` with device=True, archives crossing between the packages
as bytes, the routing rules (the card by default, raising without one),
and the port's freedom from the JAX package. Inputs come from numpy seeds;
tolerance exact.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import trpx_tpu_torch
from trpx_tpu import api as japi
from trpx_tpu.io import read_trpx as jread_trpx
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.io import read_trpx, write_trpx
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.ops.cuda_pack import encode_batch
from trpx_tpu_torch.ops.cuda_unpack import decode_batch

REPO = Path(__file__).resolve().parent.parent


def _stack(shape, seed=0):
    rng = np.random.default_rng(seed)
    fr = rng.poisson(3.0, shape).astype(np.uint16)
    fr.reshape(-1)[rng.integers(0, fr.size, 8)] = 65535
    return fr


SHAPES = [(1000,), (20, 50), (3, 20, 50)]


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_matches_jax_api(shape):
    fr = _stack(shape)
    ours = trpx_tpu_torch.compress(fr, device="cpu")
    assert ours.to_bytes() == japi.compress(fr, device=True).to_bytes()
    override = trpx_tpu_torch.compress(fr, dimensions=(7, 7), device="cpu")
    assert override.meta.dimensions == (7, 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_decompress_matches_jax_api(shape):
    fr = _stack(shape, seed=1)
    blob = japi.compress(fr, device=False).to_bytes()   # host codec
    ours = trpx_tpu_torch.decompress(blob, device="cpu")
    ref = japi.decompress(blob, device=True)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    # squeeze rules: 1 frame -> (h, w) / (n,); stacks keep (F, h, w)
    np.testing.assert_array_equal(ours, fr)


@pytest.mark.parametrize("sel", [1, slice(0, 2), [2, 0], -1])
def test_frame_subset_matches_jax_api(sel):
    fr = _stack((3, 20, 50), seed=2)
    arch = ncodec.encode(fr.reshape(3, -1), dimensions=(50, 20))
    ours = trpx_tpu_torch.decompress(arch, device="cpu", frames=sel)
    ref = japi.decompress(arch.to_bytes(), device=True, frames=sel)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, fr[sel])


def test_archives_cross_between_packages(tmp_path):
    fr = _stack((3, 20, 50), seed=3)
    jax_arch = japi.compress(fr, device=True)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(jax_arch.to_bytes(), device="cpu"), fr)
    with pytest.raises(TypeError, match="to_bytes"):
        trpx_tpu_torch.decompress(jax_arch, device="cpu")
    ours = trpx_tpu_torch.compress(fr, device="cpu")
    np.testing.assert_array_equal(
        japi.decompress(ours.to_bytes(), device=True), fr)
    # a file with a v2 sidecar, written by the port and read by both
    # packages: offsets and width tables skip the walk
    path = tmp_path / "movie.trpx"
    write_trpx(ours, path, index=True)
    a, b = read_trpx(path), jread_trpx(path)
    assert a.width_table is not None
    np.testing.assert_array_equal(a.width_table, b.width_table)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(a, device="cpu"),
        japi.decompress(b, device=True))
    # the port's walk cache equals the tables the JAX package computes
    fresh = TrpxArchive.from_bytes(ours.to_bytes())
    trpx_tpu_torch.decompress(fresh, device="cpu")
    assert fresh.width_table.dtype == np.uint8
    np.testing.assert_array_equal(fresh.width_table, b.width_table)


def test_chunked_decode_of_more_than_256_frames(monkeypatch):
    """More than 256 frames decode in 256-frame chunks, through the
    pipelined ``runtime.stream.iter_decode``."""
    from trpx_tpu_torch.runtime import stream

    F = tapi._DEVICE_CHUNK_FRAMES + 44
    fr = _stack((F, 30), seed=4)
    arch = TrpxArchive.from_bytes(ncodec.encode(fr).to_bytes())
    calls = []

    def counting(spec, words, widths, device, **kw):
        calls.append(len(words))
        return tcoding.decode_dispatch(spec, words, widths, device, **kw)

    monkeypatch.setattr(stream, "decode_dispatch", counting)
    out = trpx_tpu_torch.decompress(arch, device="cpu")
    assert calls == [tapi._DEVICE_CHUNK_FRAMES, 44]
    np.testing.assert_array_equal(out, fr)


def test_routing(monkeypatch):
    fr = _stack((2, 20, 50), seed=5)

    def no_device(*a, **k):
        raise AssertionError("took the device path")

    monkeypatch.setattr(tapi.ops, "encode", no_device)
    monkeypatch.setattr(tapi.ops, "decode", no_device)
    # device=False: the host codec, for any size
    arch = trpx_tpu_torch.compress(fr, device=False)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(arch, device=False), fr)
    # what no kernel takes goes to the host codec by default, card or not
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: False)
    wide = fr.astype(np.int64)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(trpx_tpu_torch.compress(wide),
                                  dtype=np.int64), wide)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(arch, dtype=np.uint64), fr)
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: True)
    for device in (None, True, "cuda"):
        assert tapi._torch_device(device) == torch.device("cuda")
    assert tapi._torch_device("cuda:1") == torch.device("cuda:1")
    assert tapi._torch_device("cpu") == torch.device("cpu")
    assert tapi._torch_device(False) is None


#: each device dtype -> the wider dtype whose values make its streams
DEVICE_TARGETS = [(np.uint8, np.uint16), (np.int8, np.int16),
                  (np.uint16, np.uint32), (np.int16, np.int32),
                  (np.uint32, np.uint64), (np.int32, np.int64)]


@pytest.mark.parametrize("dtype,wide", DEVICE_TARGETS)
def test_a_stream_wider_than_the_lanes_takes_the_host_codec(
        dtype, wide, monkeypatch):
    """A stream whose fields fit the target's lanes (``FrameSpec.max_width``)
    takes the card by default; one a bit wider goes to the host codec with
    ``device=None``, card or not, and raises ValueError with a torch
    device."""
    spec = tcoding.FrameSpec.for_dtype(4, dtype)
    top = 2 ** (spec.max_width - 1 if spec.signed else spec.max_width)
    for bits, value in ((spec.max_width, top - 1),
                        (spec.max_width + 1, top)):
        arch = ncodec.encode(np.array([[0, 1, value, 3]], wide))
        assert arch.meta.prolix_bits == bits
        assert tapi._decode_ok(arch.meta, np.dtype(dtype)) == (
            bits == spec.max_width)
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trpx_tpu_torch.decompress(
            ncodec.encode(np.array([[0, 1, top - 1, 3]], wide)), dtype=dtype)
    np.testing.assert_array_equal(
        trpx_tpu_torch.decompress(arch, dtype=dtype),
        trpx_tpu_torch.decompress(arch, dtype=dtype, device=False))
    with pytest.raises(ValueError, match="device decode unavailable"):
        trpx_tpu_torch.decompress(arch, dtype=dtype, device="cpu")


def test_default_device_needs_a_card(monkeypatch):
    """device=None means the card: without one, compress and decompress
    raise and name both ways to the CPU; the 4 MiB host route is gone."""
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: False)
    small = _stack((2, 20, 50), seed=6)
    big = np.zeros((20, 512, 512), np.uint16)    # 10 MiB
    blob = ncodec.encode(small.reshape(2, -1)).to_bytes()
    for call in (lambda: trpx_tpu_torch.compress(small),
                 lambda: trpx_tpu_torch.compress(big),
                 lambda: trpx_tpu_torch.compress(small, device=True),
                 lambda: trpx_tpu_torch.decompress(blob),
                 lambda: trpx_tpu_torch.decompress(blob, device="cuda")):
        with pytest.raises(RuntimeError,
                           match=r"device='cpu'.*device=False"):
            call()
    assert encode_batch.launches == 0 and decode_batch.launches == 0


def test_device_decode_refuses_what_it_cannot_hold():
    arch = ncodec.encode(np.array([[1, 2, 70000]], np.uint32))
    with pytest.raises(ValueError, match="device decode unavailable"):
        trpx_tpu_torch.decompress(arch, dtype=np.uint64, device="cpu")
    with pytest.raises(TypeError, match="signed streams"):
        trpx_tpu_torch.decompress(ncodec.encode(np.array([[-1]], np.int16)),
                                  dtype=np.uint16, device="cpu")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((AssertionError, RuntimeError)):
        trpx_tpu_torch.compress(_stack((2, 8, 8)), device="cuda")
    assert encode_batch.launches == 0 and decode_batch.launches == 0


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import jax|from jax|(from|import) trpx_tpu(?!_torch)\b)",
        re.M)
    files = sorted((REPO / "trpx_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 5
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_cpu_round_trip_leaves_jax_unloaded():
    code = (
        "import sys, numpy as np, trpx_tpu_torch as t\n"
        "fr = np.random.default_rng(0).poisson(3.0, (3, 40, 30))"
        ".astype(np.uint16)\n"
        "a = t.compress(fr, device='cpu')\n"
        "assert (t.decompress(a.to_bytes(), device='cpu') == fr).all()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
