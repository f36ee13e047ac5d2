"""The frozen reference against the program's CPU path: archives byte for
byte, pixels exact, sidecars the program takes."""

import numpy as np
import pytest
import torch

from portbench import reference

HOT = {np.uint16: 60000, np.uint32: 2_000_000_000}


def frames(dtype, F, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, (F, n)).astype(dtype)
    x[:, rng.integers(0, n, 7)] = HOT[dtype]
    x[0, :36] = 0                      # zero-width blocks
    x[-1, 12:24] = 1 << 7              # a width of 8 (the 6-bit header)
    return x


SHAPES = [(3, 144), (4, 150), (2, 1000), (1, 13)]


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("F,n", SHAPES)
def test_archive_bytes_equal_the_programs(dtype, F, n):
    from trpx_tpu_torch import ops

    x = frames(dtype, F, n, F * n)
    ref = reference.encode(x, 12)
    got = ops.encode(x, block=12, device="cpu")
    assert ref.to_bytes() == got.to_bytes()
    assert np.array_equal(ref.frame_index, got.frame_index)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_stacks_with_dimensions_equal_compress(dtype):
    import trpx_tpu_torch

    x = frames(dtype, 5, 16 * 20, 3)
    ref = reference.encode(x, 12, (20, 16))
    got = trpx_tpu_torch.compress(x.reshape(5, 16, 20), device="cpu")
    assert ref.to_bytes() == got.to_bytes()


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("F,n", SHAPES)
def test_decode_returns_the_frames_as_the_program_does(dtype, F, n):
    import trpx_tpu_torch

    x = frames(dtype, F, n, 7 + n)
    ref = reference.encode(x, 12)
    assert np.array_equal(reference.decode(ref.payload, F, n, 12, dtype), x)
    got = trpx_tpu_torch.decompress(ref.to_bytes(), device="cpu")
    assert np.array_equal(np.asarray(got).reshape(F, n), x)


def test_decode_into_a_narrower_type_clamps():
    x = frames(np.uint16, 2, 144, 1)
    ref = reference.encode(x, 12)
    got = reference.decode(ref.payload, 2, 144, 12, np.uint8)
    assert np.array_equal(got, np.minimum(x, 255))


def test_streams_of_chosen_frames_make_an_archive():
    x = frames(np.uint32, 6, 150, 2)
    s = reference.encode_streams(x, 12)
    idx = [4, 1, 1, 5, 0]
    assert (s.archive(idx, (15, 10)).to_bytes()
            == reference.encode(x[idx], 12, (15, 10)).to_bytes())


def test_passes_split_frames_alike(monkeypatch):
    x = frames(np.uint16, 7, 150, 4)
    whole = reference.encode(x, 12).to_bytes()
    monkeypatch.setattr(reference, "PASS_VALUES", 300)
    assert reference.encode(x, 12).to_bytes() == whole


def test_the_program_takes_the_reference_sidecar(tmp_path):
    from trpx_tpu_torch.io import read_trpx

    x = frames(np.uint32, 4, 1000, 9)
    ref = reference.encode(x, 12, (40, 25))
    p = tmp_path / "a.trpx"
    p.write_bytes(ref.to_bytes())
    (tmp_path / "a.trpx.idx").write_bytes(reference.sidecar_bytes(ref))
    arch = read_trpx(p)
    assert np.array_equal(arch.width_table, ref.widths)
    assert np.array_equal(arch.frame_index, ref.frame_index)


def test_signed_frames_are_refused():
    with pytest.raises(TypeError):
        reference.encode(np.zeros((1, 12), np.int16), 12)


@pytest.mark.cuda
def test_the_reference_encodes_alike_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = frames(np.uint32, 9, 4096, 5)
    assert (reference.encode(x, 12, device="cuda").to_bytes()
            == reference.encode(x, 12).to_bytes())
