"""PyTorch port: an independent format witness, and a small BASELINE
config 4 movie (tests/test_witness_and_configs.py).

The witness decoder re-implements the ImageJ plugin's algorithm
(TRPX_Reader.java:94-150) from its published structure: a 3-byte sliding
window bit reader, the same width state machine, zero-fill, and the
frame-advance rule ``bit_start = (1 + (bit_start >> 3)) << 3``. It shares
no code with either package's codecs (this is the port's own copy of the
JAX suite's function), so it checks the port's archives from outside.
Inputs come from numpy seeds; tolerance exact.
"""

import numpy as np
import pytest

from trpx_tpu import ops as jops
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu_torch import ops
from trpx_tpu_torch.format import pycodec


def witness_decode(payload: bytes, nframes: int, nvalues: int,
                   block: int) -> np.ndarray:
    """Unsigned <=16-bit decoder in the style of TRPX_Reader.java."""
    out = np.zeros((nframes, nvalues), dtype=np.uint16)
    bit_start = 0

    def to_short(bitpos, nbits):
        # 3-byte little-endian window, LSB first (TRPX_Reader.java:142-150)
        i = bitpos >> 3
        window = 0
        for k in range(3):
            if i + k < len(payload):
                window |= payload[i + k] << (8 * k)
        return (window >> (bitpos & 7)) & ((1 << nbits) - 1)

    for f in range(nframes):
        pos = bit_start
        width = 0
        v = 0
        while v < nvalues:
            if to_short(pos, 1) == 0:  # new width (TRPX_Reader.java:118-122)
                w3 = to_short(pos + 1, 3)
                pos += 4
                if w3 == 7:
                    w3 += to_short(pos, 2)
                    pos += 2
                    if w3 == 10:
                        w3 += to_short(pos, 6)
                        pos += 6
                width = w3
            else:
                pos += 1
            count = min(block, nvalues - v)
            if width == 0:
                v += count  # zero-fill (TRPX_Reader.java:124-125)
            else:
                for _ in range(count):
                    out[f, v] = to_short(pos, width)
                    pos += width
                    v += 1
        bit_start = (1 + (pos >> 3)) << 3  # TRPX_Reader.java:130
    return out


@pytest.mark.parametrize("F,n", [(1, 24), (3, 50), (2, 16)])
def test_witness_agrees_with_the_port_encoders(F, n):
    """The JAX suite's cases: the witness reads the port's device-path
    archive (plain versions on the CPU), whose bytes are pycodec's and the
    JAX device path's."""
    rng = np.random.default_rng(F * 100 + n)
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[0, 0] = 40000
    arch = ops.encode(frames, device="cpu")
    np.testing.assert_array_equal(
        witness_decode(arch.payload, F, n, arch.meta.block), frames)
    assert arch.payload == pycodec.encode(list(frames)).payload
    assert arch.payload == jops.encode(frames).payload


def test_config_movie_stack_streamed(tmp_path):
    """A small BASELINE config 4: a movie through the port's streaming
    encoder on the plain versions, the JAX package's bytes, read by the
    witness and by ``iter_decode`` in chunks that straddle the encoder's,
    and through the TIFF layer whole and chunk by chunk (``TiffWriter``,
    ``TiffStream``)."""
    from trpx_tpu_torch.io import read_tiff, write_tiff
    from trpx_tpu_torch.io.tiff import TiffStream, TiffWriter
    from trpx_tpu_torch.io.trpx import read_trpx
    from trpx_tpu_torch.runtime import StreamingEncoder, iter_decode

    rng = np.random.default_rng(12)
    F, h, w = 60, 64, 64
    frames = rng.poisson(3.0, size=(F, h, w)).astype(np.uint16)
    frames[:, rng.integers(0, h, 4), rng.integers(0, w, 4)] = 65535
    p = tmp_path / "movie.trpx"
    enc = StreamingEncoder(p, nvalues=h * w, dtype=np.uint16,
                           dimensions=(w, h), device="cpu")
    for lo in range(0, F, 16):
        enc.add_frames(frames[lo : lo + 16].reshape(-1, h * w))
    enc.finalize(verify=True, index=True)
    arch = read_trpx(p)
    assert arch.meta.number_of_frames == F
    assert arch.to_bytes() == jpycodec.encode(
        list(frames.reshape(F, -1)), dimensions=(w, h)).to_bytes()
    np.testing.assert_array_equal(
        witness_decode(arch.payload, F, h * w, arch.meta.block),
        frames.reshape(F, -1))
    got = np.concatenate(list(iter_decode(arch, np.uint16, chunk_frames=17,
                                          device="cpu")))
    np.testing.assert_array_equal(got.reshape(F, h, w), frames)
    t = tmp_path / "movie.tif"
    write_tiff(frames, t)
    np.testing.assert_array_equal(read_tiff(t).as_array(), frames)
    s = tmp_path / "chunked.tif"
    with TiffWriter(s) as wtr:
        for lo in range(0, F, 17):
            wtr.append(got[lo : lo + 17].reshape(-1, h, w))
    assert s.read_bytes() == t.read_bytes()
    ts = TiffStream(s)
    np.testing.assert_array_equal(
        np.concatenate(list(ts.iter_chunks(16))), frames)
    ts.close()
