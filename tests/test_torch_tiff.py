"""PyTorch port, ``io/tiff.py``: the port's copy of the greyscale TIFF
container, held against ``trpx_tpu.io.tiff`` as ``test_torch_format.py``
holds ``format/``: the source is the original's, and the written bytes
(``write_tiff``, ``TiffWriter``, classic and BigTIFF) and what is read
back (``read_tiff``, ``TiffStream``, little- and big-endian files) equal
the JAX package's. Tolerance: exact.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest

from trpx_tpu.io import tiff as jtiff
from trpx_tpu_torch.io import tiff as ttiff

REPO = Path(__file__).resolve().parent.parent
DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.float32, np.uint64, np.int64, np.float64]


def _stack(dtype, F=3, h=5, w=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 100, (F, h, w)) - (50 if np.dtype(dtype).kind
                                           in "if" else 0)
    return x.astype(dtype)


def test_source_is_the_jax_packages():
    """The copy is verbatim: its one import of the package (the native
    gather) resolves to the port's own ``native``."""
    ours = (REPO / "trpx_tpu_torch" / "io" / "tiff.py").read_text()
    assert ours == (REPO / "trpx_tpu" / "io" / "tiff.py").read_text()
    assert "from .. import native" in ours


@pytest.mark.parametrize("bigtiff", [False, True, "auto"])
@pytest.mark.parametrize("dtype", DTYPES, ids=[np.dtype(d).name
                                               for d in DTYPES])
def test_write_tiff_bytes_match_jax(dtype, bigtiff):
    x = _stack(dtype)
    for images in (x, x[0], list(x)):
        ours = ttiff.write_tiff(images, bigtiff=bigtiff)
        assert ours == jtiff.write_tiff(images, bigtiff=bigtiff)
        back = ttiff.read_tiff(ours)
        ref = jtiff.read_tiff(ours)
        assert len(back) == len(ref)
        for a, b in zip(back, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back.as_array(),
                                      np.asarray(images).reshape(-1, 5, 7))


@pytest.mark.parametrize("bigtiff", [False, True])
def test_tiff_writer_and_stream_match_jax(tmp_path, bigtiff):
    x = _stack(np.uint16, F=9, h=6, w=11, seed=3)
    bufs = []
    for mod in (ttiff, jtiff):
        buf = io.BytesIO()
        with mod.TiffWriter(buf, bigtiff=bigtiff) as w:
            w.append(x[:2])
            w.append(x[2])
            w.append(x[3:])
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    assert bufs[0] == ttiff.write_tiff(x, bigtiff=bigtiff)
    p = tmp_path / "s.tif"
    p.write_bytes(bufs[0])
    ts, js = ttiff.TiffStream(p), jtiff.TiffStream(p)
    assert (len(ts), ts.dims, ts.uniform()) == (len(js), js.dims, js.uniform())
    assert [vars(i) for i in ts.infos] == [vars(i) for i in js.infos]
    np.testing.assert_array_equal(ts.read(2, 7), js.read(2, 7))
    np.testing.assert_array_equal(
        np.concatenate(list(ts.iter_chunks(4))), x)
    ts.close()
    js.close()


def _big_endian_tiff(img: np.ndarray) -> bytes:
    """One image written big-endian ("MM"), as other writers do."""
    h, w = img.shape
    out = bytearray(b"MM" + struct.pack(">HI", 42, 0))
    data_start = len(out)
    out += img.astype(img.dtype.newbyteorder(">")).tobytes()
    struct.pack_into(">I", out, 4, len(out))
    bits = img.dtype.itemsize * 8
    fmt = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
    entries = [(0x0100, 3, w), (0x0101, 3, h), (0x0102, 3, bits),
               (0x0103, 3, 1), (0x0106, 3, 1), (0x0111, 4, data_start),
               (0x0153, 3, fmt)]
    out += struct.pack(">H", len(entries))
    for tag, t, v in entries:
        out += (struct.pack(">HHIHH", tag, t, 1, v, 0) if t == 3
                else struct.pack(">HHII", tag, t, 1, v))
    out += struct.pack(">I", 0)
    return bytes(out)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.float32])
def test_big_endian_reads_match_jax(tmp_path, dtype):
    img = _stack(dtype, F=1, h=3, w=4, seed=5)[0]
    p = tmp_path / "be.tif"
    p.write_bytes(_big_endian_tiff(img))
    a, b = ttiff.read_tiff(p)[0], jtiff.read_tiff(p)[0]
    assert a.dtype == b.dtype and a.dtype.isnative
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, img)
    ts, js = ttiff.TiffStream(p), jtiff.TiffStream(p)
    got, ref = ts.read(0, 1), js.read(0, 1)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got[0], img)
    np.testing.assert_array_equal(got, ref)
    ts.close()
    js.close()


@pytest.mark.parametrize("cut", [0, 4, 9, 40, -30, -4])
def test_malformed_files_raise_as_jax(cut):
    blob = ttiff.write_tiff(_stack(np.uint16, F=2))
    bad = blob[:cut] if cut else b"XX" + blob[2:]
    errs = []
    for mod in (ttiff, jtiff):
        with pytest.raises(mod.TiffError) as e:
            mod.read_tiff(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_mixed_stack_regularize_matches_jax():
    imgs = [np.arange(12, dtype=np.uint8).reshape(3, 4),
            np.arange(12, dtype=np.int16).reshape(3, 4) - 6]
    blob = ttiff.write_tiff(imgs)
    assert blob == jtiff.write_tiff(imgs)
    a, b = ttiff.read_tiff(blob), jtiff.read_tiff(blob)
    assert not a.uniform() and not b.uniform()
    np.testing.assert_array_equal(a.regularize().as_array(),
                                  b.regularize().as_array())
    assert ttiff.needs_bigtiff(2**32, 1) == jtiff.needs_bigtiff(2**32, 1)
