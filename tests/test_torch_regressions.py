"""PyTorch port: the review regressions of tests/test_review_regressions.py
that concern code the port has, each run with ``device="cpu"`` (the
kernels' plain versions) or ``device=False`` (the native host codec) and
held to the JAX package's result, exactly.

Hostile or corrupt sidecars never reach a decode unvalidated, the header
validator accepts what the encoder emits, and the CLI refuses a bad frame
selection cleanly. Left out: the ``Terse.push_back`` dimension mismatch
(held by tests/test_torch_terse.py::test_validation_matches_jax) and
``test_iter_decode_passes_schedule_as_ratio``, which pins the JAX
decoder's capacity schedule (``_best_decoder``), a TPU structure the port
does not have.
"""

import numpy as np
import pytest

import trpx_tpu_torch
from trpx_tpu import api as japi
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.io.trpx import read_trpx as jread_trpx
from trpx_tpu.native import codec as jncodec
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.format.bitstream import BitWriter
from trpx_tpu_torch.format.pycodec import TrpxArchive
from trpx_tpu_torch.io.trpx import read_trpx, write_index, write_trpx
from trpx_tpu_torch.native import codec as ncodec

DEVICES = ("cpu", False)


@pytest.fixture()
def archive_file(tmp_path):
    rng = np.random.default_rng(5)
    stack = rng.poisson(3.0, size=(4, 40, 40)).astype(np.uint16)
    arch = trpx_tpu_torch.compress(stack, device="cpu")
    assert arch.to_bytes() == japi.compress(stack, device=True).to_bytes()
    p = tmp_path / "m.trpx"
    write_trpx(arch, p, index=True)
    return p, stack, arch


@pytest.mark.parametrize("offs", [
    [0, 2**60, 2**61, 2**62],          # way out
    [0, 10, 5, 20],                    # not monotonic
    [1, 5, 9, 13],                     # frame 0 not at 0
    None,                              # the last one at the payload's end
], ids=["out", "non-monotonic", "first-not-0", "last-at-end"])
def test_sidecar_oob_offsets_rejected(archive_file, offs):
    """Offsets outside the payload (or out of order) are discarded by the
    loader of both packages; decodes walk instead and stay exact."""
    p, stack, arch = archive_file
    if offs is None:
        offs = [0, 5, 9, arch.meta.memory_size]
    write_index(p, np.asarray(offs, np.uint64), arch.meta.memory_size)
    loaded = read_trpx(p)
    assert loaded.frame_index is None
    assert jread_trpx(p).frame_index is None
    for device in DEVICES:
        np.testing.assert_array_equal(
            tapi.decompress(read_trpx(p), device=device), stack)


def test_sidecar_corrupt_width_table_rejected(archive_file):
    """Width tables past the archive's prolix_bits are corrupt: the
    sidecar is dropped, not fed to the kernels, in both packages."""
    p, stack, arch = archive_file
    good = read_trpx(p)
    assert good.width_table is not None  # a v2 sidecar
    wt = np.asarray(good.width_table).copy()
    wt[0, 0] = arch.meta.prolix_bits + 5
    write_index(p, np.asarray(good.frame_index, np.uint64),
                arch.meta.memory_size, widths=wt)
    assert getattr(read_trpx(p), "width_table", None) is None
    assert getattr(jread_trpx(p), "width_table", None) is None
    for device in DEVICES:
        np.testing.assert_array_equal(
            tapi.decompress(read_trpx(p), device=device), stack)


def test_prolix_bits_65_roundtrips():
    """INT64_MIN blocks have signed width 65 (1 + bitlength(2**63)): the
    header validator accepts what the encoder emits (bound 73, the 12-bit
    header's maximum). 64-bit frames take the host codec by default."""
    frame = np.array([np.iinfo(np.int64).min, -3, 0, 7], dtype=np.int64)
    arch = trpx_tpu_torch.compress(frame[None])
    assert arch.meta.prolix_bits == 65
    blob = arch.to_bytes()
    assert blob == japi.compress(frame[None]).to_bytes()
    for dev in (None, False):
        out = np.asarray(tapi.decompress(blob, dtype=np.int64, device=dev))
        np.testing.assert_array_equal(out.reshape(-1), frame)


def test_hostile_sidecar_overclaiming_widths_rejected(tmp_path):
    """A lone header claiming width 57 and no payload behind it, with a
    sidecar offset: the indexed walk checks the end of the payload as the
    serial walk does, so the native decode raises instead of reading
    megabytes past the buffer, in both packages."""
    n = 1_000_000
    # header: 0 + 111 + 11 + (57 - 10 = 47 as 6 bits) -> width 57
    w = BitWriter()
    w.write(0, 1)
    w.write(7, 3)
    w.write(3, 2)
    w.write(47, 6)
    payload = w.getvalue() + b"\x00" * 14
    hdr = (f'<Terse prolix_bits="57" signed="0" block="{n}" '
           f'memory_size="{len(payload)}" number_of_values="{n}" '
           f'number_of_frames="1"/>').encode()
    p = tmp_path / "h.trpx"
    p.write_bytes(hdr + payload)
    write_index(p, np.array([0], np.uint64), len(payload))
    with pytest.raises(ValueError):
        ncodec.decode(read_trpx(p), np.uint64)
    with pytest.raises(ValueError):
        jncodec.decode(jread_trpx(p), np.uint64)
    with pytest.raises(ValueError):
        tapi.decompress(p, device=False)


def test_nonnative_endian_encode_normalized():
    """Big-endian frames encode to the bytes of their native-endian
    values (the encoder's invariant is on values); the device path
    refuses them with the JAX package's TypeError."""
    vals = np.arange(16, dtype=np.uint16)
    a_native = ncodec.encode(vals[None])
    a_be = ncodec.encode(vals.astype(">u2")[None])
    assert a_be.to_bytes() == a_native.to_bytes()
    assert trpx_tpu_torch.compress(vals.astype(">u2"),
                                   device=False).to_bytes() \
        == a_native.to_bytes()
    out = ncodec.decode(a_native, ">u2")
    np.testing.assert_array_equal(out.astype(np.uint16).reshape(-1), vals)
    with pytest.raises(TypeError) as ours:
        trpx_tpu_torch.compress(vals.astype(">u2"), device="cpu")
    with pytest.raises(TypeError) as theirs:
        japi.compress(vals.astype(">u2"), device=True)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("device", DEVICES)
def test_subset_frames_does_not_bypass_width_check(device):
    """A frames=... decode of a corrupt archive rejects it like the full
    decode (the cached-offsets walk checks width over-claims too)."""
    rng = np.random.default_rng(14)
    stack = rng.poisson(3.0, size=(3, 600)).astype(np.uint16)
    stack[1, 0] = 65535
    blob = pycodec.encode(list(stack)).to_bytes()
    tampered = blob.replace(b'prolix_bits="16"', b'prolix_bits="11"')
    assert tampered != blob
    with pytest.raises(ValueError, match="prolix_bits"):
        tapi.decompress(TrpxArchive.from_bytes(tampered), frames=[0],
                        device=device)
    with pytest.raises(ValueError, match="prolix_bits"):
        japi.decompress(tampered, frames=[0], device=device is not False)


@pytest.mark.parametrize("backend,device", [("host", None),
                                            ("device", "cpu")])
def test_stream_empty_chunk_is_a_noop(tmp_path, backend, device):
    """An empty chunk leaves the stream as it was: the finalized file and
    its sidecar are those of the frames without it, the JAX package's
    bytes."""
    from trpx_tpu_torch.runtime import StreamingEncoder

    rng = np.random.default_rng(15)
    stack = rng.poisson(3.0, size=(4, 200)).astype(np.uint16)
    dst = tmp_path / "e.trpx"
    enc = StreamingEncoder(dst, nvalues=200, dtype=np.uint16,
                           backend=backend, device=device)
    enc.add_frames(stack[:2])
    enc.add_frames(stack[:0])
    enc.add_frames(stack[2:])
    enc.finalize(verify=True, index=True)
    arch = read_trpx(dst)
    assert arch.frame_index is not None  # sidecar consistent, not stale
    assert arch.to_bytes() == jpycodec.encode(list(stack)).to_bytes()


def test_cli_bad_frames_spec_clean_error(tmp_path):
    from trpx_tpu.cli.main import prolix_main as jprolix_main
    from trpx_tpu_torch.cli.main import prolix_main

    rng = np.random.default_rng(16)
    arch = pycodec.encode([rng.poisson(3.0, 100).astype(np.uint16)])
    p = tmp_path / "c.trpx"
    write_trpx(arch, p)
    for spec in ("1:2:3:4", "abc"):
        for device in (["--host"], ["--device", "cpu"]):
            assert prolix_main([str(p), "--frames", spec, *device]) == 2
        assert jprolix_main([str(p), "--frames", spec, "--host"]) == 2
