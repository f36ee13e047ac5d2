"""PyTorch port, runtime layer: ``StreamingEncoder``, ``iter_decode`` and
the metrics against ``trpx_tpu.runtime`` on the same numpy-seeded inputs.
The port runs on ``device="cpu"`` (the kernels' plain versions), the JAX
package on its CPU backend. Tolerance: exact (lossless codec): file bytes,
manifests, sidecars and pixels must be equal.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import trpx_tpu_torch
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.runtime import RunReport as JRunReport
from trpx_tpu.runtime import StageTimer as JStageTimer
from trpx_tpu.runtime import StreamingEncoder as JStreamingEncoder
from trpx_tpu.runtime import iter_decode as jiter_decode
from trpx_tpu_torch import api as tapi
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.io.trpx import (
    _compute_offsets,
    read_index_full,
    read_trpx,
    write_trpx,
)
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.runtime import (
    RunReport,
    StageTimer,
    StreamingEncoder,
    iter_decode,
)
from trpx_tpu_torch.runtime import metrics as tmetrics
from trpx_tpu_torch.runtime import stream as tstream

from test_torch_coding import (  # noqa: F401 (a fixture)
    fallback_warnings,
    fresh_fallbacks,
    rejected_sidecar,
)

REPO = Path(__file__).resolve().parent.parent


def _frames(F, n, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if info.min < 0:
        fr = rng.integers(-300, 300, (F, n)).clip(info.min, info.max)
        fr = fr.astype(dtype)
        fr[0, 0] = info.min
    else:
        fr = rng.poisson(3.0, (F, n)).astype(dtype)
        fr[rng.integers(0, F, 5), rng.integers(0, n, 5)] = info.max
    fr[-1, : min(n, 30)] = 0
    return fr


def _port(path, n, dtype, **kw):
    kw.setdefault("device", "cpu")
    return StreamingEncoder(path, nvalues=n, dtype=dtype, **kw)


def _state(path: Path):
    """The stream's on-disk state: manifest JSON, .part and .part.idx."""
    return (json.loads(Path(f"{path}.manifest").read_text()),
            Path(f"{path}.part").read_bytes(),
            Path(f"{path}.part.idx").read_bytes())


# ------------------------------------------------------- stream encode ---


@pytest.mark.parametrize("backend,dtype,n", [
    ("device", np.uint16, 50), ("device", np.int16, 97),
    ("host", np.uint16, 1000), ("host", np.int32, 333)])
def test_stream_bytes_and_manifests_match_jax(tmp_path, backend, dtype, n):
    """Uneven chunks: the on-disk state after every flush, the finalized
    file and its sidecar equal the JAX encoder's and pycodec's."""
    fr = _frames(23, n, dtype, seed=n)
    ours = _port(tmp_path / "t.trpx", n, dtype, dimensions=(n, 1),
                 backend=backend)
    ref = JStreamingEncoder(tmp_path / "j.trpx", nvalues=n, dtype=dtype,
                            dimensions=(n, 1), backend=backend)
    for lo in range(0, 23, 7):
        ours.add_frames(fr[lo : lo + 7])
        ref.add_frames(fr[lo : lo + 7])
        ours.flush()
        ref.flush()
        assert _state(tmp_path / "t.trpx") == _state(tmp_path / "j.trpx")
    ours.finalize(verify=True, index=True)
    ref.finalize(verify=True, index=True)
    want = pycodec.encode(list(fr), dimensions=(n, 1)).to_bytes()
    assert (tmp_path / "t.trpx").read_bytes() == want
    assert (tmp_path / "j.trpx").read_bytes() == want
    assert (tmp_path / "t.trpx.idx").read_bytes() == \
        (tmp_path / "j.trpx.idx").read_bytes()
    for suffix in (".part", ".part.idx", ".manifest"):
        assert not (tmp_path / f"t.trpx{suffix}").exists()


def test_stream_join_of_untiled_and_tiled_chunks(tmp_path, monkeypatch):
    """Every chunk of a stream encode takes the one-pass pack; its decode
    in chunks of 7 takes the one-pass unpack for the full chunks and the
    tiled one (here with 4-block tiles) for the partial last chunk. The
    file and the pixels are still exact."""
    monkeypatch.setattr(tcoding, "TILED_MAX_FRAMES", 4)
    calls = []

    def spy(fn, tile_blocks=None):
        def wrapped(spec, *args):
            calls.append((fn.__name__, len(args[0])))
            return fn(spec, *args, *(() if tile_blocks is None
                                     else (tile_blocks,)))
        return wrapped

    for name in ("encode_batch", "encode_batch_tiled", "decode_batch"):
        monkeypatch.setattr(tcoding, name, spy(getattr(tcoding, name)))
    monkeypatch.setattr(tcoding, "decode_batch_tiled",
                        spy(tcoding.decode_batch_tiled, 4))
    fr = _frames(17, 200, seed=3)
    fr.setflags(write=False)      # staging only reads the frames
    path = tmp_path / "j.trpx"
    enc = _port(path, 200, np.uint16)
    for lo in range(0, 17, 7):
        enc.add_frames(fr[lo : lo + 7])
    enc.finalize(verify=True)
    assert calls == [("encode_batch", 7), ("encode_batch", 7),
                     ("encode_batch", 3)]
    assert path.read_bytes() == pycodec.encode(list(fr)).to_bytes()
    calls.clear()
    got = np.concatenate(list(iter_decode(path, np.uint16, 7,
                                          device="cpu")))
    np.testing.assert_array_equal(got, fr)
    assert calls == [("decode_batch", 7), ("decode_batch", 7),
                     ("decode_batch_tiled", 3)]


def _resume_case(tmp_path, case, fr):
    """Leave a stream in state `case` after chunks of 4 frames; returns the
    frame the resumed run restarts from, or the exception it must raise."""
    p = tmp_path / "r.trpx"
    enc = _port(p, fr.shape[1], fr.dtype)
    enc.add_frames(fr[:4])
    if case == "lost in flight":
        enc.add_frames(fr[4:8])   # writes chunk 1; chunk 2 is in flight
        del enc
        return 4
    enc.flush()
    del enc
    if case == "torn tail":
        with open(f"{p}.part", "ab") as f:
            f.write(b"\xff" * 17)
        with open(f"{p}.part.idx", "ab") as f:
            f.write(b"\x01" * 5)
        return 4
    if case == "missing part":
        Path(f"{p}.part").unlink()
        return FileNotFoundError
    if case == "short part":
        with open(f"{p}.part", "r+b") as f:
            f.truncate(3)
        return FileNotFoundError
    return ValueError             # config mismatch


@pytest.mark.parametrize("case", ["lost in flight", "torn tail",
                                  "missing part", "short part",
                                  "config mismatch"])
def test_stream_resume(tmp_path, case):
    fr = _frames(11, 60, seed=5)
    want = _resume_case(tmp_path, case, fr)
    p = tmp_path / "r.trpx"
    if not isinstance(want, int):
        n = 61 if case == "config mismatch" else 60
        with pytest.raises(want):
            _port(p, n, np.uint16)
        return
    enc = _port(p, 60, np.uint16)
    assert enc.frames_done == want
    enc.add_frames(fr[want:])
    enc.finalize(verify=True)
    assert p.read_bytes() == pycodec.encode(list(fr)).to_bytes()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cross_package_resume(tmp_path, first):
    """A run begun by one package and finished by the other gives the
    same file as a whole-stack encode."""
    fr = _frames(13, 80, seed=7)
    p = tmp_path / "x.trpx"

    def jax_enc():
        return JStreamingEncoder(p, nvalues=80, dtype=np.uint16)

    def port_enc():
        return _port(p, 80, np.uint16)

    start, finish = ((jax_enc, port_enc) if first == "jax"
                     else (port_enc, jax_enc))
    enc = start()
    enc.add_frames(fr[:5])
    enc.add_frames(fr[5:9])
    enc.add_frames(fr[9:11])      # in flight: lost
    del enc
    enc = finish()
    assert enc.frames_done == 9
    enc.add_frames(fr[9:])
    enc.finalize(verify=True, index=True)
    assert p.read_bytes() == pycodec.encode(list(fr)).to_bytes()
    offs, wt = read_index_full(p, 13, read_trpx(p).meta.memory_size)
    offs_ref, wt_ref = _compute_offsets(pycodec.encode(list(fr)))
    np.testing.assert_array_equal(offs, offs_ref)
    np.testing.assert_array_equal(wt, wt_ref)


def test_finalize_sidecar_equals_computed_offsets(tmp_path):
    fr = _frames(9, 500, seed=8)
    enc = _port(tmp_path / "s.trpx", 500, np.uint16)
    enc.add_frames(fr[:5])
    enc.add_frames(fr[5:])
    enc.finalize(verify=True, index=True)
    arch = read_trpx(tmp_path / "s.trpx")
    offs_ref, wt_ref = _compute_offsets(ncodec.encode(fr))
    np.testing.assert_array_equal(arch.frame_index, offs_ref)
    np.testing.assert_array_equal(arch.width_table, wt_ref)


def test_finalize_rejects_corrupt_state_before_publishing(tmp_path):
    fr = _frames(6, 100, seed=9)
    p = tmp_path / "c.trpx"
    enc = _port(p, 100, np.uint16)
    enc.add_frames(fr)
    enc.flush()
    data = bytearray(Path(f"{p}.part").read_bytes())
    data[0] = 0xFE                # frame 0's first header: width 73
    data[1] |= 0x0F
    Path(f"{p}.part").write_bytes(bytes(data))
    with pytest.raises(ValueError):
        enc.finalize(verify=True)
    assert not p.exists()


def test_device_backend_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, True, "cuda"):
        with pytest.raises(RuntimeError, match=r"device='cpu'.*device=False"):
            StreamingEncoder(tmp_path / "n.trpx", nvalues=10,
                             dtype=np.uint16, device=device)
    assert not (tmp_path / "n.trpx.manifest").exists()
    with pytest.raises(ValueError, match="backend"):
        StreamingEncoder(tmp_path / "n.trpx", nvalues=10, dtype=np.uint16,
                         backend="gpu")


# --------------------------------------------------------- iter_decode ---


def _decode_both(arch, dtype, C, **kw):
    ours = list(iter_decode(arch, dtype, C, device="cpu", **kw))
    ref = list(jiter_decode(jpycodec.TrpxArchive.from_bytes(arch.to_bytes()),
                            dtype, C, device=True))
    return ours, ref


@pytest.mark.parametrize("dtype,n,C", [(np.uint16, 300, 4),
                                       (np.int16, 129, 5),
                                       (np.uint32, 50, 11)])
def test_iter_decode_matches_jax(dtype, n, C):
    """A foreign archive (no index) with a partial last chunk: the same
    chunks as JAX's pipeline, and the walk's tables left on it."""
    fr = _frames(11, n, dtype, seed=n)
    arch = pycodec.TrpxArchive.from_bytes(ncodec.encode(fr).to_bytes())
    assert getattr(arch, "width_table", None) is None
    ours, ref = _decode_both(arch, dtype, C)
    assert [c.shape for c in ours] == [c.shape for c in ref]
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(ours), fr)
    offs_ref, wt_ref = _compute_offsets(arch)
    np.testing.assert_array_equal(arch.frame_index, offs_ref)
    np.testing.assert_array_equal(arch.width_table, wt_ref)


def test_iter_decode_uses_proven_sidecar_tables(tmp_path, monkeypatch):
    fr = _frames(10, 200, seed=11)
    path = tmp_path / "i.trpx"
    write_trpx(ncodec.encode(fr), path, index=True)

    def no_walk(*a, **k):
        raise AssertionError("walked despite valid sidecar tables")

    monkeypatch.setattr(tstream.native, "walk_chunk", no_walk)
    got = np.concatenate(list(iter_decode(path, np.uint16, 3,
                                          device="cpu")))
    np.testing.assert_array_equal(got, fr)
    # crafted tables fail validate_tables: the walk runs instead
    monkeypatch.undo()
    arch = read_trpx(path)
    arch.width_table = arch.width_table.copy()
    arch.width_table[0, 0] = arch.meta.prolix_bits + 1
    got = np.concatenate(list(iter_decode(arch, np.uint16, 3,
                                          device="cpu")))
    np.testing.assert_array_equal(got, fr)
    np.testing.assert_array_equal(arch.width_table,
                                  _compute_offsets(ncodec.encode(fr))[1])


@pytest.mark.parametrize("kind", ["width", "offsets"])
def test_iter_decode_rejected_sidecar_warns_once_per_process(
        tmp_path, kind, fresh_fallbacks):
    """The chunked ``iter_decode`` distrusts sidecar tables that
    ``validate_tables`` rejects, walks chunk by chunk, decodes exactly and
    gives one RuntimeWarning at site ``stream.sidecar_tables``, as the JAX
    package's ``iter_decode`` does; a second decode gives none in either
    package."""
    from trpx_tpu.io.trpx import read_trpx as jread_trpx

    p, stack = rejected_sidecar(tmp_path, kind)
    for call in range(2):
        got, ours = fallback_warnings(lambda: np.concatenate(list(
            iter_decode(read_trpx(p), np.uint16, chunk_frames=2,
                        device="cpu"))), "stream.sidecar_tables")
        np.testing.assert_array_equal(got, stack)
        ref, theirs = fallback_warnings(lambda: np.concatenate(list(
            jiter_decode(jread_trpx(p), np.uint16, chunk_frames=2,
                         device=True))), "stream.sidecar_tables")
        np.testing.assert_array_equal(ref, stack)
        assert len(ours) == len(theirs) == (0 if call else 1)
        if not call:
            assert ours[0].replace("trpx_tpu_torch", "trpx_tpu",
                                   1) == theirs[0]


def test_iter_decode_fetch_false_yields_device_tensors():
    fr = _frames(7, 90, seed=12)
    arch = ncodec.encode(fr)
    parts = []
    for out, nf in iter_decode(arch, np.uint16, 3, device="cpu",
                               fetch=False):
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert out.dtype == torch.uint16 and out.shape == (nf, 90)
        parts.append(out[:nf].numpy())
    np.testing.assert_array_equal(np.concatenate(parts), fr)
    with pytest.raises(ValueError, match="fetch=False"):
        next(iter_decode(arch, np.uint16, device=False, fetch=False))


def test_iter_decode_host_branch_matches_jax():
    fr = _frames(9, 70, seed=13)
    arch = ncodec.encode(fr)
    ours = list(iter_decode(arch, np.uint16, 4, device=False))
    ref = list(jiter_decode(arch.to_bytes(), np.uint16, 4, device=False))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_iter_decode_yields_fresh_arrays():
    """A yielded chunk is never overwritten by a later one."""
    fr = _frames(9, 40, seed=14)
    chunks = list(iter_decode(ncodec.encode(fr), np.uint16, 3,
                              device="cpu"))
    np.testing.assert_array_equal(np.concatenate(chunks), fr)


def test_decompress_of_many_frames_goes_through_iter_decode(monkeypatch):
    F = tapi._DEVICE_CHUNK_FRAMES + 37
    rng = np.random.default_rng(15)
    fr = rng.poisson(3.0, (F, 12, 10)).astype(np.uint16)
    arch = pycodec.TrpxArchive.from_bytes(
        ncodec.encode(fr.reshape(F, -1), dimensions=(10, 12)).to_bytes())
    calls = []
    real = tstream.iter_decode

    def spy(archive, dtype, chunk_frames=256, device=None):
        calls.append((chunk_frames, device))
        return real(archive, dtype, chunk_frames, device)

    monkeypatch.setattr(tstream, "iter_decode", spy)
    out = trpx_tpu_torch.decompress(arch, device="cpu")
    np.testing.assert_array_equal(out, fr)
    assert calls == [(tapi._DEVICE_CHUNK_FRAMES, torch.device("cpu"))]
    assert arch.width_table is not None and len(arch.frame_index) == F


# ------------------------------------------------------------- metrics ---


def test_run_report_matches_jax():
    t, jt = StageTimer(), JStageTimer()
    for timer in (t, jt):
        with timer.stage("kernel"):
            pass
    secs = {"h2d": 0.25, "kernel": 0.125, "write": 0.5}
    for kind in ("TPU v5 lite", "NVIDIA H100 80GB HBM3", "other"):
        kw = dict(operation="decode", frames=256, raw_bytes=256 * 2 * 512**2,
                  compressed_bytes=12_345_678, device_kind=kind,
                  n_devices=2, stage_seconds=secs)
        ours, ref = RunReport(**kw), JRunReport(**kw)
        if kind.startswith("NVIDIA"):
            assert "hbm_sol_fraction" not in ref.to_dict()
            gbs = 256 * 2 * 512**2 / 0.875 / 1e9
            assert ours.to_dict()["hbm_sol_fraction"] == \
                round(gbs / (3350.0 * 2), 4)
            assert "% of HBM SoL" in ours.summary()
            continue
        assert ours.to_dict() == ref.to_dict()
        assert ours.to_json() == ref.to_json()
        assert ours.summary() == ref.summary()
        assert ours.scaling_efficiency(100.0) == ref.scaling_efficiency(100.0)
    assert set(t.seconds) == set(jt.seconds) == {"kernel"}


def test_profiler_trace_writes_chrome_trace(tmp_path):
    with tmetrics.profiler_trace(str(tmp_path / "tr")):
        trpx_tpu_torch.compress(_frames(2, 100), device="cpu")
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "trpx.encode.kernel" in names
    with tmetrics.profiler_trace(None):
        pass


def test_runtime_imports_leave_jax_unloaded():
    code = ("import sys\n"
            "import trpx_tpu_torch, trpx_tpu_torch.runtime, "
            "trpx_tpu_torch.terse\n"
            "from trpx_tpu_torch import Terse\n"
            "from trpx_tpu_torch.runtime import StreamingEncoder, "
            "iter_decode, RunReport, StageTimer\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_iter_decode_default_device_needs_a_card(monkeypatch):
    """iter_decode(device=None) decodes on the card and raises without
    one; a 64-bit target has no kernel and takes the host codec."""
    monkeypatch.setattr(tapi.torch.cuda, "is_available", lambda: False)
    fr = _frames(5, 40, seed=16)
    arch = ncodec.encode(fr)
    with pytest.raises(RuntimeError, match=r"device='cpu'.*device=False"):
        next(iter_decode(arch, np.uint16, 2))
    wide = np.concatenate(list(iter_decode(arch, np.uint64, 2)))
    np.testing.assert_array_equal(wide, fr)
