"""PyTorch port, the CLI (``trpx_tpu_torch.cli``) and its TIFF container,
on ``--device cpu`` (the kernels' plain versions), held against the JAX
package's CLI (``trpx_tpu.cli``) on the same inputs: the counterpart of
``tests/test_cli.py`` and ``tests/test_tiff_stream.py``. Each command runs
once per package in its own directory; ``.trpx``, ``.trpx.idx`` and TIFF
bytes and the ``info``/``verify`` text must be equal. Tolerance: exact.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu_torch.cli.main import main, prolix_main, terse_main
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.io import read_tiff, write_tiff
from trpx_tpu_torch.io.trpx import read_trpx, write_trpx

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
# the modules (each package's ``cli`` exports a function named ``main``)
jmain_mod = importlib.import_module("trpx_tpu.cli.main")
tmain_mod = importlib.import_module("trpx_tpu_torch.cli.main")


def _frame(rng, shape=(32, 32), dtype=np.uint16):
    img = rng.poisson(3.0, size=shape).astype(dtype)
    img.reshape(-1)[rng.integers(0, img.size, 10)] = 40000
    return img


def _both(tmp_path, inputs: dict, fn: str, args, port_args=CPU):
    """Write `inputs` ({name: bytes}) into ``tmp_path/jax`` and
    ``tmp_path/port``, run the command `fn` (``main``, ``terse_main`` or
    ``prolix_main``) of each package there with `args` (file names
    relative to the directory; the port's with `port_args` added) and
    return {"jax": (rc, dir), "port": (rc, dir)}."""
    out = {}
    for pkg, mod, extra in (("jax", jmain_mod, []),
                            ("port", tmain_mod, list(port_args))):
        d = tmp_path / pkg
        d.mkdir(parents=True)
        for name, blob in inputs.items():
            (d / name).write_bytes(blob)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            rc = getattr(mod, fn)(list(args) + extra)
        finally:
            os.chdir(cwd)
        out[pkg] = (rc, d)
    return out


def _same_files(res, *names):
    for name in names:
        a = (res["port"][1] / name).read_bytes()
        assert a == (res["jax"][1] / name).read_bytes(), name


def test_cli_encode_decode_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    frames = rng.poisson(3.0, size=(3, 24, 24)).astype(np.uint16)
    tif = write_tiff(frames)
    res = _both(tmp_path, {"movie.tif": tif}, "terse_main",
                ["movie.tif", "-verbose"])
    assert res["port"][0] == res["jax"][0] == 0
    _same_files(res, "movie.trpx")
    assert (res["port"][1] / "movie.tif").exists()
    arch = read_trpx(res["port"][1] / "movie.trpx")
    assert arch.meta.number_of_frames == 3
    trpx = (res["port"][1] / "movie.trpx").read_bytes()
    res = _both(tmp_path / "dec", {"movie.trpx": trpx}, "prolix_main",
                ["movie.trpx", "--out-dir", "out"])
    assert res["port"][0] == res["jax"][0] == 0
    _same_files(res, "out/movie.tif", "movie.trpx.idx")
    np.testing.assert_array_equal(
        read_tiff(res["port"][1] / "out" / "movie.tif").as_array(), frames)


def test_cli_delete_inputs(tmp_path):
    rng = np.random.default_rng(3)
    res = _both(tmp_path, {"a.tif": write_tiff(_frame(rng))}, "terse_main",
                ["a.tif", "--delete-inputs"])
    for rc, d in res.values():
        assert rc == 0 and not (d / "a.tif").exists()
    _same_files(res, "a.trpx")
    blob = (res["port"][1] / "a.trpx").read_bytes()
    res = _both(tmp_path / "d", {"a.trpx": blob}, "prolix_main",
                ["a.trpx", "--delete-inputs"])
    for rc, d in res.values():
        assert rc == 0 and not (d / "a.trpx").exists()
        assert not (d / "a.trpx.idx").exists()
    _same_files(res, "a.tif")


def test_cli_skips_nonmatching_and_recovers(tmp_path, capsys):
    good = write_tiff(np.zeros((4, 4), np.uint16))
    res = _both(tmp_path, {"ok.tif": good, "bad.tif": b"not a tiff",
                           "notes.txt": b"hi"}, "terse_main",
                ["bad.tif", "notes.txt", "ok.tif"])
    err = capsys.readouterr().err
    assert err.count("bad.tif") == 2
    for rc, d in res.values():
        assert rc == 0
        assert not (d / "notes.trpx").exists()
    _same_files(res, "ok.trpx")


def test_cli_square_fallback_when_no_dims(tmp_path):
    """Archives without a dimensions attribute decode to sqrt(size)
    squares (prolix.cpp:62-63)."""
    rng = np.random.default_rng(4)
    vals = rng.poisson(3.0, size=64).astype(np.uint16)
    blob = pycodec.encode(vals).to_bytes()
    res = _both(tmp_path, {"nodim.trpx": blob}, "prolix_main", ["nodim.trpx"])
    _same_files(res, "nodim.tif", "nodim.trpx.idx")
    img = read_tiff(res["port"][1] / "nodim.tif")[0]
    assert img.shape == (8, 8)
    np.testing.assert_array_equal(img.reshape(-1), vals)


def test_umbrella_encode_info_decode(tmp_path, capsys):
    rng = np.random.default_rng(5)
    tif = write_tiff(_frame(rng))
    res = _both(tmp_path, {"x.tif": tif}, "main", ["encode", "x.tif"])
    _same_files(res, "x.trpx")
    texts = []
    for pkg, mod in (("jax", jmain_mod), ("port", tmain_mod)):
        capsys.readouterr()
        p = str(res[pkg][1].parent / "port" / "x.trpx")
        assert mod.main(["info", p]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "frames           1" in texts[1]
    assert main(["decode", str(res["port"][1] / "x.trpx"), "--out-dir",
                 str(tmp_path / "o")] + CPU) == 0
    assert (tmp_path / "o" / "x.tif").read_bytes() == tif


@pytest.mark.parametrize("flags", [CPU, ["--host"]], ids=["cpu", "host"])
def test_encode_index_sidecar(tmp_path, flags):
    """--index writes a .trpx.idx sidecar equal to the JAX CLI's, which
    the decode's walk then trusts."""
    rng = np.random.default_rng(3)
    frames = rng.poisson(3.0, size=(4, 16, 16)).astype(np.uint16)
    res = _both(tmp_path, {"ix.tif": write_tiff(frames)}, "terse_main",
                ["ix.tif", "--index"], port_args=flags)
    _same_files(res, "ix.trpx", "ix.trpx.idx")
    arch = read_trpx(res["port"][1] / "ix.trpx")
    assert arch.frame_index is not None and len(arch.frame_index) == 4
    assert arch.width_table is not None


def test_decode_frames_subset_and_no_index(tmp_path):
    rng = np.random.default_rng(12)
    frames = rng.poisson(3.0, size=(6, 16, 16)).astype(np.uint16)
    blob = pycodec.encode(list(frames.reshape(6, -1)),
                          dimensions=(16, 16)).to_bytes()
    for spec, want in (("4", frames[4:5]), ("1:6:2", frames[1:6:2]),
                       ("5,0", frames[[5, 0]])):
        res = _both(tmp_path / spec.replace(":", "_").replace(",", "_"),
                    {"m.trpx": blob}, "prolix_main",
                    ["m.trpx", "--frames", spec])
        _same_files(res, "m.tif")
        assert not (res["port"][1] / "m.trpx.idx").exists()
        np.testing.assert_array_equal(
            read_tiff(res["port"][1] / "m.tif").as_array(), want)
    res = _both(tmp_path / "noidx", {"m.trpx": blob}, "prolix_main",
                ["m.trpx", "--no-index"])
    _same_files(res, "m.tif")
    assert not (res["port"][1] / "m.trpx.idx").exists()
    assert prolix_main([str(res["port"][1] / "m.trpx"), "--frames",
                        "a:b"] + CPU) == 2


def test_trpx_verify(tmp_path, capsys):
    """verify: OK for intact archives (a forced re-walk, not the sidecar),
    nonzero and a FAILED line for corrupt ones; the text equals the JAX
    CLI's."""
    rng = np.random.default_rng(33)
    stack = rng.poisson(3.0, size=(3, 32, 32)).astype(np.uint16)
    arch = pycodec.encode(list(stack.reshape(3, -1)), dimensions=(32, 32))
    good, bad = tmp_path / "g.trpx", tmp_path / "b.trpx"
    write_trpx(arch, good, index=True)
    blob = arch.to_bytes()
    bad.write_bytes(blob[: len(blob) // 2])
    outs = []
    for mod in (jmain_mod, tmain_mod):
        capsys.readouterr()
        assert mod.main(["verify", str(good)]) == 0
        assert mod.main(["verify", str(good), str(bad)]) == 1
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1]
    assert "OK" in outs[1].out and "FAILED" in outs[1].err
    assert "v2, matches walk" in outs[1].out


def test_trpx_verify_sidecar_checks(tmp_path, capsys):
    """verify fails on a corrupt .idx (which decode ignores), on a stale
    one whose tables disagree with the walk, and passes 64-bit archives
    through the host codec; as the JAX CLI does, word for word."""
    from trpx_tpu_torch.io.trpx import _compute_offsets, write_index

    rng = np.random.default_rng(34)
    stack = rng.poisson(3.0, size=(4, 32, 32)).astype(np.uint16)
    p = tmp_path / "s.trpx"
    write_trpx(pycodec.encode(list(stack.reshape(4, -1))), p, index=True)
    idx = tmp_path / "s.trpx.idx"
    blob = bytearray(idx.read_bytes())
    blob[10] ^= 0xFF
    idx.write_bytes(bytes(blob))

    def both(needle):
        errs = []
        for mod in (jmain_mod, tmain_mod):
            capsys.readouterr()
            assert mod.main(["verify", str(p)]) == 1
            errs.append(capsys.readouterr().err)
        assert errs[0] == errs[1] and needle in errs[1]

    both("corrupt or stale")
    arch = read_trpx(p)
    arch.frame_index = arch.width_table = None
    offs, wt = _compute_offsets(arch)
    wt = wt.copy()
    wt[0, 0] = int(wt[0, 0]) - 1 if wt[0, 0] > 0 else 1
    write_index(p, offs, arch.meta.memory_size, widths=wt)
    both("width tables disagree")
    wide = tmp_path / "w.trpx"
    vals = (np.arange(24, dtype=np.uint64) << 33).reshape(2, 12)
    write_trpx(pycodec.encode(list(vals)), wide)
    assert main(["verify", str(wide)]) == 0
    assert "OK" in capsys.readouterr().out


def test_jobs_pool_encode_decode(tmp_path, capsys):
    """--jobs N runs files on a thread pool with per-file error recovery
    and the serial loop's verbose report; outputs equal the JAX CLI's."""
    rng = np.random.default_rng(41)
    frames = [rng.poisson(3.0, (32, 32)).astype(np.uint16) for _ in range(4)]
    inputs = {f"j{k}.tif": write_tiff(f) for k, f in enumerate(frames)}
    inputs["bad.tif"] = b"nottiff!"
    names = sorted(inputs)
    res = _both(tmp_path, inputs, "terse_main",
                ["-verbose", "--jobs", "3"] + names)
    out = capsys.readouterr()
    assert out.out.count("Terse compressed: 4 files") == 2
    assert "Error processing" in out.err
    trpx = [f"j{k}.trpx" for k in range(4)]
    _same_files(res, *trpx)
    blobs = {n: (res["port"][1] / n).read_bytes() for n in trpx}
    res = _both(tmp_path / "d", blobs, "prolix_main",
                ["--jobs", "3", "--out-dir", "d"] + trpx)
    assert res["port"][0] == 0
    _same_files(res, *(f"d/j{k}.tif" for k in range(4)))
    for k, f in enumerate(frames):
        got = read_tiff(res["port"][1] / "d" / f"j{k}.tif")
        np.testing.assert_array_equal(got[0], f)


def test_jobs_duplicate_basenames_no_corruption(tmp_path):
    """Two inputs sharing a basename under --out-dir collide on one
    destination; with --jobs the temp files stay unique, so the archive
    is a valid last-writer-wins result."""
    import trpx_tpu_torch

    rng = np.random.default_rng(7)
    frames = [rng.poisson(3.0, (64, 64)).astype(np.uint16) for _ in range(2)]
    srcs = []
    for k, f in enumerate(frames):
        d = tmp_path / f"dir{k}"
        d.mkdir(parents=True)
        write_tiff(f, d / "x.tif")
        srcs.append(str(d / "x.tif"))
    out = tmp_path / "out"
    out.mkdir()
    for _ in range(3):
        assert terse_main(srcs + ["--jobs", "2", "--out-dir", str(out)]
                          + CPU) == 0
        pix = trpx_tpu_torch.decompress(out / "x.trpx", device="cpu")
        assert any(np.array_equal(pix, f) for f in frames)
        assert not list(out.glob("*.tmp"))


def test_atomic_write_honors_umask(tmp_path):
    from trpx_tpu_torch.cli.main import _atomic_write

    dst = tmp_path / "o.bin"
    _atomic_write(dst, lambda f: f.write(b"x"), durable=False)
    umask = os.umask(0)
    os.umask(umask)
    assert (dst.stat().st_mode & 0o777) == (0o666 & ~umask)


def test_jobs_stream_notice(tmp_path, capsys):
    rng = np.random.default_rng(8)
    src = tmp_path / "s.tif"
    write_tiff(rng.poisson(3.0, (32, 32)).astype(np.uint16), src)
    assert terse_main([str(src), "--stream", "--host", "--jobs", "4"]) == 0
    assert "--jobs has no effect with --stream" in capsys.readouterr().err


def test_trpx_concat(tmp_path, capsys):
    rng = np.random.default_rng(9)
    a = rng.poisson(3.0, (2, 32, 32)).astype(np.uint16)
    b = rng.poisson(3.0, (3, 32, 32)).astype(np.uint16)
    inputs = {"a.trpx": pycodec.encode(list(a.reshape(2, -1)),
                                       dimensions=(32, 32)).to_bytes(),
              "b.trpx": pycodec.encode(list(b.reshape(3, -1)),
                                       dimensions=(32, 32)).to_bytes(),
              "bad.trpx": pycodec.encode(np.arange(7, dtype=np.uint16))
              .to_bytes()}
    res = _both(tmp_path, inputs, "main",
                ["concat", "c.trpx", "a.trpx", "b.trpx", "--index",
                 "-verbose"], port_args=[])
    assert res["port"][0] == 0
    assert capsys.readouterr().out.count("5 frames") == 2
    _same_files(res, "c.trpx", "c.trpx.idx")
    whole = jpycodec.encode(list(np.concatenate([a, b]).reshape(5, -1)),
                            dimensions=(32, 32))
    assert (res["port"][1] / "c.trpx").read_bytes() == whole.to_bytes()
    assert main(["concat", str(res["port"][1] / "d.trpx"),
                 str(res["port"][1] / "a.trpx"),
                 str(res["port"][1] / "bad.trpx")]) == 1
    assert "values/frame differ" in capsys.readouterr().err
    assert not (res["port"][1] / "d.trpx").exists()


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_cli_stream_mode(tmp_path, dtype):
    """--stream encodes through the port's ``StreamingEncoder`` and
    decodes through ``iter_decode``; files equal the JAX CLI's and
    ``pycodec``'s."""
    rng = np.random.default_rng(1)
    frames = (rng.poisson(3.0, size=(25, 16, 16)) - (2 if dtype == np.int32
                                                      else 0)).astype(dtype)
    res = _both(tmp_path, {"movie.tif": write_tiff(frames)}, "terse_main",
                ["movie.tif", "--stream", "--chunk-frames", "7", "--index"])
    _same_files(res, "movie.trpx", "movie.trpx.idx")
    ref = pycodec.encode(list(frames.reshape(25, -1)), dimensions=(16, 16))
    blob = (res["port"][1] / "movie.trpx").read_bytes()
    assert blob == ref.to_bytes()
    res = _both(tmp_path / "d", {"movie.trpx": blob}, "prolix_main",
                ["movie.trpx", "--stream", "--chunk-frames", "4",
                 "--out-dir", "o"])
    _same_files(res, "o/movie.tif")
    np.testing.assert_array_equal(
        read_tiff(res["port"][1] / "o" / "movie.tif").as_array(), frames)


def test_cli_stream_decode_subset(tmp_path):
    rng = np.random.default_rng(6)
    frames = rng.poisson(3.0, size=(9, 8, 12)).astype(np.uint16)
    blob = pycodec.encode(list(frames.reshape(9, -1)),
                          dimensions=(12, 8)).to_bytes()
    res = _both(tmp_path, {"m.trpx": blob}, "prolix_main",
                ["m.trpx", "--stream", "--frames", "2:8", "--chunk-frames",
                 "4"])
    _same_files(res, "m.tif")
    np.testing.assert_array_equal(
        read_tiff(res["port"][1] / "m.tif").as_array(), frames[2:8])


def test_default_device_needs_a_card(tmp_path, capsys, monkeypatch):
    """Without a card and without --device cpu or --host, each file fails
    with the RuntimeError's message and nothing is written; --host runs
    the native codec."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(10)
    src = tmp_path / "a.tif"
    write_tiff(_frame(rng), src)
    for extra in ([], ["--stream"]):
        assert terse_main([str(src)] + extra) == 0
        err = capsys.readouterr().err
        assert "Error processing" in err and "device='cpu'" in err
        assert not (tmp_path / "a.trpx").exists()
    assert terse_main([str(src), "--host"]) == 0
    blob = (tmp_path / "a.trpx").read_bytes()
    assert prolix_main([str(tmp_path / "a.trpx")]) == 0
    assert "device='cpu'" in capsys.readouterr().err
    assert not (tmp_path / "a.tif.tmp").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["bench", "--frames", "2", "--size", "16"])
    assert blob == jpycodec.encode(
        list(read_tiff(src).as_array().reshape(1, -1)),
        dimensions=(32, 32)).to_bytes()


def test_bench_report(tmp_path, capsys):
    assert main(["bench", "--frames", "4", "--size", "32", "--e2e",
                 "--chunk-frames", "3", "--profile", str(tmp_path / "p")]
                + CPU) == 0
    out = capsys.readouterr().out.splitlines()
    rep = json.loads(out[1])
    assert rep["frames"] == 4 and rep["device_kind"] == "cpu"
    assert set(rep["stage_seconds"]) == {"encode", "decode"}
    assert out[2].startswith("e2e TIFF->trpx") and \
        out[3].startswith("e2e trpx->pixels")
    assert (tmp_path / "p" / "trace.json").exists()


def test_python_dash_m_entry(tmp_path):
    rng = np.random.default_rng(11)
    frames = rng.poisson(3.0, size=(2, 8, 8)).astype(np.uint16)
    src = tmp_path / "m.tif"
    write_tiff(frames, src)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-m", "trpx_tpu_torch.cli", "encode",
                        str(src), "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "m.trpx").read_bytes() == jpycodec.encode(
        list(frames.reshape(2, -1)), dimensions=(8, 8)).to_bytes()
    r = subprocess.run([sys.executable, "-m", "trpx_tpu_torch.cli", "info",
                        str(tmp_path / "m.trpx")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "frames           2" in r.stdout
    r = subprocess.run([sys.executable, "-m", "trpx_tpu_torch.cli"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "usage: python -m trpx_tpu_torch.cli" \
        in r.stderr


def test_cli_interop_with_reference(tmp_path, reference_cli):
    """The port's terse output is decodable by reference prolix and vice
    versa."""
    rng = np.random.default_rng(6)
    img = _frame(rng, (48, 48))
    ours = tmp_path / "ours"
    ours.mkdir()
    write_tiff(img, ours / "f.tif")
    assert terse_main([str(ours / "f.tif")] + CPU) == 0
    subprocess.run([str(reference_cli["prolix"]), str(ours / "f.trpx")],
                   check=True, capture_output=True, cwd=ours)
    np.testing.assert_array_equal(read_tiff(ours / "f.tif")[0], img)
    theirs = tmp_path / "theirs"
    theirs.mkdir()
    write_tiff(img, theirs / "g.tif")
    subprocess.run([str(reference_cli["terse"]), str(theirs / "g.tif")],
                   check=True, capture_output=True, cwd=theirs)
    shutil.copy(theirs / "g.trpx", tmp_path / "g.trpx")
    assert prolix_main([str(tmp_path / "g.trpx")] + CPU) == 0
    np.testing.assert_array_equal(read_tiff(tmp_path / "g.tif")[0], img)
