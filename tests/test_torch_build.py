"""PyTorch port: what surrounds the CUDA kernels and runs without a card.

- ``_build``: the normal and the bounds-checked library (flags, file
  names, one ``nvcc`` per source started together, then one link; driven
  here with a stand-in compiler), and the choice of build per process.
- The launchers' sources: every C entry point restores the caller's
  current device before any return (``DeviceGuard``), and the self-test
  that trips a ``TRPX_CHECK`` exists only in the checked build.
- The wrappers' launch counters, exact under many host threads (driven
  with a stand-in library and tensors that claim to lie on a card).
- ``_fallback.warn_once`` against the JAX package's: the same messages
  under the port's prefix, once per site.
"""

import re
import subprocess
import sys
import threading
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from trpx_tpu import _fallback as jfallback
from trpx_tpu_torch import _build
from trpx_tpu_torch import _fallback as tfallback
from trpx_tpu_torch.ops import (
    FrameSpec,
    decode_batch,
    decode_batch_tiled,
    encode_batch,
    encode_batch_tiled,
)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "trpx_tpu_torch" / "csrc"
ENTRY_POINTS = {"pack.cu": "trpx_pack", "pack_tiled.cu": "trpx_pack_tiled",
                "unpack.cu": "trpx_unpack",
                "unpack_tiled.cu": "trpx_unpack_tiled"}


# ------------------------------------------------------------- _build ---


def test_normal_flags_unchanged_checked_flags_added():
    assert _build.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC")
    assert _build.flags() == _build.NVCC_FLAGS
    assert _build.flags(True) == _build.NVCC_FLAGS + ("-DTRPX_CHECKED",
                                                      "-lineinfo")


def test_the_two_libraries_live_side_by_side():
    normal, checked = _build.library_path(), _build.library_path(True)
    assert normal != checked and normal.parent == checked.parent
    assert re.fullmatch(r"libtrpx_cuda_[0-9a-f]{16}\.so", normal.name)
    assert re.fullmatch(r"libtrpx_cuda_[0-9a-f]{16}\.so", checked.name)


FAKE_NVCC = """#!{python}
import json, sys
from pathlib import Path
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
Path(args[args.index("-o") + 1]).write_text(" ".join(args))
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc that records its arguments and writes its
    output file; the libraries go to a scratch build directory."""
    log = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def _calls(log: Path) -> list:
    import json

    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("checked", [False, True])
def test_build_compiles_each_source_then_links(fake_nvcc, checked):
    so = _build.build(checked)
    assert so == _build.library_path(checked) and so.exists()
    calls = _calls(fake_nvcc)
    sources = sorted(CSRC.glob("*.cu"))
    compiles, links = calls[:-1], calls[-1]
    assert sorted(Path(c[c.index("-c") + 1]) for c in compiles) == sources
    flags = list(_build.flags(checked))
    for c in compiles:
        assert [a for a in c if a.startswith("-") and a not in (
            "-c", "-o")] == [f for f in flags if f.startswith("-")
                             and f != "-shared"]
        assert "-shared" not in c
    assert links[: len(flags)] == flags
    assert [Path(o).name for o in links[links.index("-o") + 2:]] == [
        f"{s.stem}.o" for s in sources]
    # a second build of the same sources and flags compiles nothing
    assert _build.build(checked) == so
    assert len(_calls(fake_nvcc)) == len(calls)
    # only the library is left in the build directory
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]


def test_build_reports_nvcc_failures(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"print('error: no sm_90a here')\nsys.exit(2)\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not _build.library_path().exists()


def test_the_build_is_chosen_before_the_first_load(monkeypatch):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_checked", False)
    _build.select_checked()
    assert _build._checked
    _build.select_checked(False)
    monkeypatch.setattr(_build, "_LIB", object())   # a library is loaded
    _build.select_checked(False)                   # the same build: fine
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.select_checked()
    assert not _build._checked


def test_select_checked_in_a_fresh_process_loads_nothing():
    """Choosing the build reads no environment and builds nothing."""
    code = ("from trpx_tpu_torch import _build\n"
            "_build.select_checked()\n"
            "assert _build._checked and _build._LIB is None\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ------------------------------------------------- the launchers' sources ---


def _entry_body(src: str, name: str) -> str:
    start = src.index(f'extern "C" int {name}(')
    body = src.index("{", start)
    depth, i = 0, body
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[body + 1 : i]
        i += 1


@pytest.mark.parametrize("source,name", sorted(ENTRY_POINTS.items()))
def test_entry_point_restores_the_callers_device(source, name):
    """The guard is the entry point's first statement, before the
    cudaSetDevice of the launch and every return."""
    body = re.sub(r"//[^\n]*", "", _entry_body((CSRC / source).read_text(),
                                                name))
    statements = [s.strip() for s in body.split(";") if s.strip()]
    assert re.fullmatch(r"const trpx::DeviceGuard guard", statements[0])
    assert statements[1].startswith("cudaError_t err = cudaSetDevice(device)")


def test_device_guard_restores_only_a_changed_device():
    src = (CSRC / "common.cuh").read_text()
    start = src.index("class DeviceGuard")
    guard = src[start : src.index("};", start)]
    assert "cudaGetDevice(&prev_)" in guard
    assert "now != prev_" in guard and "cudaSetDevice(prev_)" in guard


def test_checks_compile_to_nothing_in_the_normal_build():
    src = (CSRC / "common.cuh").read_text()
    normal = src[src.index("#else", src.index("#ifdef TRPX_CHECKED")):
                 src.index("#endif", src.index("#ifdef TRPX_CHECKED"))]
    assert "#define TRPX_CHECK(cond) ((void)0)" in normal
    assert "#define TRPX_CHECKED_ARG(...)\n" in normal


@pytest.mark.parametrize("source", sorted(ENTRY_POINTS) + ["tile.cuh"])
def test_every_kernel_source_is_checked(source):
    assert (CSRC / source).read_text().count("TRPX_CHECK(") >= 3


def test_self_test_exists_only_in_the_checked_build():
    src = (CSRC / "pack.cu").read_text()
    block = src[src.index("#ifdef TRPX_CHECKED"):]
    block = block[: block.index("#endif")]
    assert 'extern "C" int trpx_checked_selftest(int device)' in block
    assert "trpx_checked_selftest trips this line" in block
    assert src.count("trpx_checked_selftest(int device)") == 1


# ------------------------------------------- launch counters, many threads ---


class _OnCard:
    """A CPU tensor that the wrappers' checks take for one on ``cuda:0``."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """Eight host threads call the four wrappers at once against a
    stand-in library (every launch returns 0): each ``.launches`` counts
    every call."""
    def on_host(fn):
        def make(*args, device=None, **kw):
            return fn(*args, **kw)
        return make

    lib = types.SimpleNamespace(**{
        name: (lambda *a: 0) for name in ENTRY_POINTS.values()})
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch, "empty", on_host(torch.empty))
    monkeypatch.setattr(torch, "zeros", on_host(torch.zeros))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    n = 3000
    spec = FrameSpec.for_dtype(n, np.uint16)
    x = _OnCard(torch.zeros((2, spec.n_padded), dtype=torch.uint16))
    wo = _OnCard(torch.zeros((2, 8), dtype=torch.int32))
    wd = _OnCard(torch.zeros((2, spec.nb), dtype=torch.uint8))
    calls = [lambda: encode_batch(spec, x),
             lambda: encode_batch_tiled(spec, x),
             lambda: decode_batch(spec, wo, wd, torch.uint16),
             lambda: decode_batch_tiled(spec, wo, wd, torch.uint16)]
    wrappers = (encode_batch, encode_batch_tiled, decode_batch,
                decode_batch_tiled)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    threads, per = 8, 150
    errors = []

    def run(k):
        try:
            for i in range(per):
                for call in calls:
                    call()
        except Exception as e:  # reported below
            errors.append(f"thread {k}: {type(e).__name__}: {e}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert [w.launches for w in wrappers] == [threads * per] * 4


# ----------------------------------------------------------- _fallback ---


@pytest.mark.parametrize("exc,detail", [
    (None, ""), (None, "slower path"), (ValueError("bad table"), ""),
    (RuntimeError("no walker"), "pure-Python walk")])
def test_warn_once_matches_the_jax_package(monkeypatch, exc, detail):
    monkeypatch.setattr(jfallback, "_seen", set())
    monkeypatch.setattr(tfallback, "_seen", set())
    msgs = {}
    for name, mod in (("ours", tfallback), ("theirs", jfallback)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod.warn_once("ops.sidecar_tables", exc, detail)
            mod.warn_once("ops.sidecar_tables", exc, detail)
            mod.warn_once("stream.sidecar_tables", exc, detail)
        assert [w.category for w in rec] == [RuntimeWarning] * 2
        msgs[name] = [str(w.message) for w in rec]
    assert msgs["ours"][0].startswith(
        "trpx_tpu_torch fallback at ops.sidecar_tables")
    assert [m.replace("trpx_tpu_torch", "trpx_tpu", 1)
            for m in msgs["ours"]] == msgs["theirs"]
    assert tfallback._seen == {"ops.sidecar_tables", "stream.sidecar_tables"}


def test_fallback_alone_loads_nothing_of_the_jax_package():
    code = ("import json, sys\nimport trpx_tpu_torch._fallback\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = r.stdout.strip().splitlines()[-1]
    assert '"jax' not in loaded and '"trpx_tpu"' not in loaded \
        and '"trpx_tpu.' not in loaded
