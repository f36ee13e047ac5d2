"""The harness on the CPU: every cell found by name, a cell, a mix and a
metric added as files only, the result line's keys, the import rule, and
no result without a card."""

import ast
import json
import re
import subprocess
import sys
import time
import types

import pytest

from portbench import host, run, spec
from portbench.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def test_every_cell_resolves_its_files_by_name():
    b = spec.Bench(ROOT)
    doc = b.doc
    assert {m["name"] for m in doc["end_to_end"]} >= {"setup_s"}
    for w in doc["workloads"]:
        cfg = b.config(w["config"])
        assert {"height", "width", "dtype", "block", "pixels"} <= set(cfg)
        mix = b.traffic(w["traffic"])
        assert hasattr(b.entry(mix["entry"]), "Cell")
        e2e = b.metrics(w["name"], "end_to_end")
        layer = b.metrics(w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        for m in e2e + layer:
            assert callable(b.reader(m["name"]))
    cells = {w["name"] for w in doc["workloads"]}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_benchmark_json_keeps_the_contracts_shapes():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in doc[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in doc["workloads"])
    assert four <= max(1, len(doc["workloads"]) // 4)
    for w in doc["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_cells_mixes_and_metrics_added_as_files_run(tiny_root):
    r = run.run_cell(tiny_root, "tiny_u16.compress", 2**31 + 77, 0.3, True,
                     cpu=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"encode.assemble_ms", "calls_per_s"}
    # nothing ran on a card: the device readers find nothing to read
    b = spec.Bench(tiny_root)
    run_ = run.Run(1.0, 1.0, [0.1], [], "cpu", trace=None)
    assert b.reader("encode.kernel_roofline")(run_) is None
    assert b.reader("encode.idle_pct")(run_) is None


@pytest.mark.parametrize("cell", [c[0] for c in tiny.CELLS])
def test_the_result_line(tiny_root, cell):
    r = run.run_cell(tiny_root, cell, 5_000_000_011, 0.3, False, cpu=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in spec.Bench(tiny_root).metrics(cell,
                                                             "end_to_end")}
    assert set(r["metrics"]) == want
    assert {"platform", "kind", "count", "memory_peak_bytes",
            "host"} <= set(r["device"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_setup_s_leaves_out_the_references_work(tiny_root, monkeypatch):
    from portbench import reference

    encode_streams = reference.encode_streams

    def slow(*a, **k):
        time.sleep(1.0)
        return encode_streams(*a, **k)

    monkeypatch.setattr(reference, "encode_streams", slow)
    t = time.time()
    r = run.run_cell(tiny_root, "tiny_u32.indexed", 5_000_000_013, 0.2,
                     False, cpu=True, t_start=t)
    assert r["correct"]
    assert r["metrics"]["setup_s"]["value"] < 1.0 < time.time() - t


def test_the_host_when_the_window_opens():
    got = host.report()
    assert got["cpus"] >= 1 and 1 <= got["cpus_allowed"] <= got["cpus"]
    assert got["torch_threads"] >= 1
    assert got["mem_available_bytes"] is None or got["mem_available_bytes"] > 0
    json.dumps(got)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "trpx_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "trpx_tpu_torch_like",
                        types.ModuleType("trpx_tpu_torch_like"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "trpx_tpu.api",
                        types.ModuleType("trpx_tpu.api"))
    assert run.forbidden_modules() == ["trpx_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, control\n"
        "for c in ('tiny_u16.compress', 'tiny_u16.foreign', "
        "'tiny_u32.indexed', 'tiny_u16.sharded'):\n"
        "    assert run.run_cell(%r, c, 3, 0.2, True, cpu=True)['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (str(ROOT), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "trpx_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "trpx_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    src = (ROOT / "portbench" / "reference.py").read_text()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "struct", "zlib", "dataclasses", "numpy",
                    "torch"}
    code = ("import sys; import portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert not {"trpx_tpu_torch", "trpx_tpu", "jax"} & set(
        json.loads(out.stdout.replace("'", '"')))


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "quad512_u16.compress", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_a_bare_benchmark_directory_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "quad512_u16.compress", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run.run_cell(tiny_root, "tiny_u16.compress", 11, 0.3, True)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
