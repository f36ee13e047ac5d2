"""A copy of the benchmark with tiny cells added as files and entries
only, for runs of the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: (cell, config, traffic, entry, chips, frames a call) of the added
#: cells; the foreign decode's 300 frames take the program's chunked
#: stream, as its 1,000 do
CELLS = [
    ("tiny_u16.compress", "tiny_u16", "tiny_compress", "compress", 1, 9),
    ("tiny_u16.foreign", "tiny_u16", "tiny_foreign", "decompress_bytes", 1,
     300),
    ("tiny_u32.indexed", "tiny_u32", "tiny_indexed", "decompress_path", 1, 9),
    ("tiny_u16.sharded", "tiny_u16", "tiny_sharded", "sharded_encode", 4, 9),
]

METRIC_PY = '''
def read(run, spec):
    """Calls completed a second."""
    return len(run.latencies) / run.window_s if run.window_s > 0 else None
'''


def make(dst: Path) -> Path:
    """The benchmark of this checkout copied to ``dst``, plus the tiny
    configurations, mixes, cells and two metrics, each a new file and a
    new entry of ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = dst / "portbench"
    for name, dtype, hot in (("tiny_u16", "uint16", 60000),
                             ("tiny_u32", "uint32", 2_000_000_000)):
        cfg = {"name": name, "source": "tests", "height": 16, "width": 20,
               "dtype": dtype, "block": 12,
               "pixels": {"poisson_mean": 3.0, "hot_pixels": 5,
                          "hot_value": hot},
               "assumed": [], "reduced": []}
        (home / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        doc["configs"].append({"name": name, "source": "tests",
                               "file": f"portbench/configs/{name}.json",
                               "reduced": [], "why": "tests"})
    for cell, config, traffic, entry, chips, frames in CELLS:
        mix = {"entry": entry, "frames_per_call": frames, "distinct_inputs": 3,
               "pool_frames": 13, "warm_calls": 1, "check_sample": 2,
               "probe_count": 64}
        (home / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        doc["workloads"].append({"name": cell, "config": config,
                                 "traffic": traffic, "chips": chips,
                                 "why": "tests"})
    cells = [c[0] for c in CELLS]
    enc, dec = [cells[0], cells[3]], [cells[1], cells[2]]
    for m in doc["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += dec if m["name"].startswith("decode") else enc
    (home / "metrics" / "encode.assemble_ms.json").write_text(json.dumps(
        {"reader": "range_ms_per_call", "ranges": ["trpx.encode.assemble"]}))
    (home / "metrics" / "calls_per_s.py").write_text(METRIC_PY)
    doc["per_layer"] += [
        {"name": "encode.assemble_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "ops.coding collect and assemble",
         "moves": "encode_fps", "workloads": [cells[0]]},
        {"name": "calls_per_s", "unit": "1/s", "better": "higher",
         "source": "host_clock", "layer": "api", "moves": "encode_fps",
         "workloads": [cells[0]]}]
    (dst / "BENCHMARK.json").write_text(json.dumps(doc))
    return dst
