"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The system under test is ``trpx_tpu_torch`` of this checkout. A run:

1. makes its inputs from ``--seed`` (``portbench/cells.py``), builds the
   program's kernels where its in-checkout cache lacks them, and warms the
   cell's one shape with a few untimed calls: all of that is set-up,
   ``setup_s``, counted from the process's start;
2. drives the cell's entry in a closed loop, one client, for ``--seconds``
   seconds, each call timed by the host clock; with ``--trace 1`` under
   ``torch.profiler``;
3. reads the device's memory peak, drops the program's state, and compares
   what the calls produced with the reference (``portbench/reference.py``);
4. prints, as the last line of stdout, one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or its per-layer ones with ``--trace 1``), ``device``, with
   ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
   with its limit, which also end standard error.

It exits non-zero and prints no result without a card, with fewer cards
than the cell asks for, when the program is not this checkout's, when the
program warned that it fell back to a slower path (``trpx_tpu_torch
fallback``: the run measured another path than its cell's), or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``trpx_tpu`` was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start, on ``time.time()``'s clock: its start in clock
    ticks since boot, against the time since boot now (Linux); else now."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - (up - ticks / os.sysconf("SC_CLK_TCK"))


T_START = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from portbench import host  # noqa: E402
from portbench import spec as bspec  # noqa: E402
from portbench import trace as tr  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "trpx_tpu_torch"
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "trpx_tpu")
#: the program's one-shot warning when it takes a slower path
FALLBACK = "trpx_tpu_torch fallback"


@dataclass
class Context:
    """What an entry's ``Cell`` is made from."""

    config: dict
    traffic: dict
    seed: int
    devices: list           # torch devices the cell uses
    device_arg: object      # what the run passes the program's ``device=``
    tmpdir: Path


@dataclass
class Run:
    """A finished window, as the metric readers see it."""

    setup_s: float
    window_s: float
    latencies: list
    work: list
    device_name: str
    trace: tr.Trace | None = None

    def total(self, key: str) -> float:
        return sum(w[key] for w in self.work)


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _keep(kept: list, item, seen: int, size: int, rng) -> None:
    """Reservoir sampling: after ``seen`` + 1 items, ``kept`` is a uniform
    sample of ``size`` of them, drawn by ``rng``."""
    if len(kept) < size:
        kept.append(item)
    else:
        j = int(rng.integers(0, seen + 1))
        if j < size:
            kept[j] = item


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _power_limits(count: int) -> list:
    """The cards' power limits in W, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return [float(x) for x in out.split()[:count]]
    except (OSError, subprocess.SubprocessError, ValueError):
        return []


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             cpu: bool = False, t_start: float | None = None,
             control: bool = False) -> dict:
    """One run of cell ``workload`` of the benchmark at ``root`` -> the
    result object. ``cpu`` runs the program's plain CPU versions (tests
    only: no device number means anything there); ``control`` puts the
    reference at the next narrower precision in the program's place."""
    t_start = time.time() if t_start is None else t_start
    bench = bspec.Bench(root)
    cell = bench.workload(workload)
    traffic = bench.traffic(cell["traffic"])
    chips = int(cell["chips"])
    devices = ([torch.device("cpu")] * chips if cpu
               else [torch.device("cuda", i) for i in range(chips)])
    entry = bench.entry(traffic["entry"])
    rng = np.random.default_rng([seed, 1])
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        warnings.simplefilter("always")
        ctx = Context(bench.config(cell["config"]), traffic, seed, devices,
                      "cpu" if cpu else None, Path(tmp))
        t_in = time.time()
        c = entry.Cell(ctx)
        call = c.control if control else c.call
        t_warm = time.time()
        for k in range(int(traffic["warm_calls"])):
            call(k)
        _sync(devices)
        _log(f"set-up: to the cell {t_in - t_start:.3f} s, inputs "
             f"{t_warm - t_in:.3f} s (the reference's part "
             f"{c.reference_s:.3f} s), warm-up {time.time() - t_warm:.3f} s")
        if not cpu:
            torch.cuda.empty_cache()
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([] if cpu else [torch.profiler.ProfilerActivity.CUDA])])
            if trace else contextlib.nullcontext())
        latencies, work, probes, kept, failed = [], [], [], [], []
        attempted = 0
        host_state = host.report()
        with prof:
            t0 = time.perf_counter()
            # the reference's own work in set-up is the benchmark's, not
            # the program's
            setup_s = time.time() - t_start - c.reference_s
            end = t0
            while attempted == 0 or end - t0 < seconds:
                ts = time.perf_counter()
                try:
                    with record_function(tr.CALL_RANGE):
                        out = call(attempted)
                except Exception:  # a failed call counts, and the loop goes on
                    if not failed:
                        _log(traceback.format_exc())
                    failed.append(attempted)
                    out = None
                end = time.perf_counter()
                if out is not None:
                    latencies.append(end - ts)
                    work.append(c.work(attempted, out))
                    probes.append((attempted, c.probe(attempted, out)))
                    _keep(kept, (attempted, out), len(probes) - 1,
                          int(traffic["check_sample"]), rng)
                attempted += 1
                out = None
        window_s = end - t0
        mem_peak = (0 if cpu else
                    max(torch.cuda.max_memory_allocated(d) for d in devices))
        device_name = "cpu" if cpu else torch.cuda.get_device_name(0)
        run = Run(setup_s, window_s, latencies, work, device_name)
        if trace:
            run.trace = tr.from_events(prof.events(),
                                       [d.index or 0 for d in devices])
            kinds = {}
            for o in run.trace.ops:
                kinds[(o.kind, o.device)] = kinds.get((o.kind, o.device), 0) + 1
            _log(f"trace: {run.trace.calls} calls, device ops {kinds}")
        fell = [str(w.message) for w in caught if FALLBACK in str(w.message)]
        if fell:
            # the run took another path than the one its cell measures
            raise RuntimeError("; ".join(fell))
        c.release()
        checks = {"differences": c.check(kept, probes, failed)}
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(workload, section):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "cpu" if cpu else "gpu", "kind": device_name,
              "count": chips, "memory_peak_bytes": int(mem_peak)}
    if not cpu:
        device["power_limit_w"] = _power_limits(chips)
    device["host"] = host_state
    result = {"correct": all(v <= 0 for v in checks.values()),
              "attempted": attempted, "failed": len(failed),
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = tr.busy_s(run.trace)
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(run.trace),
            "idle_gaps": tr.idle_by_host_range(run.trace)}
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return result


def _builds_openmp(cxx: str) -> bool:
    """True if ``cxx`` compiles and links a trivial OpenMP program."""
    if shutil.which(cxx) is None:
        return False
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            [cxx, "-fopenmp", "-x", "c++", "-", "-o", os.path.join(d, "a")],
            input="int main() { return 0; }\n", capture_output=True,
            text=True)
    return r.returncode == 0


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold, compared
    whole (``trpx_tpu_torch`` is not ``trpx_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare(chips: int) -> str | None:
    """Ready this process to drive the program on ``chips`` cards -> why
    it cannot, or None."""
    if not torch.cuda.is_available():
        return "no CUDA card (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, this machine has "
                f"{torch.cuda.device_count()}")
    # the program's host codec builds with $CXX -fopenmp: a CXX that
    # cannot would leave every header walk in pure Python
    cxx = os.environ.get("CXX")
    if cxx and not _builds_openmp(cxx):
        del os.environ["CXX"]
    _log(f"set-up: compiler probed {time.time() - T_START:.3f} s")
    import trpx_tpu_torch

    where = Path(trpx_tpu_torch.__file__).resolve().parent.parent
    if where != ROOT:
        return f"{PROGRAM} comes from {where}, not this checkout"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _log(f"set-up: process start to imports {time.time() - T_START:.3f} s")
    why = prepare(int(bspec.Bench(ROOT).workload(args.workload)["chips"]))
    if why:
        _log(f"portbench: {why}")
        return 2
    _log(f"set-up: prepared {time.time() - T_START:.3f} s")
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        _log(f"portbench: the run loaded {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
