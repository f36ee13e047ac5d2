"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the JSON file its entry names (``configs/<name>.json``);
* a traffic mix: ``portbench/traffic/<traffic>.json``, data that names the
  entry it drives (``portbench/entries/<entry>.py``) and its parameters;
* a metric: ``portbench/metrics/<name>.json``, which names a generic
  reader of ``portbench/readers.py`` and its parameters, or
  ``portbench/metrics/<name>.py`` with ``read(run, spec)``.

So a later cell, mix or metric is added as files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from . import readers

PACKAGE = "portbench"


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        self.home = self.root / PACKAGE
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    @staticmethod
    def _named(items, name: str, what: str) -> dict:
        for it in items:
            if it["name"] == name:
                return it
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.doc["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.doc["configs"], name, "config")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def entry(self, name: str):
        """The module that drives entry ``name``."""
        return _load_module(self.home / "entries" / f"{name}.py",
                            f"{PACKAGE}_entry_{name}")

    def metrics(self, workload: str, section: str) -> list:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        cell ``workload`` reports: those whose ``workloads`` list it, or
        that have no such list."""
        return [m for m in self.doc[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """``read(run)`` of metric ``name``: its ``.py`` file's ``read``,
        else the generic reader its ``.json`` file names."""
        py = self.home / "metrics" / f"{name}.py"
        if py.exists():
            mod = _load_module(py, f"{PACKAGE}_metric_{name.replace('.', '_')}")
            return lambda run: mod.read(run, {})
        spec = json.loads((self.home / "metrics" / f"{name}.json").read_text())
        fn = getattr(readers, spec["reader"])
        return lambda run: fn(run, spec)
