"""The host's state when a run's window opens, read from ``/proc`` and
``/sys`` (Linux; what a machine lacks reads None).

Host-clock metrics move with what the host does besides the program. A run
reports, beside its device (``device["host"]``), the CPUs it may use, the
torch threads, the memory available and the transparent-huge-page setting,
so that runs which read far apart can be told apart by their host. The
chip's sandbox offers no ``/proc/vmstat``, no THP setting and a
``/proc/stat`` of zeros, so stolen CPU time and page-fault counts cannot be
read there.
"""

from __future__ import annotations

import os

import torch


def _mem_available() -> int | None:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def _thp() -> str | None:
    """The bracketed choice of ``always [madvise] never``."""
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            text = f.read()
    except OSError:
        return None
    return text[text.find("[") + 1:text.find("]")] if "[" in text else text.strip()


def report() -> dict:
    return {"cpus": os.cpu_count(),
            "cpus_allowed": len(os.sched_getaffinity(0))
            if hasattr(os, "sched_getaffinity") else None,
            "torch_threads": torch.get_num_threads(),
            "mem_available_bytes": _mem_available(),
            "thp": _thp()}
