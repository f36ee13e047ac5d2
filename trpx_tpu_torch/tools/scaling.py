"""Scaling efficiency of the sharded encode over the cards of one host:
the counterpart of ``tools/tpu_scaling.py``.

    python -m trpx_tpu_torch.tools.scaling [frames_per_dev] [--reps R]
    python -m trpx_tpu_torch.tools.scaling --device cpu --devices K

Encodes ``frames_per_dev`` (default 32) 512x512 uint16 frames per card,
Poisson(3) from a seed, with ``ShardedCodec(spec, devices[:N]).
encode_shards`` for N = 1, 2, 4, ... cards, and reports fps(N), from the
median wall time of a whole step: host frames in, each shard's pad and
upload, its pack on its card, the words back on the host and the size
and offset tables. It also reports the scaling efficiency fps(N) / (N x
fps(1)). With one card the efficiency is null, with the reason: it is
never estimated.

``--device cpu --devices K`` runs K shards of the kernels' plain versions
on the CPU: it exercises the code for tests, and its numbers mean
nothing, as its output says.

Prints a line per card count on stderr and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import api as _api
from ..ops.coding import FrameSpec
from ..parallel import ShardedCodec, default_devices

#: values per frame of the measured encode (512x512)
N_VALUES = 512 * 512


def measure(spec: FrameSpec, devices, frames_per_dev: int,
            reps: int = 5) -> float:
    """Frames/s of ``ShardedCodec(spec, devices).encode_shards`` on
    ``frames_per_dev`` host uint16 frames per device: the median wall time
    of `reps` whole steps after a warm one."""
    codec = ShardedCodec(spec, devices)
    F = frames_per_dev * codec.ndev
    frames = np.random.default_rng(0).poisson(
        3.0, (F, spec.n)).astype(np.uint16)
    codec.encode_shards(frames, F)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        codec.encode_shards(frames, F)
        ts.append(time.perf_counter() - t0)
    return F / statistics.median(ts)


def run(devices, frames_per_dev: int = 32, reps: int = 5) -> dict:
    """fps(N) for N = 1, 2, 4, ... up to the number of `devices`, and the
    scaling efficiency of each N > 1 (null with one device)."""
    spec = FrameSpec.for_dtype(N_VALUES, np.uint16)
    fps = {}
    nd = 1
    while nd <= len(devices):
        fps[nd] = measure(spec, devices[:nd], frames_per_dev, reps)
        eff = fps[nd] / (nd * fps[1])
        print(f"{nd:3d} devices: {fps[nd]:12,.1f} frames/s   scaling "
              f"efficiency {eff:.3f}", file=sys.stderr, flush=True)
        nd *= 2
    cuda = devices[0].type == "cuda"
    out = {
        "device": torch.cuda.get_device_name(devices[0]) if cuda
        else str(devices[0]),
        "devices": len(devices),
        "frames_per_dev": frames_per_dev,
        "frame": "512x512 u16",
        "timed": "ShardedCodec.encode_shards, host frames to host words, "
                 "median wall time",
        "frames_per_s": {str(k): v for k, v in fps.items()},
        "scaling_efficiency": ({str(k): v / (k * fps[1])
                                for k, v in fps.items() if k > 1}
                               if len(fps) > 1 else None),
    }
    if len(fps) == 1:
        out["reason"] = "one card" if cuda else "one device"
    if not cuda:
        out["note"] = ("the kernels' plain versions on the CPU: these "
                       "numbers mean nothing")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpx_tpu_torch.tools.scaling",
        description="Scaling efficiency of the sharded encode.")
    ap.add_argument("frames_per_dev", nargs="?", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: every card; 'cpu' with --devices K runs "
                         "K CPU shards (a test of the code, not a "
                         "measurement)")
    ap.add_argument("--devices", type=int, default=1,
                    help="CPU shards of --device cpu (default 1)")
    a = ap.parse_args(argv)
    if a.device is None:
        devices = default_devices()
    else:
        dev = _api._torch_device(a.device)
        if dev.type != "cpu":
            raise ValueError("--device takes 'cpu' only; the default runs "
                             "on every card")
        devices = [dev] * a.devices
    print(json.dumps(run(devices, a.frames_per_dev, a.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
