"""PyTorch port: the scaling tool (``trpx_tpu_torch.tools.scaling``) and the
walk probe (``tools.walk_bench``) on the CPU. The CPU run of the scaling
tool prints its JSON line, says its numbers mean nothing, and gives a
null efficiency on one device; without a card its default devices raise.
The walk probe runs on the port's native walker.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trpx_tpu_torch.tools import scaling, walk_bench

REPO = Path(__file__).resolve().parent.parent


def _json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cpu_run_prints_its_json_line():
    r = subprocess.run(
        [sys.executable, "-m", "trpx_tpu_torch.tools.scaling", "2",
         "--device", "cpu", "--devices", "2", "--reps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = _json(r.stdout)
    assert got["device"] == "cpu" and got["devices"] == 2
    assert set(got["frames_per_s"]) == {"1", "2"}
    assert set(got["scaling_efficiency"]) == {"2"}
    assert "mean nothing" in got["note"]
    assert "2 devices" in r.stderr


def test_one_device_result_is_null(capsys):
    assert scaling.main(["2", "--device", "cpu", "--reps", "1"]) == 0
    got = _json(capsys.readouterr().out)
    assert got["scaling_efficiency"] is None
    assert got["reason"] == "one device"
    assert got["frames_per_s"]["1"] > 0


def test_measure_counts_every_shard(monkeypatch):
    """N devices encode N x frames_per_dev frames, split as ShardedCodec
    splits them: each timed step is a whole ``encode_shards`` of them, its
    size table over every frame."""
    steps = []
    real = scaling.ShardedCodec.encode_shards

    def spy(self, frames, n_frames):
        res = real(self, frames, n_frames)
        steps.append((self.ndev, frames.shape, n_frames, len(res.nbytes)))
        return res

    monkeypatch.setattr(scaling.ShardedCodec, "encode_shards", spy)
    spec = scaling.FrameSpec.for_dtype(64 * 64, np.uint16)
    fps = scaling.measure(spec, [torch.device("cpu")] * 3, 2, reps=2)
    assert fps > 0
    # a warm step, then the two timed ones
    assert steps == [(3, (6, 64 * 64), 6, 6)] * 3


def test_only_cpu_takes_a_device_argument():
    with pytest.raises(ValueError, match="cpu"):
        scaling.main(["--device", "meta"])


def test_default_devices_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        scaling.main([])


def test_walk_bench_runs(capsys):
    assert walk_bench.main(["4", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("512^2 u16 lam3:") and "prolix 16" in out[0]
    assert out[1].startswith("2048^2 u32 overflow:") and "wide=1" in out[1]


def test_walk_bench_frames_walk_to_the_encoder_offsets():
    frames = walk_bench.synth(3, 1000, np.uint32, 2_000_000_000, seed=2)
    payload, fstarts, prolix = walk_bench.native.encode_frames(
        frames, 12, False)
    _w, _o, starts = walk_bench.native.walk(
        walk_bench.native.padded_buffer(payload), 3, 1000, 12)
    np.testing.assert_array_equal(starts, fstarts)
    assert prolix == 31
