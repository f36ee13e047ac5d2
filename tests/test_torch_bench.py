"""PyTorch port: the bench (``trpx_tpu_torch.bench``) on the CPU at small
sizes. Its configurations run with their guards on the kernels' plain
versions, its summary has the key set of ``bench.py``'s JSON
(``BENCH_r05.json``), its synthesized frames encode to the JAX package's
bytes, and without a card its default device raises. Tolerance: exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from trpx_tpu.native import codec as jncodec
from trpx_tpu.ops import coding as jcoding
from trpx_tpu_torch import bench, ops
from trpx_tpu_torch.ops import FrameSpec

REPO = Path(__file__).resolve().parent.parent
BENCH_KEYS = list(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bench_512_runs_with_its_guard_on_the_cpu():
    r = bench.bench_512(F=4, reps=1, device="cpu", n2=2)
    # 4 frames: the one-pass pack, the tiled unpack (FrameSpec routes)
    assert (r["pack"], r["unpack"]) == ("encode_batch", "decode_batch_tiled")
    assert r["frames"] == 4
    for k in ("enc_fps", "dec_fps", "walk_fps", "foreign_fps",
              "pipelined_fps"):
        assert r[k] > 0
    assert r["foreign_fps"] < r["dec_fps"]
    assert 0 < r["ratio"] < 1


def test_bench_big_runs_with_its_guard_on_the_cpu():
    r = bench.bench_big(reps=1, edge=256, F=2, device="cpu")
    assert (r["pack"], r["unpack"]) == ("encode_batch", "decode_batch_tiled")
    assert r["enc_fps"] > 0 and r["pipelined_fps"] > 0


def test_guard_refuses_a_wrong_archive(monkeypatch):
    """A pack that loses one bit makes the bench raise before it times
    anything."""
    from trpx_tpu_torch.ops import coding

    real = coding.encode_batch

    def broken(spec, x):
        words, bits, maxw = real(spec, x)
        words = words.clone()
        words[0, 0] ^= 1
        return words, bits, maxw

    monkeypatch.setattr(coding, "encode_batch", broken)
    with pytest.raises(bench.GuardError, match="native codec"):
        bench.bench_512(F=2, reps=1, device="cpu", n2=1)


def test_guard_refuses_a_wrong_decode(monkeypatch):
    from trpx_tpu_torch.ops import coding

    real = coding.decode_batch_tiled

    def broken(spec, words, widths, out_dtype, tile_blocks=None):
        out = real(spec, words, widths, out_dtype, tile_blocks).clone()
        out[-1, -1] += 1
        return out

    monkeypatch.setattr(coding, "decode_batch_tiled", broken)
    with pytest.raises(bench.GuardError, match="frames"):
        bench.bench_big(reps=1, edge=128, F=2, device="cpu", n2=1)


def _result(fps):
    return dict(enc_fps=fps, dec_fps=2 * fps, walk_fps=3 * fps,
                foreign_fps=4 * fps, pipelined_fps=5 * fps)


def test_summary_has_the_bench_py_keys():
    out = bench.summary(_result(1000.0),
                        {2048: _result(60.0), 4096: _result(15.0)})
    assert list(out) == BENCH_KEYS
    assert out["metric"] == "encode_512x512_u16_frames_per_s"
    assert out["value"] == 1000.0 and out["unit"] == "frames/s"
    assert out["vs_baseline"] == round(1000.0 / 1712.0, 2)
    assert out["decode_vs_reference"] == round(2000.0 / 2061.0, 2)
    assert out["encode_2048_vs_reference"] == round(60.0 / 54.0, 2)
    assert out["encode_4096_vs_reference"] == round(15.0 / 13.5, 2)
    assert out["foreign_pipelined_4096x4096_u32_frames_per_s"] == 75.0
    json.dumps(out)


def test_reference_constants_match_bench_py():
    import bench as jbench

    for k in ("REFERENCE_FPS", "REFERENCE_DECODE_FPS", "REFERENCE_2K_FPS",
              "REFERENCE_4K_FPS"):
        assert getattr(bench, k) == getattr(jbench, k)


@pytest.mark.parametrize("dtype,edge,hot", [
    (np.uint16, 512, bench.HOT_U16),
    (np.uint32, 256, bench.HOT_U32),
    (np.uint32, 100, bench.HOT_U32),
])
def test_synthesized_frames_encode_to_the_jax_bytes(dtype, edge, hot):
    """The bench's frames, encoded by the port on the CPU, give the bytes
    of the JAX package's native codec and of its device path."""
    spec = FrameSpec.for_dtype(edge * edge, dtype)
    x = bench.synth(spec, 3, hot, seed=0, device="cpu")
    assert x.shape == (3, spec.n_padded) and x.dtype == spec.torch_dtype
    frames = bench._host_frames(spec, x)
    assert frames.dtype == dtype
    assert not x[:, spec.n:].view(torch.int16 if dtype == np.uint16
                                  else torch.int32).any()
    # Poisson(3) background, HOT_PIXELS hot pixels a frame at most
    assert ((frames == hot).sum(axis=1) <= bench.HOT_PIXELS).all()
    assert ((frames == hot).sum(axis=1) >= bench.HOT_PIXELS - 5).all()
    assert abs(float(frames[frames != hot].mean()) - 3.0) < 0.1
    blob = ops.encode(frames, device="cpu").to_bytes()
    assert blob == jncodec.encode(frames).to_bytes()
    assert blob == jcoding.encode(frames).to_bytes()


def test_synth_is_seeded():
    spec = FrameSpec.for_dtype(64 * 64, np.uint16)
    a = bench.synth(spec, 2, 60000, 1, "cpu")
    assert torch.equal(a, bench.synth(spec, 2, 60000, 1, "cpu"))
    assert not torch.equal(a, bench.synth(spec, 2, 60000, 2, "cpu"))


def test_describe_names_the_routes():
    r = bench.bench_512(F=2, reps=1, device="cpu", n2=1)
    line = bench.describe("512x512 u16", r, torch.device("cpu"))
    assert "[encode_batch]" in line and "[decode_batch_tiled]" in line
    assert "TB/s" not in line   # no share of the card's rate off the card


@pytest.mark.parametrize("call", [
    lambda: bench.bench_512(F=2, reps=1),
    lambda: bench.bench_big(reps=1, edge=64, F=2),
    lambda: bench.main(["2", "1"]),
], ids=["bench_512", "bench_big", "main"])
def test_default_device_without_a_card_raises(monkeypatch, call):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
