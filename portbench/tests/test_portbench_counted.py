"""The counted 8-bit cell on the CPU: a scaled Gatan K3 movie cell
through the new entry (``decompress_counted``) and pool
(``portbench.counted``), added to a copy of the tiny benchmark as files
and entries only; its control; the pool's refusal of counts past 255; and
the reader of the bytes the unpack writes (``decode.unpack_out_mb``)."""

import json

import numpy as np
import pytest
import torch

from portbench import counted, run, spec
from portbench.tests import tiny

ROOT = tiny.ROOT
CELL = "tiny_counted.decompress_movie"
#: rows of 53 u8 values: row starts at odd bytes, frames ending mid-block
H, W, F = 37, 53, 4
#: the per-layer metrics the cell reads on the CPU: the spans' and the
#: counters' (no kernel, so no roofline, idle or unattributed share)
LAYER = {"decode.walk_gather_ms", "decode.ingest_ms", "decode.collect_ms",
         "decode.fresh_host_mb", "decode.host_write_mb",
         "decode.unpack_out_mb"}


def _config(**pixels) -> dict:
    return {"name": "tiny_counted", "source": "tests", "height": H,
            "width": W, "dtype": "uint8", "block": 12,
            "pixels": dict({"poisson_mean": 0.86, "hot_pixels": 0,
                            "hot_value": 0}, **pixels),
            "assumed": [], "reduced": []}


@pytest.fixture(scope="module")
def counted_root(tmp_path_factory):
    """``tiny.make``'s copy of the benchmark plus a scaled counted u8
    configuration and its movie cell, as files and entries."""
    dst = tiny.make(tmp_path_factory.mktemp("bench"))
    doc = json.loads((dst / "BENCHMARK.json").read_text())
    home = dst / "portbench"
    (home / "configs" / "tiny_counted.json").write_text(json.dumps(_config()))
    doc["configs"].append({"name": "tiny_counted", "source": "tests",
                           "file": "portbench/configs/tiny_counted.json",
                           "reduced": [], "why": "tests"})
    mix = {"entry": "decompress_counted", "frames_per_call": F,
           "distinct_inputs": 3, "pool_frames": 3 * F, "warm_calls": 1,
           "check_sample": 2, "probe_count": 64}
    (home / "traffic" / "tiny_movie.json").write_text(json.dumps(mix))
    doc["workloads"].append({"name": CELL, "config": "tiny_counted",
                             "traffic": "tiny_movie", "chips": 1,
                             "why": "tests"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in LAYER | {"decode_fps", "decode.tiled_unpack_roofline",
                                 "decode.kernel_roofline"}:
            m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(doc))
    return dst


def _cell(root, **config):
    b = spec.Bench(root)
    cfg = dict(b.config("tiny_counted"), **config)
    ctx = run.Context(cfg, b.traffic("tiny_movie"), 2**31 + 77,
                      [torch.device("cpu")], "cpu", root)
    return b.entry("decompress_counted").Cell(ctx)


@pytest.mark.parametrize("trace", [False, True])
def test_the_movie_cell_is_correct(counted_root, trace):
    r = run.run_cell(counted_root, CELL, 2**31 + 911, 0.3, trace, cpu=True)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["differences"]["value"] == 0
    assert set(r["metrics"]) == (LAYER if trace
                                 else {"decode_fps", "setup_s"})


def test_the_control_differs(counted_root):
    r = run.run_cell(counted_root, CELL, 2**31 + 913, 0.3, False, cpu=True,
                     control=True)
    assert r["correct"] is False
    assert r["checks"]["differences"]["value"] > 0


def test_the_pool_and_the_calls_are_uint8(counted_root):
    c = _cell(counted_root)
    assert c.dtype == np.uint8 and c.pool.dtype == np.uint8
    assert c.pool.shape == (3 * F, H * W) and c.ctx.config["dtype"] == "uint8"
    # the draw narrowed value for value: Poisson(0.86) counts, some past 3
    assert c.pool.max() > 3 and c.pool.max() < 32
    assert 0.7 < c.pool.mean() < 1.0
    assert all(a.meta.prolix_bits <= 8 for a in c.archives)
    out = c.call(1)
    assert out.dtype == np.uint8 and out.shape == (F, H, W)
    np.testing.assert_array_equal(out, c.want(1))
    ctl = c.control(1)
    assert ctl.dtype == np.uint8 and ctl.max() == 3
    assert np.count_nonzero(ctl != c.want(1)) > 0


def test_counts_past_255_are_refused(counted_root):
    with pytest.raises(ValueError, match="count of 256"):
        counted.narrow(np.array([[0, 255, 256]], np.uint16))
    np.testing.assert_array_equal(
        counted.narrow(np.array([[0, 7, 255]], np.uint16)), [[0, 7, 255]])
    with pytest.raises(ValueError, match="does not fit in uint8"):
        _cell(counted_root, pixels={"poisson_mean": 0.86, "hot_pixels": 1,
                                    "hot_value": 300})
    with pytest.raises(ValueError, match="uint8 configuration"):
        _cell(counted_root, dtype="uint16")


def test_unpack_out_mb_reads_a_recorded_run(counted_root, monkeypatch):
    from trpx_tpu_torch.runtime import metrics

    monkeypatch.setattr(metrics, "_COUNTS", {})
    r = run.run_cell(counted_root, CELL, 2**31 + 915, 0.3, True, cpu=True)
    # one byte a pixel: the u8 lanes of every call, warm-up ones too
    assert r["metrics"]["decode.unpack_out_mb"]["value"] == pytest.approx(
        F * H * W / 1e6)
    assert r["metrics"]["decode.unpack_out_mb"]["unit"] == "MB/call"
    read = spec.Bench(counted_root).reader("decode.unpack_out_mb")
    # a program that keeps no such counter reads nothing
    monkeypatch.setattr(metrics, "_COUNTS", {"calls.api.decompress": 3})
    assert read(None) is None
    monkeypatch.setattr(metrics, "_COUNTS", {})
    assert read(None) is None
