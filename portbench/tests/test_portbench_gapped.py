"""The gapped-image cells on the CPU: the EIGER2 X 16M module mask, and
one-image compress and decompress cells through the new entries, added to
a copy of the tiny benchmark as files and entries only."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import gaps, run, spec
from portbench.tests import tiny

ROOT = tiny.ROOT
FILL = 2**32 - 1
#: a scaled module grid: 2 x 2 modules of 40 x 24, the EIGER2's gaps of
#: 12 columns and 38 rows -> 92 x 86 pixels; a row of 92 values ends
#: inside a block of 12, so blocks straddle the rows' ends, gap rows too
TINY_GAPS = {"module_columns": 2, "module_rows": 2, "module_width": 40,
             "module_height": 24, "gap_columns": 12, "gap_rows": 38,
             "fill": FILL}
#: cell -> (traffic, entry, its rate, the per-layer metrics it reports)
CELLS = {
    "tiny_gapped.compress_image": (
        "tiny_compress_image", "compress_gapped", "encode_fps",
        ["encode.collect_ms", "encode.tiled_pack_roofline"]),
    "tiny_gapped.decompress_image": (
        "tiny_decompress_image", "decompress_gapped", "decode_fps",
        ["decode.collect_ms", "decode.walk_gather_ms",
         "decode.tiled_unpack_roofline"]),
}


@pytest.fixture(scope="module")
def gapped_root(tmp_path_factory):
    """``tiny.make``'s copy of the benchmark plus a gapped u32
    configuration and its two one-image cells, as files and entries."""
    dst = tiny.make(tmp_path_factory.mktemp("bench"))
    doc = json.loads((dst / "BENCHMARK.json").read_text())
    home = dst / "portbench"
    cfg = {"name": "tiny_gapped", "source": "tests", "height": 86,
           "width": 92, "dtype": "uint32", "block": 12, "gaps": TINY_GAPS,
           "pixels": {"poisson_mean": 0.5, "hot_pixels": 5,
                      "hot_value": 10000},
           "assumed": [], "reduced": []}
    (home / "configs" / "tiny_gapped.json").write_text(json.dumps(cfg))
    doc["configs"].append({"name": "tiny_gapped", "source": "tests",
                           "file": "portbench/configs/tiny_gapped.json",
                           "reduced": [], "why": "tests"})
    metrics = {m["name"]: m for m in doc["end_to_end"] + doc["per_layer"]}
    for cell, (traffic, entry, rate, layer) in CELLS.items():
        mix = {"entry": entry, "frames_per_call": 1, "distinct_inputs": 3,
               "pool_frames": 3, "warm_calls": 1, "check_sample": 2,
               "probe_count": 64}
        (home / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        doc["workloads"].append({"name": cell, "config": "tiny_gapped",
                                 "traffic": traffic, "chips": 1,
                                 "why": "tests"})
        for name in [rate] + layer:
            metrics[name]["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(doc))
    return dst


def test_the_eiger2_x_16m_mask():
    cfg = spec.Bench(ROOT).config("eiger2x16m_u32")
    h, w, g = cfg["height"], cfg["width"], cfg["gaps"]
    assert (h, w) == (4362, 4148) and g["fill"] == FILL
    m = gaps.mask(h, w, g)
    assert m.shape == (h, w) and int(m.sum()) == 1_250_824
    modules = np.zeros((h, w), bool)
    for i in range(8):
        for j in range(4):
            # module (row i, column j) at the published pitch
            y, x = i * (512 + 38), j * (1028 + 12)
            assert not m[y:y + 512, x:x + 1028].any()
            modules[y:y + 512, x:x + 1028] = True
    assert np.array_equal(m, ~modules)


def test_gaps_over_a_pool_and_what_is_refused():
    class Cell(gaps.OneImage):
        def __init__(self, ctx, dtype=np.uint32):
            self.ctx, self.h, self.w = ctx, 86, 92
            self.pool = np.zeros((2, 86 * 92), dtype)

    ctx = SimpleNamespace(config={"gaps": TINY_GAPS})
    pool = Cell(ctx).pool
    m = gaps.mask(86, 92, TINY_GAPS).reshape(-1)
    assert (pool[:, m] == FILL).all() and (pool[:, ~m] == 0).all()
    with pytest.raises(ValueError, match="exceeds uint16"):
        Cell(ctx, np.uint16)
    with pytest.raises(ValueError, match="does not tile"):
        gaps.mask(86, 91, TINY_GAPS)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_one_image_cells_are_correct(gapped_root, cell, trace):
    r = run.run_cell(gapped_root, cell, 2**31 + 911, 0.3, trace, cpu=True)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["differences"]["value"] == 0
    _, _, rate, layer = CELLS[cell]
    # the spans' metrics read a number; the kernels' share of their
    # roofline reads none on the CPU
    assert set(r["metrics"]) == (
        {rate, "setup_s"} if not trace
        else {m for m in layer if not m.endswith("_roofline")})


def _cell(root, entry, traffic, **changed):
    b = spec.Bench(root)
    ctx = run.Context(b.config("tiny_gapped"),
                      dict(b.traffic(traffic), **changed), 7,
                      [torch.device("cpu")], "cpu", root)
    return b.entry(entry).Cell(ctx)


def test_the_cells_see_the_gaps(gapped_root):
    m = gaps.mask(86, 92, TINY_GAPS)
    dec = _cell(gapped_root, "decompress_gapped", "tiny_decompress_image")
    enc = _cell(gapped_root, "compress_gapped", "tiny_compress_image")
    for k in range(3):
        assert dec.want(k).shape == (86, 92)
        assert (dec.want(k)[m] == FILL).all()
        assert dec.archives[k].meta.prolix_bits == 32
        assert enc.inputs[k].shape == (86, 92)
        assert (enc.inputs[k][m] == FILL).all()
    out = dec.call(0)
    assert out.shape == (86, 92) and np.array_equal(out, dec.want(0))
    arch = enc.call(1)
    assert arch.meta.dimensions == (92, 86)
    assert arch.to_bytes() == enc.references()[1].to_bytes()


@pytest.mark.parametrize("entry,traffic", [
    ("compress_gapped", "tiny_compress_image"),
    ("decompress_gapped", "tiny_decompress_image")])
def test_more_than_one_image_a_call_is_refused(gapped_root, entry, traffic):
    with pytest.raises(ValueError, match="one image a call"):
        _cell(gapped_root, entry, traffic, frames_per_call=2)
