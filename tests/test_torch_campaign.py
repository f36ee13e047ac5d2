"""PyTorch port: the differential campaign
(``trpx_tpu_torch.tools.differential_campaign``) on the CPU. Its copies of
the JAX tool's tables and generators agree with the originals (loaded by
path); every row of its smoke tier passes on ``device="cpu"`` (the
kernels' plain versions), with the port's bytes equal to the JAX
package's native codec and, on rows of at most 262,144 values, to
``trpx_tpu.ops.encode``; a random soak passes; a one-byte corruption is a
``MISMATCH``; without a card the smoke tier's default device raises.
Tolerance: exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import trpx_tpu.ops as jops
from trpx_tpu.native import codec as jncodec
from trpx_tpu_torch import ops
from trpx_tpu_torch.ops import FrameSpec
from trpx_tpu_torch.tools import differential_campaign as camp

REPO = Path(__file__).resolve().parent.parent


def _jax_campaign():
    spec = importlib.util.spec_from_file_location(
        "differential_campaign", REPO / "tools" / "differential_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _jax_campaign()
ROWS = camp.SMOKE_TRIALS + camp.ROUTE_TRIALS


def _row_id(row):
    dt, F, n, block, kind, seed = row
    return f"{np.dtype(dt).name}-{F}x{n}-b{block}-k{kind}-s{seed}"


def test_tables_equal_the_jax_tools():
    assert camp.DTYPES == JAX.DTYPES
    assert camp.DEVICE_SHAPES == JAX.DEVICE_SHAPES
    assert camp.SMOKE_TRIALS == JAX.SMOKE_TRIALS


@pytest.mark.parametrize("row", ROWS, ids=[_row_id(r) for r in ROWS])
def test_generators_agree_with_the_jax_tools(row):
    dt, F, n, block, kind, seed = row
    ours, _ = camp.smoke_values(row)
    theirs = JAX._gen_values(np.dtype(dt), F, n, kind,
                             np.random.default_rng(seed))
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert camp._in_reference_envelope(ours, block) == \
        JAX._in_reference_envelope(theirs, block)


@pytest.mark.parametrize("fixed", [False, True])
def test_random_trials_agree_with_the_jax_tools(fixed):
    """The same master seed draws the same trials (shapes from
    ``DEVICE_SHAPES`` in a device soak, in both tools)."""
    master = np.random.default_rng(7)
    for _ in range(40):
        seed = int(master.integers(0, 2**31))
        (a, block_a), (b, block_b) = (
            camp._rand_frames(np.random.default_rng(seed), fixed),
            JAX._rand_frames(np.random.default_rng(seed), fixed))
        assert block_a == block_b
        np.testing.assert_array_equal(a, b)


#: the rows of 3.2M values spend ~15 s each in pycodec on one core: slow
_SLOW_ROWS = [pytest.param(r, marks=pytest.mark.slow, id=_row_id(r))
              if r[2] == 3_200_000 else pytest.param(r, id=_row_id(r))
              for r in ROWS]


@pytest.mark.parametrize("row", _SLOW_ROWS)
def test_smoke_row_on_the_cpu(monkeypatch, capsys, row):
    """``main(["--smoke", "--device", "cpu"])`` on a table of this one row
    returns 0; the bytes the port's device path gave equal the JAX
    package's native codec and, on small rows, its device path."""
    dt, F, n, block, kind, seed = row
    got = []
    real = ops.encode

    def spy(vals, **kw):
        arch = real(vals, **kw)
        got.append(arch.to_bytes())
        return arch

    monkeypatch.setattr(camp.ops, "encode", spy)
    monkeypatch.setattr(camp, "SMOKE_TRIALS", [row])
    monkeypatch.setattr(camp, "ROUTE_TRIALS", [])
    assert camp.main(["--smoke", "--device", "cpu"]) == 0
    assert "CAMPAIGN DONE: 1 trials, 0 failures" in capsys.readouterr().out
    vals, _ = camp.smoke_values(row)
    assert got == [jncodec.encode(vals, block=block).to_bytes()]
    if vals.size <= 262_144:
        assert got[0] == jops.encode(vals, block=block).to_bytes()


@pytest.mark.parametrize("row,route", zip(camp.ROUTE_TRIALS, [
    ("tiled", "tiled"), ("tiled", "tiled"), ("tiled", "tiled"),
    ("one-pass", "tiled"), ("one-pass", "tiled"), ("one-pass", "one-pass"),
]), ids=[_row_id(r) for r in camp.ROUTE_TRIALS])
def test_route_rows_straddle_the_routes(row, route):
    dt, F, n, block, _kind, _seed = row
    spec = FrameSpec.for_dtype(n, dt, block)
    got = ("tiled" if spec.tiled_pack(F) else "one-pass",
           "tiled" if spec.tiled(F) else "one-pass")
    assert got == route


#: the palette's shapes of at most 8,192 values: its 1M- and 3.2M-value
#: frames spend seconds each in pycodec, and the smoke rows hold them
_SMALL_SHAPES = [s for s in camp.DEVICE_SHAPES if s[0] * s[1] <= 8192]


def test_random_soak_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(camp, "DEVICE_SHAPES", _SMALL_SHAPES)
    monkeypatch.setenv("SEED", "11")
    assert camp.main(["200", "--device", "cpu"]) == 0
    assert "CAMPAIGN DONE: 200 trials, 0 failures" in capsys.readouterr().out


def test_fixed_shapes_soak_on_the_cpu(monkeypatch, capsys):
    """A device soak draws its shapes from ``DEVICE_SHAPES``, as the JAX
    tool's does (this seed's first four trials are its small shapes)."""
    seen = []
    real = camp.run_trial

    def spy(vals, block, *a):
        seen.append((vals.shape, block))
        return real(vals, block, *a)

    monkeypatch.setattr(camp, "run_trial", spy)
    monkeypatch.setenv("SEED", "1")
    assert camp.main(["4", "--device", "cpu"]) == 0
    assert "4 trials, 0 failures" in capsys.readouterr().out
    assert [(F, n, b) for (F, n), b in seen] == [
        (2, 4096, 12), (2, 4096, 12), (3, 144, 12), (1, 144, 12)]
    assert all(t in camp.DEVICE_SHAPES for t in
               [(F, n, b) for (F, n), b in seen])


def test_host_soak_touches_no_device(monkeypatch, capsys):
    """Without ``--device`` or ``--smoke`` the soak holds the host codecs
    only, on random shapes, as the JAX tool does without ``--device``."""
    def no_device(*a, **k):
        raise AssertionError("the device path ran")

    seen = []
    real = camp.run_trial

    def spy(vals, block, *a):
        seen.append((*vals.shape, block))
        return real(vals, block, *a)

    monkeypatch.setattr(camp.ops, "encode", no_device)
    monkeypatch.setattr(camp.ops, "decode", no_device)
    monkeypatch.setattr(camp, "run_trial", spy)
    monkeypatch.setenv("SEED", "12")
    assert camp.main(["30"]) == 0
    assert "30 trials, 0 failures" in capsys.readouterr().out
    assert any(t not in camp.DEVICE_SHAPES for t in seen)


def test_one_byte_corruption_is_a_mismatch(monkeypatch, capsys):
    real = ops.encode

    def corrupt(vals, **kw):
        arch = real(vals, **kw)
        payload = bytearray(arch.payload)
        payload[len(payload) // 2] ^= 0x10
        arch.payload = bytes(payload)
        return arch

    monkeypatch.setattr(camp.ops, "encode", corrupt)
    monkeypatch.setenv("SEED", "13")
    assert camp.main(["5", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("MISMATCH: device encode != pycodec @ trial 0 "
                          "seed ")
    assert "dtype" in err and "F,n=" in err and "block" in err


def test_wrong_decode_is_a_mismatch(monkeypatch, capsys):
    real = ops.decode

    def wrong(archive, dtype, **kw):
        out = real(archive, dtype, **kw).copy()
        out.flat[0] ^= 1
        return out

    monkeypatch.setattr(camp.ops, "decode", wrong)
    monkeypatch.setattr(camp, "SMOKE_TRIALS", camp.SMOKE_TRIALS[8:9])
    monkeypatch.setattr(camp, "ROUTE_TRIALS", [])
    assert camp.main(["--smoke", "--device", "cpu"]) == 1
    assert "MISMATCH: device decode mismatch @ trial 0 seed 109" in \
        capsys.readouterr().err


def test_no_reference_means_no_oracle(monkeypatch):
    monkeypatch.delenv("TRPX_REFERENCE", raising=False)
    assert camp.build_oracle() is None
    monkeypatch.setenv("TRPX_REFERENCE", str(REPO / "no-such-checkout"))
    assert camp.build_oracle() is None


def test_smoke_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        camp.main(["--smoke"])
