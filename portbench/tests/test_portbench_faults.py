"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path on the CPU; and true without."""

import numpy as np
import pytest

from portbench import run
from portbench.tests import tiny

CELLS = {c[3]: c[0] for c in tiny.CELLS}   # entry -> tiny cell


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def go(root, cell, **kw):
    return run.run_cell(root, cell, 2**33 + 5, 0.3, False, cpu=True, **kw)


@pytest.mark.parametrize("entry", list(CELLS))
def test_sound_runs_are_correct(tiny_root, entry):
    r = go(tiny_root, CELLS[entry])
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("entry", list(CELLS))
def test_the_control_is_not_correct(tiny_root, entry):
    r = go(tiny_root, CELLS[entry], control=True)
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["differences"]["value"] > 0


def _stale(fn):
    """The first answer, returned again for every later call."""
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return wrapped


def plant(monkeypatch, entry, fault):
    from trpx_tpu_torch import api, ops
    from trpx_tpu_torch.ops import coding
    from trpx_tpu_torch.parallel import ShardedCodec
    from trpx_tpu_torch.runtime import stream

    encode = entry in ("compress", "sharded_encode")
    if fault == "answer_altered":
        if encode:
            real = coding.assemble_archive

            def altered(*a, **k):
                arch = real(*a, **k)
                p = bytearray(arch.payload)
                p[len(p) // 2] ^= 0x10
                arch.payload = bytes(p)
                return arch
            monkeypatch.setattr(coding, "assemble_archive", altered)
        else:
            real = coding.narrow_values

            def altered(vals, dtype):
                out = real(vals, dtype).copy()
                out.reshape(-1)[out.size // 2] += 1
                return out
            monkeypatch.setattr(coding, "narrow_values", altered)
    elif fault == "half_the_batch":
        if entry == "compress":
            real = ops.encode
            monkeypatch.setattr(ops, "encode", lambda frames, **k: real(
                frames[: len(frames) // 2], **k))
        elif entry == "sharded_encode":
            real = ShardedCodec._encode_local
            monkeypatch.setattr(ShardedCodec, "_encode_local",
                                lambda self, f: real(self, f[: len(f) // 2]))
        elif entry == "decompress_bytes":
            real = stream.iter_decode

            def every_other(*a, **k):
                for i, chunk in enumerate(real(*a, **k)):
                    yield chunk if i % 2 == 0 else np.zeros_like(chunk)
            monkeypatch.setattr(stream, "iter_decode", every_other)
        else:
            real = ops.decode

            def half(archive, dtype, **k):
                out = real(archive, dtype, **k)
                out[len(out) // 2:] = 0
                return out
            monkeypatch.setattr(ops, "decode", half)
    elif fault == "state_unchanged":
        if entry == "compress":
            monkeypatch.setattr(api, "compress", _stale(api.compress))
        elif entry == "sharded_encode":
            monkeypatch.setattr(ShardedCodec, "encode",
                                _stale(ShardedCodec.encode))
        else:
            monkeypatch.setattr(api, "decompress", _stale(api.decompress))
    elif fault == "exchange_left_out":
        real = ShardedCodec._collect_local

        def first_shard_only(self, flights):
            words, bits, maxw = real(self, flights)
            words[flights[0][1]:] = 0
            return words, bits, maxw
        monkeypatch.setattr(ShardedCodec, "_collect_local", first_shard_only)


FAULTS = [(e, f) for e in CELLS
          for f in ("answer_altered", "half_the_batch", "state_unchanged")]
FAULTS.append(("sharded_encode", "exchange_left_out"))


@pytest.mark.parametrize("entry,fault", FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, entry, fault):
    plant(monkeypatch, entry, fault)
    r = go(tiny_root, CELLS[entry])
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("entry", list(CELLS))
def test_a_call_that_never_answers_is_not_correct(tiny_root, monkeypatch,
                                                 entry):
    from trpx_tpu_torch import api
    from trpx_tpu_torch.parallel import ShardedCodec

    def raising(real):
        count = [0]

        def wrapped(*a, **k):
            count[0] += 1
            # the tiny mixes warm with one call: the second call is the
            # window's first, which every run makes however slow the host
            if count[0] == 2:
                raise RuntimeError("planted")
            return real(*a, **k)
        return wrapped

    if entry == "sharded_encode":
        monkeypatch.setattr(ShardedCodec, "encode",
                            raising(ShardedCodec.encode))
    elif entry == "compress":
        monkeypatch.setattr(api, "compress", raising(api.compress))
    else:
        monkeypatch.setattr(api, "decompress", raising(api.decompress))
    r = go(tiny_root, CELLS[entry])
    assert r["failed"] == 1 and not r["correct"]


def test_a_fallback_fails_the_run(tiny_root, monkeypatch):
    from trpx_tpu_torch.ops import coding

    def stale(*a, **k):
        raise ValueError("planted stale sidecar")
    monkeypatch.setattr(coding, "validate_tables", stale)
    monkeypatch.setattr("trpx_tpu_torch._fallback._seen", set())
    with pytest.raises(RuntimeError, match="trpx_tpu_torch fallback"):
        go(tiny_root, CELLS["decompress_path"])
