"""PyTorch port: the entry points (``trpx_tpu_torch.graft_entry``), the
counterpart of ``tests/test_graft_entry.py``. ``entry(device="cpu")``'s
pack equals the JAX entry's on the same frames; ``dryrun_multichip`` runs
its ranks in fresh interpreters in a gloo group on the CPU, from a clean
environment that loads no JAX; without a card the default device raises.
Tolerance: exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from trpx_tpu_torch import graft_entry
from trpx_tpu_torch.ops import FrameSpec, encode_batch_plain
from trpx_tpu_torch.ops.cuda_pack import defined_words

REPO = Path(__file__).resolve().parent.parent


def test_entry_matches_the_jax_entry_on_the_cpu():
    fn, (frames,) = graft_entry.entry(device="cpu")
    jfn, (jframes,) = jentry.entry()
    spec = FrameSpec.for_dtype(512 * 512, np.uint16)
    assert frames.shape == (4, spec.n_padded) and frames.device.type == "cpu"
    np.testing.assert_array_equal(frames.numpy(), jframes)
    words, bits, maxw = fn(frames)
    jwords, jbits, jmaxw, _over = (np.asarray(a) for a in jfn(jframes))
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(maxw.numpy(), jmaxw)
    ours = words.numpy().view(np.uint32)
    for f, k in enumerate(defined_words(bits).tolist()):
        np.testing.assert_array_equal(ours[f, :k], jwords[f, :k])


def test_entry_is_the_routed_pack():
    fn, (frames,) = graft_entry.entry(device="cpu")
    spec = FrameSpec.for_dtype(512 * 512, np.uint16)
    for got, want in zip(fn(frames), encode_batch_plain(spec, frames)):
        assert torch.equal(got, want)


def test_dryrun_multichip_clean_env():
    """Four ranks on the CPU, launched from a process with the JAX
    settings scrubbed, which loads no JAX."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    code = ("import sys\n"
            "import trpx_tpu_torch.graft_entry as g\n"
            "ranks = g.dryrun_multichip(4, device='cpu')\n"
            "assert [r['rank'] for r in ranks] == [0, 1, 2, 3], ranks\n"
            "assert 'jax' not in sys.modules\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                       capture_output=True, text=True, timeout=540)
    assert r.returncode == 0, f"dryrun failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.strip().splitlines()[-1] == "OK"


def test_dryrun_multichip_one_rank():
    ranks = graft_entry.dryrun_multichip(1, device="cpu")
    # the plain versions run on the CPU: no kernel launches
    assert ranks == [{"rank": 0, "launches": dict.fromkeys(
        ("pack", "pack_tiled", "unpack", "unpack_tiled"), 0)}]


def test_dryrun_multichip_reports_a_failing_rank(monkeypatch):
    """A rank that cannot run makes the launcher raise with its output."""
    monkeypatch.setattr(sys, "executable", "false")
    with pytest.raises(RuntimeError, match=r"rank exit codes \[1, 1\]"):
        graft_entry.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(2),
    lambda: graft_entry.main([]),
], ids=["entry", "dryrun_multichip", "main"])
def test_default_device_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
