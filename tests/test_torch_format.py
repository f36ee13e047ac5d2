"""PyTorch port: its own copies of the format layer (``format``), the
``.trpx`` file layer (``io.trpx``) and the native host codec (``native``)
held against the JAX package's on the golden vectors of
tests/test_format_golden.py and on the shapes, dtypes and data kinds of
the differential campaign's smoke tier (tools/differential_campaign.py):
archive bytes, headers, walk tables, ``.trpx.idx`` sidecars and frame
subsets. Tolerance: exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import trpx_tpu.format as jfmt
import trpx_tpu_torch.format as tfmt
from test_format_golden import GOLDEN
from trpx_tpu import native as jnative
from trpx_tpu.io import trpx as jio
from trpx_tpu.native import codec as jncodec
from trpx_tpu_torch import native as tnative
from trpx_tpu_torch.io import trpx as tio
from trpx_tpu_torch.native import codec as tncodec

REPO = Path(__file__).resolve().parent.parent


def _campaign():
    spec = importlib.util.spec_from_file_location(
        "differential_campaign", REPO / "tools" / "differential_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CAMPAIGN = _campaign()


@pytest.mark.parametrize("name,vals,dtype,block,attrs,payload_hex", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_vectors_match_jax_format(name, vals, dtype, block, attrs,
                                         payload_hex):
    arr = np.array(vals, dtype=dtype)
    ours, ref = tfmt.encode(arr, block=block), jfmt.encode(arr, block=block)
    assert ours.payload == bytes.fromhex(payload_hex.replace(" ", ""))
    assert ours.to_bytes() == ref.to_bytes()
    blob = ours.to_bytes()
    assert vars(tfmt.parse_header(blob)[0]) == vars(jfmt.parse_header(blob)[0])
    assert tfmt.emit_header(ours.meta) == jfmt.emit_header(ref.meta)
    np.testing.assert_array_equal(tfmt.decode(ours, dtype),
                                  jfmt.decode(ref, dtype))
    flat = arr.reshape(1, -1)
    assert tncodec.encode(flat, block=block).payload == ours.payload
    np.testing.assert_array_equal(
        tncodec.decode(tfmt.TrpxArchive.from_bytes(blob), dtype),
        jncodec.decode(jfmt.TrpxArchive.from_bytes(blob), dtype))


@pytest.mark.parametrize(
    "dtype,F,n,block,kind,seed", _CAMPAIGN.SMOKE_TRIALS,
    ids=[f"{np.dtype(t[0]).name}-{t[1]}x{t[2]}-b{t[3]}-k{t[4]}"
         for t in _CAMPAIGN.SMOKE_TRIALS])
def test_smoke_trials_match_jax_format(tmp_path, dtype, F, n, block, kind,
                                       seed):
    fr = _CAMPAIGN._gen_values(np.dtype(dtype), F, n, kind,
                               np.random.default_rng(seed))
    ours = tncodec.encode(fr, block=block, dimensions=(n,))
    ref = jncodec.encode(fr, block=block, dimensions=(n,))
    blob = ours.to_bytes()
    assert blob == ref.to_bytes()
    np.testing.assert_array_equal(ours.frame_index, ref.frame_index)
    if fr.size <= 20_000:   # the spec-as-code codecs, where they are quick
        assert tfmt.encode(list(fr), block=block,
                           dimensions=(n,)).to_bytes() == blob
    # the serial walk's tables
    for a, b in zip(tnative.walk(ours.payload, F, n, block),
                    jnative.walk(ref.payload, F, n, block)):
        np.testing.assert_array_equal(a, b)
    # files with a v2 sidecar, read back by each package
    pa, pb = tmp_path / "a.trpx", tmp_path / "b.trpx"
    tio.write_trpx(tfmt.TrpxArchive.from_bytes(blob), pa, index=True)
    jio.write_trpx(jfmt.TrpxArchive.from_bytes(blob), pb, index=True)
    assert pa.read_bytes() == pb.read_bytes()
    assert Path(f"{pa}.idx").read_bytes() == Path(f"{pb}.idx").read_bytes()
    a, b = tio.read_trpx(pa), jio.read_trpx(pb)
    np.testing.assert_array_equal(a.width_table, b.width_table)
    np.testing.assert_array_equal(tio.cached_frame_offsets(a),
                                  jio.cached_frame_offsets(b))
    for sel in (F - 1, slice(0, F, 2), [F - 1, 0]):
        sa, sb = tio.subset_frames(a, sel), jio.subset_frames(b, sel)
        assert sa.to_bytes() == sb.to_bytes()
        np.testing.assert_array_equal(sa.frame_index, sb.frame_index)
        np.testing.assert_array_equal(sa.width_table, sb.width_table)
    np.testing.assert_array_equal(tncodec.decode(a, fr.dtype), fr)


def test_native_builds_into_the_port(monkeypatch):
    """The port's host codec is built from its own source into its
    git-ignored build directory, whatever TRPX_NATIVE_CACHE says."""
    monkeypatch.setenv("TRPX_NATIVE_CACHE", "/nonexistent")
    assert tnative.available()
    assert tnative._cache_dir() == (REPO / "trpx_tpu_torch" / "_build"
                                    / "native")
    assert tnative._SRC == REPO / "trpx_tpu_torch" / "native" \
        / "host_codec.cpp"


def test_trpx_io_source_is_the_jax_packages():
    """``io/trpx.py`` is a verbatim copy: its imports of the package
    (``native``, ``_fallback``, ``format``) resolve to the port's own."""
    ours = (REPO / "trpx_tpu_torch" / "io" / "trpx.py").read_text()
    assert ours == (REPO / "trpx_tpu" / "io" / "trpx.py").read_text()
    assert "from .._fallback import warn_once" in ours


def test_sidecar_walk_fallback_warns_once_as_jax(tmp_path, monkeypatch):
    """A sidecar write whose native walk fails walks in pure Python and
    gives one RuntimeWarning at site ``io.sidecar_walk``, the JAX
    package's message under the port's prefix; a second write gives none,
    and both packages' sidecars are the same bytes."""
    import warnings

    from trpx_tpu import _fallback as jfallback
    from trpx_tpu_torch import _fallback as tfallback

    monkeypatch.setattr(jfallback, "_seen", set())
    monkeypatch.setattr(tfallback, "_seen", set())

    def broken(*a, **k):
        raise RuntimeError("native walk unavailable")

    monkeypatch.setattr(tnative, "walk", broken)
    monkeypatch.setattr(jnative, "walk", broken)
    rng = np.random.default_rng(34)
    stack = rng.poisson(3.0, size=(4, 700)).astype(np.uint16)
    blob = tncodec.encode(stack).to_bytes()   # no frame index: a full walk
    for call in range(2):
        msgs = {}
        for name, fmt, io in (("ours", tfmt, tio), ("theirs", jfmt, jio)):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                io.write_trpx(fmt.TrpxArchive.from_bytes(blob),
                              tmp_path / f"{name}.trpx", index=True)
            msgs[name] = [str(w.message) for w in rec
                          if "fallback at io.sidecar_walk" in str(w.message)]
        assert len(msgs["ours"]) == len(msgs["theirs"]) == (0 if call else 1)
        if not call:
            assert msgs["ours"][0] == (
                "trpx_tpu_torch fallback at io.sidecar_walk (serial "
                "pure-Python walk for the sidecar index): RuntimeError: "
                "native walk unavailable")
            assert msgs["ours"][0].replace("trpx_tpu_torch", "trpx_tpu",
                                           1) == msgs["theirs"][0]
        assert (tmp_path / "ours.trpx.idx").read_bytes() == \
            (tmp_path / "theirs.trpx.idx").read_bytes()
