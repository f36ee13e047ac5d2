"""PyTorch port, decode: the unpack kernel's plain version (CPU tensors)
against the JAX package and the host codecs.

Inputs are made with numpy from fixed seeds and go to both packages. The
tolerance is exact (lossless integer codec). The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from test_torch_pack import U16_CASES, _any_frames, u16_frames
from trpx_tpu.format import pycodec as jpycodec
from trpx_tpu.ops import coding as jcoding
from trpx_tpu.ops import pallas_unpack
from trpx_tpu_torch.ops import coding as tcoding
from trpx_tpu_torch.format import pycodec
from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops.cuda_unpack import (
    decode_batch,
    decode_batch_plain,
    decoded_dtype,
)


def _foreign(arch):
    """The archive as a reader of its bytes sees it: no frame index."""
    return pycodec.TrpxArchive.from_bytes(arch.to_bytes())


def _jax(arch):
    """The same bytes as an archive of the JAX package."""
    return jpycodec.TrpxArchive.from_bytes(arch.to_bytes())


@pytest.mark.parametrize("kind,n", U16_CASES)
def test_u16_decode_matches_pallas_interpret(kind, n):
    fr = u16_frames(kind, n)
    arch = ncodec.encode(fr)
    ours = tcoding.decode(_foreign(arch), np.uint16, device="cpu")
    ref = pallas_unpack.decode(_jax(arch), np.uint16, interpret=True)
    assert ours.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, fr)


def test_flagship_512_u16_decode_matches_native():
    rng = np.random.default_rng(513)
    fr = rng.poisson(3.0, (2, 512 * 512)).astype(np.uint16)
    fr[:, rng.integers(0, 512 * 512, 200)] = 65535
    arch = ncodec.encode(fr)
    np.testing.assert_array_equal(
        tcoding.decode(_foreign(arch), np.uint16, device="cpu"), fr)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint32,
                                   np.int32])
@pytest.mark.parametrize("n", [1, 13, 1001])
def test_other_dtypes_decode_losslessly(dtype, n):
    fr = _any_frames(dtype, n, seed=n + 1)
    arch = ncodec.encode(fr)
    out = tcoding.decode(_foreign(arch), dtype, device="cpu")
    assert out.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, fr)


@pytest.mark.parametrize("target", [np.int16, np.int32])
def test_unsigned_stream_into_signed_target_sign_extends(target):
    """B4: decoding into a signed target sign-extends each field, as the
    reference and the JAX package do (SURVEY §2.1)."""
    rng = np.random.default_rng(4)
    fr = rng.integers(0, 2**15, (3, 500)).astype(np.uint16)
    fr[0, :12] = [1, 3, 7, 15, 31, 0, 2, 5, 6, 12, 100, 2**14]
    arch = ncodec.encode(fr)
    ours = tcoding.decode(_foreign(arch), target, device="cpu")
    np.testing.assert_array_equal(ours, ncodec.decode(arch, target))
    np.testing.assert_array_equal(
        ours, jcoding.decode(_jax(arch), target))


def test_wide_stream_routes_to_host_codec():
    """Fields wider than the target's lanes take the host codec, which
    clamps (Bit_pointer.hpp:747-762)."""
    fr = np.array([[0, 1, 300, 70000, 5] * 5], np.uint32)
    arch = ncodec.encode(fr)
    out = tcoding.decode(_foreign(arch), np.uint16, device="cpu")
    np.testing.assert_array_equal(out, ncodec.decode(arch, np.uint16))
    assert out.max() == 65535


def _inputs(fr, dtype):
    spec = tcoding.FrameSpec.for_dtype(fr.shape[1], dtype)
    widths, words = tcoding.walk_archive(ncodec.encode(fr), spec)
    return (spec, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(widths.astype(np.uint8)))


def test_int32_output_matches_u16_output():
    spec, words, widths = _inputs(u16_frames("hot", 1000), np.uint16)
    assert decoded_dtype(spec) == torch.uint16
    u16 = decode_batch(spec, words, widths, torch.uint16)
    i32 = decode_batch(spec, words, widths, torch.int32)
    np.testing.assert_array_equal(u16.numpy().astype(np.int32), i32.numpy())


def test_inconsistent_tables_stay_inside_the_rows():
    """Widths that claim more bits than the stream holds read clamped
    words, never past a row (the kernel clamps the same way)."""
    spec, words, widths = _inputs(u16_frames("poisson", 1000), np.uint16)
    out = decode_batch_plain(spec, words, torch.full_like(widths, 33),
                             torch.int32)
    assert out.shape == (3, 1000)


def test_wrapper_checks_inputs():
    spec, words, widths = _inputs(u16_frames("poisson", 100), np.uint16)
    with pytest.raises(TypeError):
        decode_batch(spec, words.to(torch.int64), widths, torch.uint16)
    with pytest.raises(TypeError):
        decode_batch(spec, words, widths, torch.int16)
    with pytest.raises(ValueError):
        decode_batch(spec, words, widths[:, 1:], torch.uint16)
    with pytest.raises(ValueError):
        decode_batch(spec, words[:, ::2], widths, torch.uint16)
    signed = tcoding.FrameSpec.for_dtype(100, np.int16)
    with pytest.raises(TypeError):
        decode_batch(signed, words, widths, torch.uint16)
    with pytest.raises(ValueError, match="no unpack kernel"):
        decode_batch(spec, words.to("meta"), widths.to("meta"),
                     torch.uint16)


def _header_bits(w: int, prev: int) -> int:
    return 1 if w == prev else 4 if w < 7 else 6 if w < 10 else 12


def _kernel_reads(spec, words, widths, tile_blocks, tiled, out_dtype):
    """A scalar model of the unpack kernels' CTAs (csrc/unpack.cu
    unpack_tiles, csrc/unpack_tiled.cu unpack_tiles with its chunk loop,
    tile.cuh field_at): each tile's words staged as [base, end) from its
    bit range, within the row and the CTA's words_cap, and each field read
    from its two-word window clamped into them."""
    from trpx_tpu_torch.ops.cuda_pack import TILE_VALUES, words_cap

    F, W = words.shape
    n, B, nb = spec.n, spec.block, spec.nb
    wu = words.astype(np.uint32)
    out = np.zeros((F, n), np.int64)
    T = -(-nb // tile_blocks)
    cap = words_cap(spec.max_width, min(B, TILE_VALUES)
                    if tile_blocks == 1 else B, tile_blocks)
    for f in range(F):
        wd = [int(w) for w in widths[f]]
        bits = [_header_bits(wd[b], wd[b - 1] if b else 0)
                + wd[b] * min(B, n - b * B) for b in range(nb)]
        for t in range(T):
            b0 = t * tile_blocks
            nblk = min(tile_blocks, nb - b0)
            P = sum(bits[:b0])
            E = P + sum(bits[b0 : b0 + nblk])
            pay, run = [], 0
            for b in range(b0, b0 + nblk):
                h = _header_bits(wd[b], wd[b - 1] if b else 0)
                pay.append(P + run + h)
                run += bits[b]
            v0, nv, w1 = b0 * B, min(nblk * B, n - b0 * B), wd[b0]
            chunked = tiled and nblk == 1 and nv > TILE_VALUES and w1 > 0
            for c0 in range(0, nv, TILE_VALUES if chunked else nv):
                c1 = min(c0 + TILE_VALUES, nv) if chunked else nv
                lo = pay[0] + c0 * w1 if chunked else P
                hi = pay[0] + c1 * w1 if chunked else E
                base = max(min(lo >> 5, W - 2), 0)
                end = max(min((hi >> 5) + 2, W, base + cap - 3), base + 2)
                for v in range(v0 + c0, v0 + c1):
                    i, j = v // B - b0, v % B
                    w = wd[b0 + i]
                    off = pay[i] + j * w
                    idx = min(max(off >> 5, base), end - 2)
                    win = int(wu[f, idx]) | int(wu[f, idx + 1]) << 32
                    u = (win >> (off & 31)) & 0xFFFFFFFF
                    if w < 32:
                        u &= (1 << w) - 1
                        if spec.signed and w and u >> (w - 1):
                            u |= 0xFFFFFFFF ^ ((1 << w) - 1)
                    out[f, v] = u
    if out_dtype == torch.uint8:
        return (out & 0xFF).astype(np.uint8)
    if out_dtype == torch.uint16:
        return (out & 0xFFFF).astype(np.uint16)
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("dtype,n,block", [(np.uint16, 3000, 12),
                                           (np.uint8, 2000, 12),
                                           (np.int32, 1500, 12),
                                           (np.uint8, 3 * 9000 + 17, 9000)])
def test_plain_versions_clamp_reads_as_the_kernels_stage_them(dtype, n,
                                                              block):
    """On tables whose widths pass the target's fields (up to 255 bits,
    dense enough that a tile's bits outrun its CTA's staged words, and in
    a block walked in chunks), both plain versions read what the kernels'
    CTAs read (:func:`_kernel_reads`), at the kernels' tiles and at
    64-block tiles."""
    from trpx_tpu_torch.ops.cuda_unpack import (
        decode_batch_tiled_plain,
        tiled_unpack_geometry,
        unpack_geometry,
    )

    rng = np.random.default_rng(n)
    fr = rng.poisson(3.0, (3, n)).clip(0, 100).astype(dtype)
    spec = tcoding.FrameSpec.for_dtype(n, dtype, block)
    widths, words = tcoding.walk_archive(ncodec.encode(fr, block=block),
                                         spec)
    wd = widths.astype(np.uint8)
    wd[0, : spec.nb // 2] = 255
    wd[1, rng.integers(0, spec.nb, 3)] = rng.integers(17, 256, 3)
    wd[2, -2:] = 0
    wt = torch.from_numpy(wd)
    wo = torch.from_numpy(words.view(np.int32))
    runs = [(tb, True) for tb in {tiled_unpack_geometry(spec)[0], 64}]
    if block == 12:
        runs.append((unpack_geometry(spec)[0], False))
    for odt in {decoded_dtype(spec), torch.int32}:
        for tb, tiled in runs:
            got = (decode_batch_tiled_plain(spec, wo, wt, odt, tb) if tiled
                   else decode_batch_plain(spec, wo, wt, odt))
            want = _kernel_reads(spec, words, wd, tb, tiled, odt)
            if odt == torch.uint16:
                got = got.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got.numpy() if odt != torch.uint16
                                          else got, want)
