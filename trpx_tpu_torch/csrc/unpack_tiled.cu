// TRPX tiled decode kernels for Hopper (sm_90a): big frames (2K, 4K).
//
// Replaces the TPU kernel
// trpx_tpu/ops/pallas_unpack.py:decode_batch_pallas_tiled (the tiled
// branch of _kernel, fed by the host tile_prepass). It decodes what
// unpack.cu decodes, but gives every (frame, tile of `tile_blocks`
// blocks) its own CTA:
//
//   1. tile_bits_kernel: per tile, its bits from the u8 widths of the host
//      walk (one byte per block; block b's header is coded against the
//      width of block b - 1, read from the same table).
//   2. unpack_tiles: per tile, its bit offset (the sum of tile_bits of the
//      tiles before it, reduced in the CTA) and prev0 (the width of the
//      block before it), then unpack.cu's chunk loop over its blocks.
//
// The TPU kernel needs word windows cut on the host for each tile (a tile
// of VMEM had to be staged); a CTA here reads its frame's row of words in
// device memory at the tile's offset, so nothing is cut or copied. Word
// reads stay clamped to the frame's row, as in unpack.cu.
//
// Bound on the H100: bytes moved: the compressed words and 1 byte of width
// per block in, 2 or 4 bytes per value out (537 MB for 32 frames of
// 2048x2048 u32); the extraction's stores are coalesced as in unpack.cu.
#include <climits>

#include "common.cuh"

namespace trpx {
namespace {

__global__ void __launch_bounds__(kThreads)
tile_bits_kernel(const uint8_t* __restrict__ widths, int n, int block,
                 int nb, int tile_blocks, int tiles,
                 int* __restrict__ tile_bits) {
  __shared__ int s_scan[kWarps + 1];
  const Tile tl(tiles, tile_blocks, nb);
  const uint8_t* wd = widths + size_t(tl.f) * nb;
  int part = 0;
  for (int b = tl.b0 + threadIdx.x; b < tl.b1; b += kThreads) {
    const int w = wd[b];
    part += header_bits(w, b ? int(wd[b - 1]) : 0) +
            w * min(block, n - b * block);
  }
  int total;
  cta_exclusive_scan(part, s_scan, total);
  if (threadIdx.x == 0) tile_bits[blockIdx.x] = total;
}

template <typename OutT, bool kSigned>
__global__ void __launch_bounds__(kThreads)
unpack_tiles(const uint32_t* __restrict__ words,
             const uint8_t* __restrict__ widths, int W, int n, int block,
             int nb, int tile_blocks, int tiles,
             const int* __restrict__ tile_bits, OutT* __restrict__ out) {
  __shared__ int s_width[kThreads];
  __shared__ int s_off[kThreads];
  __shared__ int s_scan[kWarps + 1];
  const Tile tl(tiles, tile_blocks, nb);
  const uint8_t* wd = widths + size_t(tl.f) * nb;
  const int start =
      cta_prefix_total(tile_bits + size_t(tl.f) * tiles, tl.t, s_scan);
  const int prev0 = tl.t ? int(wd[tl.b0 - 1]) : 0;
  walk_unpack<OutT, kSigned>(words + size_t(tl.f) * W, W, wd, n, block,
                             tl.b0, tl.b1, start, prev0,
                             out + size_t(tl.f) * n, s_width, s_off, s_scan);
}

template <typename OutT, bool kSigned>
cudaError_t launch(const void* words, const void* widths, int F, int W,
                   int n, int block, int nb, int tile_blocks, int tiles,
                   void* tile_bits, void* out, cudaStream_t stream) {
  const unsigned grid = unsigned(F) * unsigned(tiles);
  const uint8_t* wd = static_cast<const uint8_t*>(widths);
  tile_bits_kernel<<<grid, kThreads, 0, stream>>>(
      wd, n, block, nb, tile_blocks, tiles, static_cast<int*>(tile_bits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unpack_tiles<OutT, kSigned><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), wd, W, n, block, nb, tile_blocks,
      tiles, static_cast<const int*>(tile_bits), static_cast<OutT*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace trpx

// Decodes F frames in tiles of `tile_blocks` blocks: `words` (F, W) uint32
// streams with W >= 2 and at least two words after each stream's last bit,
// `widths` (F, nb) uint8 block widths, into `out` (F, n) of uint16
// (out_u16, unsigned targets of at most 16 bits) or int32. Sign-extends
// iff `is_signed`. Scratch: `tile_bits` (F, ceil(nb / tile_blocks)) int32.
// Launches on `stream` of device `device` and returns the first launch
// error.
extern "C" int trpx_unpack_tiled(const void* words, const void* widths,
                                 int F, int W, int n, int block,
                                 int tile_blocks, int is_signed, int out_u16,
                                 void* tile_bits, void* out, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || W < 2 || tile_blocks <= 0 ||
      (out_u16 && is_signed)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  const int tiles = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * tiles > INT_MAX) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_u16) {
    err = trpx::launch<uint16_t, false>(words, widths, F, W, n, block, nb,
                                        tile_blocks, tiles, tile_bits, out, s);
  } else if (is_signed) {
    err = trpx::launch<int32_t, true>(words, widths, F, W, n, block, nb,
                                      tile_blocks, tiles, tile_bits, out, s);
  } else {
    err = trpx::launch<int32_t, false>(words, widths, F, W, n, block, nb,
                                       tile_blocks, tiles, tile_bits, out, s);
  }
  return int(err);
}
