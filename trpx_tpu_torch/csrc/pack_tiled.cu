// TRPX tiled encode kernels for Hopper (sm_90a): big frames (2K, 4K).
//
// Replaces the TPU kernel
// trpx_tpu/ops/pallas_pack.py:encode_batch_pallas_tiled (_tiled_kernel).
// It computes the stream of pack.cu, frame by frame, but cuts each frame
// into tiles of `tile_blocks` blocks and gives every (frame, tile) its own
// CTA. What the TPU kernel carries in SMEM from one sequential grid step
// to the next (the previous tile's last width `prev0` and the running bit
// count `acc`) is computed here before the tiles are placed:
//
//   1. plan_tiles: per tile, the widths of its blocks into an (F, nb) u8
//      table, the tile's bits (its first header coded against the width
//      of the block before the tile, which the CTA computes itself from
//      that block's values) into tile_bits (F, T), and the frame's bits
//      and largest width by atomicAdd / atomicMax into zeroed (F,) buffers.
//   2. place_tiles: per tile, its bit offset (the sum of tile_bits of the
//      tiles before it, reduced in the CTA) and prev0 (from the width
//      table), then pack.cu's chunk loop over the tile's blocks from there.
//
// The two launches run in order on one stream, so the second never reads
// a table the first has not finished. Tile edges are block edges, and a
// block merges the two words it shares with its neighbours with atomicOr
// into the zeroed words, so words shared by two tiles need nothing more.
//
// Why tiles on this card: one CTA per frame (pack.cu) gives a 2048x2048
// u32 batch of 32 frames 32 CTAs for 132 SMs, each walking 342 chunks in
// order. At 8,192 blocks per tile the same batch is 1,376 CTAs.
//
// Bound on the H100: bytes moved. Each launch reads the frame values once
// (537 MB for 32 frames of 2048x2048 u32) and the second writes the
// compressed words; the tables are 1 byte per block and 4 bytes per tile.
// Bit offsets are int32: the wrapper's FrameSpec refuses frames whose
// worst case reaches 2^31 bits.
#include <climits>

#include "common.cuh"

namespace trpx {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
plan_tiles(const T* __restrict__ frames, int n, int stride, int block,
           int nb, int tile_blocks, int tiles, uint8_t* __restrict__ widths,
           int* __restrict__ tile_bits, int* __restrict__ bits,
           int* __restrict__ maxw) {
  __shared__ int s_width[kThreads];
  __shared__ int s_scan[kWarps + 1];
  __shared__ int s_maxw;
  const Tile tl(tiles, tile_blocks, nb);
  const T* x = frames + size_t(tl.f) * stride;
  // the block before a tile is whole: only a frame's last block is partial
  const int prev0 = tl.t ? block_width(x, (tl.b0 - 1) * block, block) : 0;
  if (threadIdx.x == 0) s_maxw = 0;
  __syncthreads();

  int my_max = 0;
  const int total = walk_pack<false>(
      x, n, block, tl.b0, tl.b1, 0, prev0,
      [x](int, int lo, int count) { return block_width(x, lo, count); },
      widths + size_t(tl.f) * nb, nullptr, s_width, s_scan, my_max);
  atomicMax(&s_maxw, my_max);
  __syncthreads();
  if (threadIdx.x == 0) {
    tile_bits[blockIdx.x] = total;
    atomicAdd(bits + tl.f, total);
    atomicMax(maxw + tl.f, s_maxw);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
place_tiles(const T* __restrict__ frames, int n, int stride, int block,
            int nb, int n_words, int tile_blocks, int tiles,
            const uint8_t* __restrict__ widths,
            const int* __restrict__ tile_bits,
            uint32_t* __restrict__ words) {
  __shared__ int s_width[kThreads];
  __shared__ int s_scan[kWarps + 1];
  const Tile tl(tiles, tile_blocks, nb);
  const T* x = frames + size_t(tl.f) * stride;
  const uint8_t* wd = widths + size_t(tl.f) * nb;
  const int start =
      cta_prefix_total(tile_bits + size_t(tl.f) * tiles, tl.t, s_scan);
  const int prev0 = tl.t ? int(wd[tl.b0 - 1]) : 0;
  int my_max = 0;
  walk_pack<true>(
      x, n, block, tl.b0, tl.b1, start, prev0,
      [wd](int b, int, int count) { return count ? int(wd[b]) : 0; }, nullptr,
      words + size_t(tl.f) * n_words, s_width, s_scan, my_max);
}

template <typename T>
cudaError_t launch(const void* frames, int F, int n, int stride, int block,
                   int nb, int n_words, int tile_blocks, int tiles,
                   void* widths, void* tile_bits, void* words, void* bits,
                   void* maxw, cudaStream_t stream) {
  const T* x = static_cast<const T*>(frames);
  const unsigned grid = unsigned(F) * unsigned(tiles);
  plan_tiles<T><<<grid, kThreads, 0, stream>>>(
      x, n, stride, block, nb, tile_blocks, tiles,
      static_cast<uint8_t*>(widths), static_cast<int*>(tile_bits),
      static_cast<int*>(bits), static_cast<int*>(maxw));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place_tiles<T><<<grid, kThreads, 0, stream>>>(
      x, n, stride, block, nb, n_words, tile_blocks, tiles,
      static_cast<const uint8_t*>(widths),
      static_cast<const int*>(tile_bits), static_cast<uint32_t*>(words));
  return cudaGetLastError();
}

}  // namespace
}  // namespace trpx

// Encodes F frames of n values each (row stride `stride` elements, element
// size `itemsize` bytes, signed iff `is_signed`) in tiles of `tile_blocks`
// blocks into `words` (F, n_words) uint32; writes each frame's total bits
// and largest width into `bits` and `maxw` (F,) int32. `words`, `bits` and
// `maxw` must be zero on entry. Scratch: `widths` (F, nb) uint8 and
// `tile_bits` (F, ceil(nb / tile_blocks)) int32. Launches on `stream` of
// device `device` and returns the first launch error.
extern "C" int trpx_pack_tiled(const void* frames, int itemsize,
                               int is_signed, int F, int n, int stride,
                               int block, int n_words, int tile_blocks,
                               void* widths, void* tile_bits, void* words,
                               void* bits, void* maxw, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || stride < n || n_words < 2 ||
      tile_blocks <= 0) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  const int tiles = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * tiles > INT_MAX) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRPX_LAUNCH(T)                                                    \
  err = trpx::launch<T>(frames, F, n, stride, block, nb, n_words,         \
                        tile_blocks, tiles, widths, tile_bits, words, bits, \
                        maxw, s)
  switch (itemsize * 2 + (is_signed ? 1 : 0)) {
    case 2: TRPX_LAUNCH(uint8_t); break;
    case 3: TRPX_LAUNCH(int8_t); break;
    case 4: TRPX_LAUNCH(uint16_t); break;
    case 5: TRPX_LAUNCH(int16_t); break;
    case 8: TRPX_LAUNCH(uint32_t); break;
    case 9: TRPX_LAUNCH(int32_t); break;
    default: return int(cudaErrorInvalidValue);
  }
#undef TRPX_LAUNCH
  return int(err);
}
