// Shared device helpers of the TRPX pack and unpack kernels.
//
// Both kernels run one CTA per frame and walk the frame's blocks in chunks
// of kThreads blocks, one block per thread. The repeat-width chain and the
// running bit offset carry from chunk to chunk in registers, so a frame of
// any size needs only a few KB of static shared memory (no dynamic shared
// memory, no cudaFuncSetAttribute).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace trpx {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps <= 32, "the scan's second level runs in one warp");

// Bits of a block header (format/spec.py:header_code): a repeat of the
// previous block's width is one bit, else a 3-, 5- or 11-bit width code
// behind a 0 bit.
__device__ __forceinline__ int header_bits(int w, int prev) {
  return w == prev ? 1 : (w < 7 ? 4 : (w < 10 ? 6 : 12));
}

// The header's bit pattern, to be written LSB first.
__device__ __forceinline__ uint32_t header_value(int w, int prev) {
  if (w == prev) return 1u;
  if (w < 7) return uint32_t(w) << 1;
  if (w < 10) return (0x7u | (uint32_t(w - 7) << 3)) << 1;
  return (0x1Fu | (uint32_t(w - 10) << 5)) << 1;
}

// Exclusive prefix sum of one int per thread across the CTA. Every thread
// must call it. `scratch` is kWarps + 1 ints of shared memory; `total`
// receives the CTA-wide sum.
__device__ __forceinline__ int cta_exclusive_scan(int x, int* scratch,
                                                  int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kWarps ? scratch[lane] : 0;
    int si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, si, d);
      if (lane >= d) si += y;
    }
    if (lane < kWarps) scratch[lane] = si - s;
    if (lane == 31) scratch[kWarps] = si;
  }
  __syncthreads();
  total = scratch[kWarps];
  const int excl = scratch[warp] + incl - x;
  __syncthreads();  // scratch is rewritten by the next call
  return excl;
}

}  // namespace trpx
