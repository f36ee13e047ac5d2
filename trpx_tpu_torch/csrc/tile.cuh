// Helpers of the one-pass kernels pack.cu and unpack.cu: a CTA scan (a
// template on the CTA size), 16-byte staging of a range of a row into
// shared memory (unpack.cu; pack.cu copies with cp.async into the same
// layout), a block's width from values in shared memory, and the host's
// cache of a kernel's shared-memory attributes and residency.
//
// The tiled kernels of pack_tiled.cu / unpack_tiled.cu keep the loops of
// common.cuh; only its format helpers are shared.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace trpx {

// Exclusive prefix sum of one int per thread across a CTA of kNT threads.
// Every thread must call it; `scratch` is kNT / 32 + 1 ints of shared
// memory; `total` receives the CTA-wide sum.
template <int kNT>
__device__ __forceinline__ int cta_scan(int x, int* scratch, int& total) {
  constexpr int kW = kNT / 32;
  static_assert(kW <= 32, "the scan's second level runs in one warp");
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
    const int s = lane < kW ? scratch[lane] : 0;
    int si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, si, d);
      if (lane >= d) si += y;
    }
    if (lane < kW) scratch[lane] = si - s;
    if (lane == 31) scratch[kW] = si;
  }
  __syncthreads();
  total = scratch[kW];
  const int excl = scratch[warp] + incl - x;
  __syncthreads();  // scratch may be rewritten after the call
  return excl;
}

// Copies elements [lo, hi) of `row` into the 16-byte aligned shared array
// `dst`, element i at dst[i - lo + shift], and returns shift: the offset of
// row + lo in its 16-byte chunk, in elements. Every whole 16-byte chunk of
// the range moves with one 16-byte load and store, the ragged ends element
// by element; nothing outside [lo, hi) is read. dst must hold
// hi - lo + 16 / sizeof(T) - 1 elements. Every thread must call it; the
// caller synchronises before reading dst.
template <int kNT, typename T>
__device__ __forceinline__ int stage_tile(const T* __restrict__ row, int lo,
                                          int hi, T* dst) {
  constexpr int kVec = 16 / int(sizeof(T));
  const int shift =
      int((reinterpret_cast<uintptr_t>(row + lo) & 15u) / sizeof(T));
  const T* base = row + lo - shift;  // 16-byte aligned
  const int count = hi - lo + shift;
  const int c_lo = shift ? 1 : 0;    // the chunks wholly inside the range
  const int c_hi = count / kVec;
  const uint4* src = reinterpret_cast<const uint4*>(base);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int c = c_lo + int(threadIdx.x); c < c_hi; c += kNT) {
    d4[c] = __ldcs(src + c);  // read once: stream past the caches
  }
  // the ragged ends: [shift, head_end) and [tail_start, count)
  const int head_end = min(c_lo * kVec, count);
  const int tail_start = max(c_hi * kVec, head_end);
  for (int e = shift + int(threadIdx.x); e < head_end; e += kNT) {
    dst[e] = base[e];
  }
  for (int e = tail_start + int(threadIdx.x); e < count; e += kNT) {
    dst[e] = base[e];
  }
  return shift;
}

// Width of a block of `count` values at x (shared memory): the loop over a
// whole block of kB values is unrolled when the block size is a
// compile-time constant (kB > 0).
template <int kB, typename T>
__device__ __forceinline__ int tile_block_width(const T* x, int count) {
  uint32_t m = 0;
  if (kB > 0 && count == kB) {
#pragma unroll
    for (int j = 0; j < (kB > 0 ? kB : 1); ++j) m |= magnitude(x[j]);
  } else {
    for (int j = 0; j < count; ++j) m |= magnitude(x[j]);
  }
  return m ? 32 - __clz(m) + (std::is_signed<T>::value ? 1 : 0) : 0;
}

// How many CTAs of a kernel fit on the card at once at a dynamic shared
// memory size (after raising its limit and preferring shared memory over
// L1), remembered for the last (device, size) asked: both attributes are
// per device. Concurrent callers race only to store the same numbers.
struct Residency {
  int device = -1, smem = -1, ctas = 0;
  template <typename Kernel>
  cudaError_t get(Kernel kernel, int threads, int smem_bytes, int dev,
                  int& out) {
    if (dev != device || smem_bytes != smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          int(cudaSharedmemCarveoutMaxShared));
      if (err != cudaSuccess) return err;
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem_bytes);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      ctas = per_sm * sms;
      smem = smem_bytes;
      device = dev;
    }
    out = ctas;
    return cudaSuccess;
  }
};

}  // namespace trpx
