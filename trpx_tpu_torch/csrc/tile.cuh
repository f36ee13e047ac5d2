// CTA-level pieces of the kernels, each a template on the CTA size: a CTA
// scan; 16-byte staging of a range of a row into shared memory (unpack.cu,
// unpack_tiled.cu; pack.cu copies with cp.async into the same layout); a
// block's width from values in shared memory (pack.cu); each block's bit
// offset in a tile from the tile's widths; the frame scan of the tiles'
// bits that gives each tile its start (the tiled kernels); the tiled
// kernels' value budget and the shared-memory carve-up of a CTA that holds
// a tile's stream words (unpack.cu and the tiled kernels); the staged
// extraction of a tile's values with 16-byte stores (unpack.cu,
// unpack_tiled.cu); and the host's cache of a kernel's shared-memory
// attributes and residency.
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <utility>

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
  TRPX_CHECK(warp < kW);  // scratch holds kW + 1 ints
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
// caller synchronises before reading dst. Checked build: the row holds
// row_len elements, dst dst_cap.
template <int kNT, typename T>
__device__ __forceinline__ int stage_tile(
    const T* __restrict__ row, int lo, int hi,
    T* dst TRPX_CHECKED_ARG(int row_len, int dst_cap)) {
  constexpr int kVec = 16 / int(sizeof(T));
  const int shift =
      int((reinterpret_cast<uintptr_t>(row + lo) & 15u) / sizeof(T));
  const T* base = row + lo - shift;  // 16-byte aligned
  const int count = hi - lo + shift;
  const int c_lo = shift ? 1 : 0;    // the chunks wholly inside the range
  const int c_hi = count / kVec;
  const uint4* src = reinterpret_cast<const uint4*>(base);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  TRPX_CHECK(0 <= lo && lo <= hi && hi <= row_len);
  // element e of base is element lo - shift + e of the row, inside
  // [lo, hi) for e in [shift, count)
  for (int c = c_lo + int(threadIdx.x); c < c_hi; c += kNT) {
    TRPX_CHECK(c * kVec >= shift && (c + 1) * kVec <= count &&
               (c + 1) * kVec <= dst_cap);
    d4[c] = __ldcs(src + c);  // read once: stream past the caches
  }
  // the ragged ends: [shift, head_end) and [tail_start, count)
  const int head_end = min(c_lo * kVec, count);
  const int tail_start = max(c_hi * kVec, head_end);
  for (int e = shift + int(threadIdx.x); e < head_end; e += kNT) {
    TRPX_CHECK(e >= shift && e < count && e < dst_cap);
    dst[e] = base[e];
  }
  for (int e = tail_start + int(threadIdx.x); e < count; e += kNT) {
    TRPX_CHECK(e >= shift && e < count && e < dst_cap);
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
  return width_of<T>(m);
}

// Values in block b of a frame of n values in blocks of B (the last block
// may be partial).
__device__ __forceinline__ int block_count(int b, int B, int n) {
  return min(B, n - b * B);
}

// Bit offset of each of the `nblk` blocks of a tile (blocks b0...) from
// the tile's start, from the widths s_w[0..nblk] (s_w[0]: the block before
// the tile, 0 for a frame's first): the first header bit, or with
// kPayload the first payload bit, into s_off[i]. A thread scans a run of
// consecutive blocks. Every thread must call it; s_scan is kNT / 32 + 1
// ints; the caller synchronises before reading s_off. Returns the tile's
// bits. Checked build: s_off holds cap blocks, s_w cap + 1.
template <int kNT, bool kPayload>
__device__ __forceinline__ int block_offsets(
    const uint8_t* s_w, int nblk, int B, int n, int b0, int* s_off,
    int* s_scan TRPX_CHECKED_ARG(int cap)) {
  const int per = (nblk + kNT - 1) / kNT;
  const int i0 = min(int(threadIdx.x) * per, nblk);
  const int i1 = min(i0 + per, nblk);
  int sum = 0;
  for (int i = i0; i < i1; ++i) {
    TRPX_CHECK(i >= 0 && i < cap);
    const int w = s_w[i + 1];
    sum += header_bits(w, s_w[i]) + w * block_count(b0 + i, B, n);
  }
  int total;
  int run = cta_scan<kNT>(sum, s_scan, total);
  for (int i = i0; i < i1; ++i) {
    TRPX_CHECK(i >= 0 && i < cap);
    const int w = s_w[i + 1];
    const int hb = header_bits(w, s_w[i]);
    s_off[i] = kPayload ? run + hb : run;
    run += hb + w * block_count(b0 + i, B, n);
  }
  return total;
}

// The start of every tile of frame f = blockIdx.x: `part` (F, T) holds
// each tile's bits without its first header, which is coded here against
// the width of the block before the tile (`widths` (F, nb) u8, tiles of
// tb blocks). Writes the exclusive prefix into start (F, T + 1), the
// frame's bits into start[f, T], and returns them. `visit(t, P)` is
// called once for every tile start P and, by thread 0, for the frame's
// end (t = T). One pass: a thread sums a run of tiles, then the CTA scans
// the runs. Every thread must call it; s_scan is kNT / 32 + 1 ints.
template <int kNT, typename Visit>
__device__ __forceinline__ int scan_tile_starts(
    const int* __restrict__ part, const uint8_t* __restrict__ widths,
    int nb, int tb, int T, int* __restrict__ start, int* s_scan,
    Visit visit) {
  const int f = blockIdx.x;
  const int* p = part + size_t(f) * T;
  const uint8_t* wd = widths + size_t(f) * nb;
  int* st = start + size_t(f) * (T + 1);
  const int per = (T + kNT - 1) / kNT;
  const int t0 = min(int(threadIdx.x) * per, T);
  const int t1 = min(t0 + per, T);
  auto bits = [&](int t) {
    const int b = t * tb;
    TRPX_CHECK(t >= 0 && t < T && b < nb);
    return p[t] + header_bits(wd[b], t ? int(wd[b - 1]) : 0);
  };
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += bits(t);
  int total;
  int run = cta_scan<kNT>(sum, s_scan, total);
  for (int t = t0; t < t1; ++t) {
    TRPX_CHECK(t >= 0 && t < T);
    st[t] = run;
    visit(t, run);
    run += bits(t);
  }
  if (threadIdx.x == 0) {
    st[T] = total;
    visit(T, total);
  }
  return total;
}

// ------------------------------------------------ tiles and extraction ---

// Values in a tile of the tiled kernels (pack_tiled.cu, unpack_tiled.cu):
// a tile holds max(1, kTileValues / block) whole blocks, and a tile of one
// larger block is walked in chunks of kTileValues values.
// ops/cuda_pack.py:TILE_VALUES.
constexpr int kTileValues = 8192;

// Shared-memory carve-up of a CTA that holds a tile's stream words: the
// words (room for a tile of `tile_blocks` blocks of `block` values of the
// widest fields, the bit phase of its first word, the 16-byte phase and
// the two-word window), the block offsets and the widths (with the block
// before the tile first). ops/cuda_pack.py:tile_smem_bytes computes the
// same numbers. The tiled kernels size a one-block tile's chunk as a tile
// of one block of `chunk` values.
struct TileSmem {
  int words_cap, total;
  __host__ __device__ TileSmem(int max_width, int block, int tile_blocks) {
    const long long bits =
        static_cast<long long>(tile_blocks) * (12 + block * max_width);
    words_cap = int(((bits + 31) / 32 + 6 + 3) / 4 * 4);
    total = 4 * words_cap + 4 * tile_blocks + (tile_blocks + 1 + 15) / 16 * 16;
  }
};

// The staged words of a tile: words [lo, hi) of the row, word lo at
// src[lo - origin]; in the checked build, src holds cap words.
struct Staged {
  const uint32_t* src;
  int origin, lo, hi;
#ifdef TRPX_CHECKED
  int cap;
#endif
};

// The value at bit `off` of the frame: the two-word window at word
// off / 32 of the row, clamped into the staged words. A 33-bit field keeps
// its low 32 bits; kSigned sign-extends.
template <typename OutT, bool kSigned>
__device__ __forceinline__ OutT field_at(const Staged& sw, int off, int w) {
  const int idx = min(max(off >> 5, sw.lo), sw.hi - 2) - sw.origin;
  TRPX_CHECK(sw.hi - sw.lo >= 2 && idx >= sw.lo - sw.origin &&
             idx + 1 < sw.hi - sw.origin && idx + 1 < sw.cap);
  const uint32_t* src = sw.src;
  const uint64_t win = uint64_t(src[idx]) | (uint64_t(src[idx + 1]) << 32);
  uint32_t u = uint32_t(win >> (off & 31));
  if (w < 32) {
    const uint32_t mask = (1u << w) - 1u;
    u &= mask;
    if (kSigned && w > 0 && ((u >> (w - 1)) & 1u)) u |= ~mask;
  }
  return static_cast<OutT>(u);
}

// Values [v0, v1) of the frame into its output row `o`: the values
// between the first and the last 16-byte boundary of the row in groups of
// 16 bytes, each one vector store; the ragged ends one value at a time.
// Value v is field j = v % B of block i = v / B - b0, at bit
// P + s_off[i] + j * w of the frame (s_off: payload offsets). The block
// size is a compile-time constant when kB > 0 (the division is a
// multiply). Checked build: the tile has nblk blocks, the row n values.
template <int kNT, typename OutT, bool kSigned, int kB>
__device__ __forceinline__ void extract_tile(
    const Staged& sw, int P, int B, int b0, int v0, int v1, const int* s_off,
    const uint8_t* s_w, OutT* __restrict__ o TRPX_CHECKED_ARG(int nblk,
                                                              int n)) {
  constexpr int kV = 16 / int(sizeof(OutT));
  const int BB = kB > 0 ? kB : B;
  const int mis = int((reinterpret_cast<uintptr_t>(o + v0) & 15u) /
                      sizeof(OutT));
  const int a0 = min(v0 + (mis ? kV - mis : 0), v1);
  const int groups = (v1 - a0) / kV;
  const int a1 = a0 + groups * kV;
  for (int g = threadIdx.x; g < groups; g += kNT) {
    const int v = a0 + g * kV;
    const int bq = v / BB;
    int j = v - bq * BB;
    int i = bq - b0;
    TRPX_CHECK(i >= 0 && i < nblk);
    int w = s_w[i + 1];
    int off = P + s_off[i] + j * w;
    union {
      uint4 u;
      OutT e[kV];
    } pack;
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      pack.e[q] = field_at<OutT, kSigned>(sw, off, w);
      off += w;
      if (++j == BB && q + 1 < kV) {  // the next value opens a block
        j = 0;
        ++i;
        TRPX_CHECK(i < nblk);
        w = s_w[i + 1];
        off = P + s_off[i];
      }
    }
    TRPX_CHECK(v >= 0 && v + kV <= n);
    *reinterpret_cast<uint4*>(o + v) = pack.u;
  }
  for (int v = threadIdx.x; v < (a0 - v0) + (v1 - a1); v += kNT) {
    const int vv = v < a0 - v0 ? v0 + v : a1 + (v - (a0 - v0));
    const int bq = vv / BB;
    const int i = bq - b0;
    TRPX_CHECK(i >= 0 && i < nblk && vv >= 0 && vv < n);
    const int w = s_w[i + 1];
    o[vv] = field_at<OutT, kSigned>(sw, P + s_off[i] + (vv - bq * BB) * w,
                                    w);
  }
}

// How many CTAs of a kernel fit on the card at once at a dynamic shared
// memory size, remembered per (device, size). The first lookup on a device
// raises the kernel's dynamic shared-memory limit to the most a CTA of it
// can opt into on that card and prefers shared memory over L1 (both
// attributes are per device); the limit is never lowered, so no launch
// sees it set for another caller's smaller size. Launchers run on any
// host thread (ctypes releases the GIL): one mutex guards each instance.
struct Residency {
  std::mutex mu;
  std::set<int> raised;                     // devices whose limit is raised
  std::map<std::pair<int, int>, int> ctas;  // (device, size) -> CTAs
  template <typename Kernel>
  cudaError_t get(Kernel kernel, int threads, int smem_bytes, int dev,
                  int& out) {
    std::lock_guard<std::mutex> lock(mu);
    const std::pair<int, int> key(dev, smem_bytes);
    const auto hit = ctas.find(key);
    if (hit != ctas.end()) {
      out = hit->second;
      return cudaSuccess;
    }
    cudaError_t err;
    if (!raised.count(dev)) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
      if (err != cudaSuccess) return err;
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - int(attr.sharedSizeBytes));
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          int(cudaSharedmemCarveoutMaxShared));
      if (err != cudaSuccess) return err;
      raised.insert(dev);
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    out = ctas[key] = per_sm * sms;
    return cudaSuccess;
  }
};

}  // namespace trpx
