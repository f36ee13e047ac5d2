// Shared device code of the TRPX pack and unpack kernels.
//
// Every kernel walks a range of a frame's blocks in chunks of kThreads
// blocks, one block per thread: the whole frame (one CTA per frame,
// pack.cu / unpack.cu) or one tile of it (one CTA per frame and tile,
// pack_tiled.cu / unpack_tiled.cu). The repeat-width chain and the running
// bit offset carry from chunk to chunk in registers, so a range of any
// size needs only a few KB of static shared memory (no dynamic shared
// memory, no cudaFuncSetAttribute). A tile's walk starts from the width of
// the block before it and from its bit offset in the frame's stream.
#pragma once

#include <cstdint>
#include <type_traits>

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

// Sum of the first `count` ints of `v` (count >= 0), for every thread of
// the CTA: a tile's bit offset is the sum of the bits of the tiles before
// it. Every thread must call it.
__device__ __forceinline__ int cta_prefix_total(const int* __restrict__ v,
                                                int count, int* scratch) {
  int part = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) part += v[i];
  int total;
  cta_exclusive_scan(part, scratch, total);
  return total;
}

// Blocks [b0, b1) of tile t of frame f, for a 1-D grid of one CTA per
// (frame, tile): blockIdx.x = f * tiles + t, tiles = ceil(nb / tile_blocks).
struct Tile {
  int f, t, b0, b1;
  __device__ Tile(int tiles, int tile_blocks, int nb) {
    f = blockIdx.x / tiles;
    t = blockIdx.x - f * tiles;
    b0 = t * tile_blocks;  // < nb
    b1 = b0 + min(tile_blocks, nb - b0);
  }
};

// ---------------------------------------------------------------- pack ---

// |v| as the unsigned pattern whose bit length is the block width; the
// magnitude of INT32_MIN is 2^31.
template <typename T>
__device__ __forceinline__ uint32_t magnitude(T v) {
  if constexpr (std::is_signed<T>::value) {
    const int32_t x = v;
    return x < 0 ? 0u - uint32_t(x) : uint32_t(x);
  } else {
    return uint32_t(v);
  }
}

// Width of the `count` values x[lo...]: the bit length of the OR of their
// magnitudes, plus a sign bit for signed types; 0 if all are zero (and
// for count = 0).
template <typename T>
__device__ __forceinline__ int block_width(const T* __restrict__ x, int lo,
                                           int count) {
  uint32_t m = 0;
  for (int j = 0; j < count; ++j) m |= magnitude(x[lo + j]);
  return m ? 32 - __clz(m) + (std::is_signed<T>::value ? 1 : 0) : 0;
}

// The w low bits of v's two's-complement pattern (w <= 33: an int32 field
// carries its sign in bit 32).
template <typename T>
__device__ __forceinline__ uint64_t field(T v, int w) {
  const uint64_t mask = (1ull << w) - 1ull;
  if constexpr (std::is_signed<T>::value) {
    return uint64_t(int64_t(v)) & mask;
  } else {
    return uint64_t(v) & mask;
  }
}

// Writes one block's bits, LSB first, starting at bit `start`.
struct BitWriter {
  uint32_t* words;
  int word;
  int nbits;      // valid bits in acc
  uint64_t acc;
  bool first;     // the first word may hold the previous block's tail

  __device__ BitWriter(uint32_t* w, int start)
      : words(w), word(start >> 5), nbits(start & 31), acc(0), first(true) {}

  // Appends the n low bits of v (v < 2^n, n <= 33). nbits <= 31 on entry,
  // so v << nbits fits in 64 bits.
  __device__ __forceinline__ void put(uint64_t v, int n) {
    acc |= v << nbits;
    nbits += n;
    while (nbits >= 32) {
      if (first) {
        atomicOr(words + word, uint32_t(acc));
        first = false;
      } else {
        words[word] = uint32_t(acc);  // wholly inside this block
      }
      ++word;
      acc >>= 32;
      nbits -= 32;
    }
  }

  // The last, partial word is shared with the next block.
  __device__ __forceinline__ void finish() {
    if (nbits) atomicOr(words + word, uint32_t(acc));
  }
};

// Walks blocks [b0, b1) of one frame of n values `x`, whose block b0 - 1
// has width `carry_w` (0 for b0 = 0), and returns `carry_bits` plus the
// bits of those blocks; `my_max` receives the largest width this thread
// saw. `width_of(b, lo, count)` gives block b's width (its values start at
// x[lo]); it must give 0 for count = 0, a thread past the range. With
// kPlace, each block's header and fields are written into the zeroed
// `out` from bit `carry_bits` on; a non-null `width_out` gets each block's
// width. Blocks own disjoint bit ranges, and only the two words a block
// shares with its neighbours are merged with atomicOr, so CTAs that write
// neighbouring ranges of one stream need no ordering.
// Every thread of the CTA must call it; `s_width` is kThreads ints and
// `s_scan` kWarps + 1 ints of shared memory.
template <bool kPlace, typename T, typename WidthOf>
__device__ __forceinline__ int walk_pack(
    const T* __restrict__ x, int n, int block, int b0, int b1,
    int carry_bits, int carry_w, WidthOf width_of,
    uint8_t* __restrict__ width_out, uint32_t* __restrict__ out,
    int* s_width, int* s_scan, int& my_max) {
  const int tid = threadIdx.x;
  for (int base = b0; base < b1; base += kThreads) {
    const int b = base + tid;
    const int lo = b * block;
    const int count = b < b1 ? min(block, n - lo) : 0;
    const int w = width_of(b, lo, count);
    if (width_out != nullptr && count) width_out[b] = uint8_t(w);
    my_max = max(my_max, w);

    s_width[tid] = w;
    __syncthreads();
    const int prev = tid ? s_width[tid - 1] : carry_w;
    const int next_carry = s_width[kThreads - 1];
    const int hb = header_bits(w, prev);
    int total;
    // the scan's barriers also order these reads of s_width before the
    // next chunk overwrites it
    const int start =
        carry_bits + cta_exclusive_scan(count ? hb + w * count : 0, s_scan,
                                        total);
    if (kPlace && count) {
      BitWriter bw(out, start);
      bw.put(header_value(w, prev), hb);
      if (w) {
        for (int j = 0; j < count; ++j) bw.put(field(x[lo + j], w), w);
      }
      bw.finish();
    }
    carry_bits += total;
    carry_w = next_carry;
  }
  return carry_bits;
}

// -------------------------------------------------------------- unpack ---

// The w-bit field at bit `off` of a row of W >= 2 words, read through the
// two-word window of trpx_tpu/ops/coding.py:decode_frame_device. The word
// index is clamped to the row, so inconsistent tables cannot read outside
// it. A 33-bit field keeps its low 32 bits; kSigned sign-extends.
template <typename OutT, bool kSigned>
__device__ __forceinline__ OutT extract(const uint32_t* __restrict__ row,
                                        int W, int off, int w) {
  const int idx = min(max(off >> 5, 0), W - 2);
  const uint64_t win = uint64_t(row[idx]) | (uint64_t(row[idx + 1]) << 32);
  uint32_t u = uint32_t(win >> (off & 31));
  if (w < 32) {
    const uint32_t mask = (1u << w) - 1u;
    u &= mask;
    if (kSigned && w > 0 && ((u >> (w - 1)) & 1u)) u |= ~mask;
  }
  return static_cast<OutT>(u);
}

// Decodes blocks [b0, b1) of one frame of n values from its stream `row`
// (W words) and its u8 block widths `wd`, into o[b0 * block ...]. The
// range's first block starts at bit `carry_bits` and follows a block of
// width `carry_w` (0 for b0 = 0). Per chunk: one block per thread for the
// header bits and the scan, then one value per thread, so a warp's stores
// are contiguous. Every thread of the CTA must call it; `s_width` and
// `s_off` are kThreads ints, `s_scan` kWarps + 1 ints of shared memory.
template <typename OutT, bool kSigned>
__device__ __forceinline__ void walk_unpack(
    const uint32_t* __restrict__ row, int W,
    const uint8_t* __restrict__ wd, int n, int block, int b0, int b1,
    int carry_bits, int carry_w, OutT* __restrict__ o, int* s_width,
    int* s_off, int* s_scan) {
  const int tid = threadIdx.x;
  for (int base = b0; base < b1; base += kThreads) {
    const int b = base + tid;
    const int count = b < b1 ? min(block, n - b * block) : 0;
    const int w = count ? int(wd[b]) : 0;
    s_width[tid] = w;
    __syncthreads();
    const int prev = tid ? s_width[tid - 1] : carry_w;
    const int next_carry = s_width[kThreads - 1];
    const int hb = header_bits(w, prev);
    int total;
    const int start =
        carry_bits + cta_exclusive_scan(count ? hb + w * count : 0, s_scan,
                                        total);
    s_off[tid] = start + hb;  // first payload bit of block b
    __syncthreads();

    const int v0 = base * block;
    const int nv = min(min(kThreads, b1 - base) * block, n - v0);
    for (int v = tid; v < nv; v += kThreads) {
      const int lb = v / block;
      const int wb = s_width[lb];
      o[v0 + v] = extract<OutT, kSigned>(row, W,
                                         s_off[lb] + (v - lb * block) * wb,
                                         wb);
    }
    carry_bits += total;
    carry_w = next_carry;
    __syncthreads();  // s_width and s_off are rewritten by the next chunk
  }
}

}  // namespace trpx
