// Format helpers shared by every TRPX kernel: a block header's bits and
// pattern, a value's magnitude (whose bit length is the block width) and
// its w-bit field, and the bit writer of the pack kernels. The CTA-level
// helpers (scans, staging, the tile geometry's shared pieces) are in
// tile.cuh.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// Bounds checks. TRPX_CHECK(cond) guards a shared-memory or global index
// against the extent its launcher passes: nothing in the normal build,
// and under -DTRPX_CHECKED (_build.py:CHECKED_FLAGS) a device assert,
// which prints the file, the line and the thread and leaves a sticky
// cudaErrorAssert. TRPX_CHECKED_ARG(x) appends the argument ", x" only in
// the checked build: an extent a kernel or helper needs for its checks
// alone.
#ifdef TRPX_CHECKED
#include <cassert>
#define TRPX_CHECK(cond) assert(cond)
#define TRPX_CHECKED_ARG(...) , __VA_ARGS__
#else
#define TRPX_CHECK(cond) ((void)0)
#define TRPX_CHECKED_ARG(...)
#endif

namespace trpx {

// Restores the calling thread's current device when it leaves scope: the
// C entry points set the device of their launch and leave the caller's
// as they found it on every return.
class DeviceGuard {
 public:
  DeviceGuard() : ok_(cudaGetDevice(&prev_) == cudaSuccess) {}
  ~DeviceGuard() {
    int now = prev_;
    if (ok_ && cudaGetDevice(&now) == cudaSuccess && now != prev_) {
      cudaSetDevice(prev_);
    }
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

 private:
  int prev_ = 0;
  bool ok_;
};

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

// Width of a block whose magnitudes OR to m: its bit length, plus a sign
// bit for signed types; 0 if all are zero.
template <typename T>
__device__ __forceinline__ int width_of(uint32_t m) {
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

// Writes a run of bits, LSB first, starting at bit `start` of a zeroed
// stream that neighbouring runs write too (the pack kernels' assembly in
// shared memory: a block in pack.cu, a thread's fields of one block in
// pack_tiled.cu): the first and the last word are merged with atomicOr,
// the words between them belong to the run alone.
struct BitWriter {
  uint32_t* words;
  int word;
  int nbits;      // valid bits in acc
  uint64_t acc;
  bool first;     // the first word may hold the previous block's tail
#ifdef TRPX_CHECKED
  int cap;        // words of the stream buffer
#endif

  __device__ BitWriter(uint32_t* w, int start TRPX_CHECKED_ARG(int c))
      : words(w), word(start >> 5), nbits(start & 31), acc(0), first(true)
        TRPX_CHECKED_ARG(cap(c)) {}

  // Appends the n low bits of v (v < 2^n, n <= 33). nbits <= 31 on entry,
  // so v << nbits fits in 64 bits.
  __device__ __forceinline__ void put(uint64_t v, int n) {
    acc |= v << nbits;
    nbits += n;
    while (nbits >= 32) {
      TRPX_CHECK(word >= 0 && word < cap);
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
    TRPX_CHECK(!nbits || (word >= 0 && word < cap));
    if (nbits) atomicOr(words + word, uint32_t(acc));
  }
};

}  // namespace trpx
