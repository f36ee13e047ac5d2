// TRPX encode kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel trpx_tpu/ops/pallas_pack.py:encode_batch_pallas
// (_kernel -> _encode_body -> _plan_planes). It computes what that kernel
// computes for each frame of a batch: the block widths, the repeat/3/5/11-bit
// header codes, an exclusive prefix of the block bit lengths, and the packed
// LSB-first stream in little-endian 32-bit words, plus the frame's total bits
// and largest width. It does not copy the TPU kernel's merge tree, which
// exists only because scatter serialises on a TPU.
//
// Bound on the H100: bytes moved. A 512x512 uint16 frame reads 0.5 MB of
// pixels and writes at most 0.56 MB of words (the worst case; Poisson-like
// frames write far less), against a handful of integer operations per
// value. The design reads each value from device memory once per pass
// (the second pass hits L1/L2), keeps all per-block tables in registers and
// a few KB of shared memory, and writes every word once: words wholly
// inside one block's bit range are plain stores, and only the two words a
// block shares with its neighbours are merged with atomicOr into the
// zero-initialised buffer. OR makes the result independent of the order in
// which blocks land, so the stream is bit-exact.
//
// Layout: one CTA per frame, one block of values per thread per chunk of
// kThreads blocks (see common.cuh). Bit offsets are int32: the wrapper's
// FrameSpec refuses frames whose worst case reaches 2^31 bits.
#include <type_traits>

#include "common.cuh"

namespace trpx {
namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ frames, int n, int stride, int block,
            int nb, int n_words, uint32_t* __restrict__ words,
            int* __restrict__ bits, int* __restrict__ maxw) {
  constexpr bool kSigned = std::is_signed<T>::value;
  __shared__ int s_width[kThreads];
  __shared__ int s_scan[kWarps + 1];
  __shared__ int s_maxw;
  const int tid = threadIdx.x;
  const T* x = frames + size_t(blockIdx.x) * stride;
  uint32_t* out = words + size_t(blockIdx.x) * n_words;
  if (tid == 0) s_maxw = 0;
  __syncthreads();

  int carry_bits = 0;  // bits of all earlier chunks
  int carry_w = 0;     // width of the previous chunk's last block
  int my_max = 0;
  for (int base = 0; base < nb; base += kThreads) {
    const int b = base + tid;
    const int lo = b * block;
    const int count = b < nb ? min(block, n - lo) : 0;
    uint32_t m = 0;
    for (int j = 0; j < count; ++j) m |= magnitude(x[lo + j]);
    const int w = m ? 32 - __clz(m) + (kSigned ? 1 : 0) : 0;
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
    if (count) {
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
  atomicMax(&s_maxw, my_max);
  __syncthreads();
  if (tid == 0) {
    bits[blockIdx.x] = carry_bits;
    maxw[blockIdx.x] = s_maxw;
  }
}

template <typename T>
void launch(const void* frames, int F, int n, int stride, int block, int nb,
            int n_words, void* words, void* bits, void* maxw,
            cudaStream_t stream) {
  pack_kernel<T><<<F, kThreads, 0, stream>>>(
      static_cast<const T*>(frames), n, stride, block, nb, n_words,
      static_cast<uint32_t*>(words), static_cast<int*>(bits),
      static_cast<int*>(maxw));
}

}  // namespace
}  // namespace trpx

// Encodes F frames of n values each (row stride `stride` elements, element
// size `itemsize` bytes, signed iff `is_signed`) into `words` (F, n_words)
// uint32, which must be zero on entry; writes each frame's total bits and
// largest width into `bits` and `maxw` (F,) int32. Launches on `stream` of
// device `device` and returns cudaGetLastError().
extern "C" int trpx_pack(const void* frames, int itemsize, int is_signed,
                         int F, int n, int stride, int block, int n_words,
                         void* words, void* bits, void* maxw, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || stride < n || n_words < 2) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize * 2 + (is_signed ? 1 : 0)) {
    case 2: trpx::launch<uint8_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    case 3: trpx::launch<int8_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    case 4: trpx::launch<uint16_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    case 5: trpx::launch<int16_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    case 8: trpx::launch<uint32_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    case 9: trpx::launch<int32_t>(frames, F, n, stride, block, nb, n_words, words, bits, maxw, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Message of a CUDA error code returned by trpx_pack or trpx_unpack.
extern "C" const char* trpx_cuda_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
