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
// kThreads blocks (walk_pack in common.cuh, shared with pack_tiled.cu).
// Bit offsets are int32: the wrapper's FrameSpec refuses frames whose
// worst case reaches 2^31 bits.
#include "common.cuh"

namespace trpx {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ frames, int n, int stride, int block,
            int nb, int n_words, uint32_t* __restrict__ words,
            int* __restrict__ bits, int* __restrict__ maxw) {
  __shared__ int s_width[kThreads];
  __shared__ int s_scan[kWarps + 1];
  __shared__ int s_maxw;
  const T* x = frames + size_t(blockIdx.x) * stride;
  uint32_t* out = words + size_t(blockIdx.x) * n_words;
  if (threadIdx.x == 0) s_maxw = 0;
  __syncthreads();

  int my_max = 0;
  const int total = walk_pack<true>(
      x, n, block, 0, nb, 0, 0,
      [x](int, int lo, int count) { return block_width(x, lo, count); },
      nullptr, out, s_width, s_scan, my_max);
  atomicMax(&s_maxw, my_max);
  __syncthreads();
  if (threadIdx.x == 0) {
    bits[blockIdx.x] = total;
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
