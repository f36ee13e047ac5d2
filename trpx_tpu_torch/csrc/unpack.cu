// TRPX decode kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel trpx_tpu/ops/pallas_unpack.py:decode_batch_pallas
// (_kernel, untiled branch -> _decode_body). From each frame's stream words
// and the per-block widths of the host header walk it rebuilds the header
// bit counts with the repeat chain (from width 0 in every frame), takes an
// exclusive prefix of the block bit lengths, and reads every value's
// width-bit field LSB first: the two-word gather, shift and mask of
// trpx_tpu/ops/coding.py:decode_frame_device. A 33-bit field keeps its low
// 32 bits; fields are sign-extended iff the target is signed. The TPU
// kernel's split tree and pair-packed output layout are Mosaic contracts
// and are not carried over: the output is flat (F, n).
//
// Bound on the H100: bytes moved. A 512x512 uint16 frame reads its
// compressed words (at most 0.56 MB) and 22 KB of widths and writes 0.5 MB
// of uint16 pixels. The design makes the write, the largest stream,
// coalesced: after the per-chunk scan each block's payload offset and
// width sit in shared memory, and consecutive threads then extract
// consecutive values, so a warp stores 64 contiguous bytes and its word
// reads fall on neighbouring addresses that L1 serves.
//
// Layout: one CTA per frame; per chunk of kThreads blocks, one block per
// thread for the scan, then one value per thread for the extraction
// (walk_unpack in common.cuh, shared with unpack_tiled.cu). Word reads are
// clamped to the frame's row, so inconsistent tables cannot read outside
// it.
#include "common.cuh"

namespace trpx {
namespace {

template <typename OutT, bool kSigned>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words,
              const uint8_t* __restrict__ widths, int W, int n, int block,
              int nb, OutT* __restrict__ out) {
  __shared__ int s_width[kThreads];
  __shared__ int s_off[kThreads];
  __shared__ int s_scan[kWarps + 1];
  walk_unpack<OutT, kSigned>(words + size_t(blockIdx.x) * W, W,
                             widths + size_t(blockIdx.x) * nb, n, block, 0,
                             nb, 0, 0, out + size_t(blockIdx.x) * n, s_width,
                             s_off, s_scan);
}

template <typename OutT, bool kSigned>
void launch(const void* words, const void* widths, int F, int W, int n,
            int block, int nb, void* out, cudaStream_t stream) {
  unpack_kernel<OutT, kSigned><<<F, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const uint8_t*>(widths), W, n, block, nb,
      static_cast<OutT*>(out));
}

}  // namespace
}  // namespace trpx

// Decodes F frames: `words` (F, W) uint32 streams with W >= 2 and at least
// two words after each stream's last bit, `widths` (F, nb) uint8 block
// widths, into `out` (F, n) of uint16 (out_u16, unsigned targets of at most
// 16 bits) or int32. Sign-extends iff `is_signed`. Launches on `stream` of
// device `device` and returns cudaGetLastError().
extern "C" int trpx_unpack(const void* words, const void* widths, int F,
                           int W, int n, int block, int is_signed,
                           int out_u16, void* out, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || W < 2 || (out_u16 && is_signed)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_u16) {
    trpx::launch<uint16_t, false>(words, widths, F, W, n, block, nb, out, s);
  } else if (is_signed) {
    trpx::launch<int32_t, true>(words, widths, F, W, n, block, nb, out, s);
  } else {
    trpx::launch<int32_t, false>(words, widths, F, W, n, block, nb, out, s);
  }
  return int(cudaGetLastError());
}
