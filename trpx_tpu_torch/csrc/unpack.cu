// TRPX decode kernels for Hopper (sm_90a).
//
// Replace the TPU kernel trpx_tpu/ops/pallas_unpack.py:decode_batch_pallas
// (_kernel, untiled branch -> _decode_body). From each frame's stream words
// and the per-block widths of the host header walk they rebuild the header
// bit counts with the repeat chain (from width 0 in every frame), take an
// exclusive prefix of the block bit lengths, and read every value's
// width-bit field LSB first: the two-word gather, shift and mask of
// trpx_tpu/ops/coding.py:decode_frame_device. A 33-bit field keeps its low
// 32 bits; fields are sign-extended iff the target is signed. The TPU
// kernel's split tree and pair-packed output layout are Mosaic contracts
// and are not carried over: the output is flat (F, n).
//
// Bound on the H100: bytes moved. 256 frames of 512x512 uint16 read 28.5 MB
// of words and 5.6 MB of widths and write 134 MB of pixels, the largest
// stream, against a few integer operations per value.
//
// Design: each frame is cut into tiles of `tile_blocks` blocks.
//   1. tile_offsets, one CTA per frame: each warp sums the bits of a tile
//      from its widths (one byte per block, 3% of the bytes moved), then
//      the CTA scans the tiles: the bit offset of every tile and the
//      frame's total, (F, tiles + 1) int32.
//   2. unpack_tiles, one CTA per (frame, tile): knowing its bit range from
//      the table, it issues at once the loads of its widths and of its
//      word range [P / 32, (P + bits) / 32 + 2) (16-byte loads into shared
//      memory), scans the widths into block offsets, then extracts its
//      values from shared memory, 16 bytes of output per thread and step
//      (16 uint8, 8 uint16 or 4 int32) stored with one vector store. The
//      block size 12 (DEFAULT_BLOCK) is a compile-time constant, so the
//      value -> block division is one multiply; other block sizes take the
//      generic instance of the same kernel.
// Word reads are clamped to the frame's row, as in the plain version, so
// inconsistent tables cannot read outside it; they are also clamped to
// the words staged, which only widths wider than the target type (tables
// that disagree with the header, which walk_archive never gives) can
// reach: such fields read clamped words, never past the shared memory.
#include "tile.cuh"

namespace trpx {
namespace {

// 128 threads a CTA of unpack_tiles, at least 8 CTAs an SM (at most 64
// registers a thread): on an H100 80GB HBM3 at 256 x 512x512 u16 this beat
// 256- and 512-thread CTAs (PERF.md, section 6)
constexpr int kNT = 128;
constexpr int kMinCtas = 8;
constexpr int kOffsetsThreads = 256;

// Bit offset of every tile of frame blockIdx.x and the frame's total bits
// into ts[f * (tiles + 1) + ...].
__global__ void __launch_bounds__(kOffsetsThreads)
tile_offsets(const uint8_t* __restrict__ widths, int n, int block, int nb,
             int tiles, int tile_blocks, int* __restrict__ ts) {
  __shared__ int s_scan[kOffsetsThreads / 32 + 1];
  const int f = blockIdx.x;
  const uint8_t* wd = widths + size_t(f) * nb;
  int* row = ts + size_t(f) * (tiles + 1);
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < tiles; t += kOffsetsThreads / 32) {
    const int b1 = min((t + 1) * tile_blocks, nb);
    int s = 0;
    for (int b = t * tile_blocks + lane; b < b1; b += 32) {
      TRPX_CHECK(b >= 0 && b < nb);
      const int w = wd[b];
      s += header_bits(w, b ? int(wd[b - 1]) : 0) +
           w * min(block, n - b * block);
    }
    s = __reduce_add_sync(0xffffffffu, s);
    TRPX_CHECK(t < tiles);
    if (lane == 0) row[t] = s;
  }
  __syncthreads();
  int run = 0;
  for (int base = 0; base < tiles; base += kOffsetsThreads) {
    const int t = base + threadIdx.x;
    const int x = t < tiles ? row[t] : 0;
    int total;
    const int excl = cta_scan<kOffsetsThreads>(x, s_scan, total);
    if (t < tiles) row[t] = run + excl;
    run += total;
  }
  if (threadIdx.x == 0) row[tiles] = run;
}

template <typename OutT, bool kSigned, int kB>
__global__ void __launch_bounds__(kNT, kMinCtas)
unpack_tiles(const uint32_t* __restrict__ words,
             const uint8_t* __restrict__ widths, int W, int n, int block_rt,
             int nb, int tiles, int tile_blocks, int words_cap,
             const int* __restrict__ ts, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[kNT / 32 + 1];
  const int B = kB > 0 ? kB : block_rt;
  const int f = blockIdx.x / tiles;
  const int t = blockIdx.x - f * tiles;
  const int b0 = t * tile_blocks;
  const int nblk = min(tile_blocks, nb - b0);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(s_words + words_cap);
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_off + tile_blocks);

  // 1. the tile's bit range, then its widths (s_w[0]: the block before the
  //    tile, 0 for the first) and words, loads all in flight together
  TRPX_CHECK(t >= 0 && t < tiles && nblk >= 1 && nblk <= tile_blocks);
  const int P = ts[size_t(f) * (tiles + 1) + t];
  const int total = ts[size_t(f) * (tiles + 1) + t + 1] - P;
  const uint8_t* wd = widths + size_t(f) * nb;
  for (int i = threadIdx.x; i <= nblk; i += kNT) {
    const int b = b0 - 1 + i;
    TRPX_CHECK(i <= tile_blocks && b < nb);  // s_w: tile_blocks + 1
    s_w[i] = b >= 0 ? wd[b] : 0;
  }
  // words [base, end): the tile's range and the window past its last
  // bit, inside the row and inside the shared memory (stage_tile needs 3
  // words of room for the 16-byte phase)
  const uint32_t* row = words + size_t(f) * W;
  const int base = max(min(P >> 5, W - 2), 0);
  const int end = max(min(min(((P + total) >> 5) + 2, W),
                          base + words_cap - 3), base + 2);
  const int shift = stage_tile<kNT>(row, base, end,
                                    s_words TRPX_CHECKED_ARG(W, words_cap));
  __syncthreads();

  // 2. each block's first payload bit in the tile
  block_offsets<kNT, true>(s_w, nblk, B, n, b0, s_off,
                           s_scan TRPX_CHECKED_ARG(tile_blocks));
  __syncthreads();

  // 3. extract
  const int v0 = b0 * B;
  const int v1 = min((b0 + nblk) * B, n);
  OutT* o = out + size_t(f) * n;
  extract_tile<kNT, OutT, kSigned, kB>(
      Staged{s_words, base - shift, base, end TRPX_CHECKED_ARG(words_cap)}, P,
      B, b0, v0, v1, s_off, s_w, o TRPX_CHECKED_ARG(nblk, n));
}

template <typename OutT, bool kSigned, int kB>
cudaError_t launch(const void* words, const void* widths, int F, int W,
                   int n, int block, int nb, int tiles, int tile_blocks,
                   const TileSmem& sm, int* ts, void* out, int device,
                   cudaStream_t stream) {
  auto kernel = unpack_tiles<OutT, kSigned, kB>;
  // the attributes once per device, the residency once per (device,
  // shared-memory size): the launch is on every decode's hot path
  static Residency cache;
  int resident = 0;
  cudaError_t err = cache.get(kernel, kNT, sm.total, device, resident);
  if (err != cudaSuccess) return err;
  const uint8_t* wd = static_cast<const uint8_t*>(widths);
  tile_offsets<<<F, kOffsetsThreads, 0, stream>>>(wd, n, block, nb, tiles,
                                                  tile_blocks, ts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(F) * unsigned(tiles), kNT, sm.total, stream>>>(
      static_cast<const uint32_t*>(words), wd, W, n, block, nb, tiles,
      tile_blocks, sm.words_cap, ts, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename OutT, bool kSigned>
cudaError_t launch_block(const void* words, const void* widths, int F, int W,
                         int n, int block, int nb, int tiles, int tile_blocks,
                         const TileSmem& sm, int* ts, void* out,
                         int device, cudaStream_t stream) {
  if (block == 12) {  // DEFAULT_BLOCK: division by a constant
    return launch<OutT, kSigned, 12>(words, widths, F, W, n, block, nb,
                                     tiles, tile_blocks, sm, ts, out, device,
                                     stream);
  }
  return launch<OutT, kSigned, 0>(words, widths, F, W, n, block, nb, tiles,
                                  tile_blocks, sm, ts, out, device, stream);
}

}  // namespace
}  // namespace trpx

// Decodes F frames in tiles of `tile_blocks` >= 32 blocks: `words` (F, W)
// uint32 streams with W >= 2 and at least two words after each stream's
// last bit, `widths` (F, nb) uint8 block widths, into `out` (F, n) of
// `lane_bytes`-byte lanes: uint8 (1, unsigned targets of at most 8 bits),
// uint16 (2, unsigned targets of at most 16 bits) or int32 (4). Rows start
// at any byte: each row's ragged ends are stored a value at a time.
// Sign-extends iff `is_signed`. `max_width` is the target's widest field
// (shared memory is sized for it). Scratch: `tile_start` (F, tiles + 1)
// int32. `smem_bytes` must be the dynamic shared memory of an unpack_tiles
// CTA (ops/cuda_pack.py:tile_smem_bytes). Launches on `stream` of
// device `device` and returns the first CUDA error.
extern "C" int trpx_unpack(const void* words, const void* widths, int F,
                           int W, int n, int block, int tile_blocks,
                           int max_width, int smem_bytes, int is_signed,
                           int lane_bytes, void* out, void* tile_start,
                           int device, void* stream) {
  const trpx::DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || W < 2 || tile_blocks < 32 ||
      max_width <= 0 || (lane_bytes != 1 && lane_bytes != 2 &&
                         lane_bytes != 4) ||
      (lane_bytes != 4 && is_signed)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  const int tiles = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * tiles > (1 << 27)) return int(cudaErrorInvalidValue);
  const trpx::TileSmem sm(max_width, block, tile_blocks);
  if (sm.total != smem_bytes) return int(cudaErrorInvalidValue);
  int* ts = static_cast<int*>(tile_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_bytes == 1) {
    err = trpx::launch_block<uint8_t, false>(words, widths, F, W, n, block,
                                             nb, tiles, tile_blocks, sm, ts,
                                             out, device, s);
  } else if (lane_bytes == 2) {
    err = trpx::launch_block<uint16_t, false>(words, widths, F, W, n, block,
                                              nb, tiles, tile_blocks, sm, ts,
                                              out, device, s);
  } else if (is_signed) {
    err = trpx::launch_block<int32_t, true>(words, widths, F, W, n, block, nb,
                                            tiles, tile_blocks, sm, ts, out,
                                            device, s);
  } else {
    err = trpx::launch_block<int32_t, false>(words, widths, F, W, n, block,
                                             nb, tiles, tile_blocks, sm, ts,
                                             out, device, s);
  }
  return int(err);
}
