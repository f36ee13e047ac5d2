// TRPX tiled decode kernels for Hopper (sm_90a): few big frames, and
// blocks of any size.
//
// Replaces the TPU kernel
// trpx_tpu/ops/pallas_unpack.py:decode_batch_pallas_tiled (the tiled
// branch of _kernel, fed by the host tile_prepass). It decodes what
// unpack.cu decodes: from each frame's stream words and the per-block
// widths of the host header walk, every value's width-bit field LSB first,
// sign-extended iff the target is signed.
//
// Bound on the H100: bytes moved: the compressed words and 1 byte of width
// per block in, 1, 2 or 4 bytes per value out (66 MB in and 537 MB out for 8
// frames of 4096x4096 u32), against a few integer operations per value.
//
// Where unpack.cu is weak this kernel is not: unpack.cu finds its tiles'
// offsets in one CTA per frame, which lags on a few frames of millions of
// blocks, and it stages whole tiles, so blocks of hundreds of values do not
// fit. Here tiles hold max(1, kTileValues / block) whole blocks (tile.cuh;
// ops/cuda_unpack.py:tiled_unpack_geometry), and three launches give
// every tile its own CTAs:
//   1. tile_part_bits, one warp per tile, many tiles per CTA: the tile's
//      bits without its first header, from its widths read with 16-byte
//      loads;
//   2. tile_starts, one CTA per frame: each tile's first header (coded
//      against the block before it) and the exclusive prefix, so a tile's
//      start is one int to read; no CTA sums the tiles before it;
//   3. unpack_tiles, one CTA per tile: unpack.cu's staged body (tile.cuh:
//      words staged with 16-byte loads, block offsets by a CTA scan,
//      16-byte output stores, block 12 a compile-time constant). A tile of
//      one block larger than kTileValues is walked in chunks of kTileValues
//      values, each staged on its own.
// Word reads stay clamped to the frame's row and to the staged words, as
// in unpack.cu.
#include <climits>

#include "tile.cuh"

namespace trpx {
namespace {

// unpack.cu's CTA shape for the extraction; 256 threads (8 tiles) a CTA of
// tile_part_bits; one CTA of 1,024 threads a frame for the scan
constexpr int kNT = 128;
constexpr int kMinCtas = 8;
constexpr int kPartThreads = 256;
constexpr int kScanThreads = 1024;

// Tile tile = blockIdx.x * 8 + warp of F * T: its bits without its first
// header (every block's fields, every header but the first) into part.
__global__ void __launch_bounds__(kPartThreads)
tile_part_bits(const uint8_t* __restrict__ widths, int n, int block, int nb,
               int tb, int tiles_total, int T, int* __restrict__ part) {
  const int tile = blockIdx.x * (kPartThreads / 32) + int(threadIdx.x >> 5);
  if (tile >= tiles_total) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int f = tile / T;
  const int b0 = (tile - f * T) * tb;
  const int b1 = min(b0 + tb, nb);
  const uint8_t* row = widths + size_t(f) * nb;
  // 16-byte chunks of the row that meet [b0, b1); chunk c holds blocks
  // b0 - shift + 16c ...
  const int shift = int(reinterpret_cast<uintptr_t>(row + b0) & 15u);
  const uint8_t* base = row + b0 - shift;
  const int count = b1 - b0 + shift;
  int sum = 0;
  for (int c = lane; c * 16 < count; c += 32) {
    const int e0 = c * 16;
    const int lo = max(e0, shift), hi = min(e0 + 16, count);
    union {
      uint4 u;
      uint8_t e[16];
    } v;
    // element e of base is block b0 - shift + e of the row: every read
    // below is of an e in [lo, hi) or lo - 1 > shift, inside [b0, b1)
    TRPX_CHECK(b0 >= 0 && b1 <= nb && lo >= shift && hi <= count);
    if (lo == e0 && hi == e0 + 16) {
      v.u = *reinterpret_cast<const uint4*>(base + e0);
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        v.e[q] = e0 + q >= lo && e0 + q < hi ? base[e0 + q] : 0;
      }
    }
    // the width of the block before this chunk's first (unused for the
    // tile's first block, whose header the scan adds)
    int prev = lo > shift ? int(base[lo - 1]) : 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int e = e0 + q;
      if (e >= lo && e < hi) {
        const int w = v.e[q];
        const int b = b0 + e - shift;
        sum += (b > b0 ? header_bits(w, prev) : 0) +
               w * block_count(b, block, n);
        prev = w;
      }
    }
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  TRPX_CHECK(tile < tiles_total);
  if (lane == 0) part[tile] = sum;
}

__global__ void __launch_bounds__(kScanThreads)
tile_starts(const int* __restrict__ part, const uint8_t* __restrict__ widths,
            int nb, int tb, int T, int* __restrict__ start) {
  __shared__ int s_scan[kScanThreads / 32 + 1];
  scan_tile_starts<kScanThreads>(part, widths, nb, tb, T, start, s_scan,
                                 [](int, int) {});
}

template <typename OutT, bool kSigned, int kB>
__global__ void __launch_bounds__(kNT, kMinCtas)
unpack_tiles(const uint32_t* __restrict__ words,
             const uint8_t* __restrict__ widths, int W, int n, int block_rt,
             int nb, int T, int tb, int words_cap,
             const int* __restrict__ start, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[kNT / 32 + 1];
  const int B = kB > 0 ? kB : block_rt;
  const int f = blockIdx.x / T;
  const int t = blockIdx.x - f * T;
  const int b0 = t * tb;
  const int nblk = min(tb, nb - b0);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(s_words + words_cap);
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_off + tb);

  // the tile's bit range and widths (s_w[0]: the block before the tile, 0
  // for the first), then each block's first payload bit in the tile
  TRPX_CHECK(t >= 0 && t < T && nblk >= 1 && nblk <= tb);
  const int P = start[size_t(f) * (T + 1) + t];
  const int E = start[size_t(f) * (T + 1) + t + 1];
  const uint8_t* wd = widths + size_t(f) * nb;
  for (int i = threadIdx.x; i <= nblk; i += kNT) {
    const int b = b0 - 1 + i;
    TRPX_CHECK(i <= tb && b < nb);  // s_w: tb + 1
    s_w[i] = b >= 0 ? wd[b] : 0;
  }
  __syncthreads();
  block_offsets<kNT, true>(s_w, nblk, B, n, b0, s_off,
                           s_scan TRPX_CHECKED_ARG(tb));
  __syncthreads();

  const uint32_t* row = words + size_t(f) * W;
  OutT* o = out + size_t(f) * n;
  const int v0 = b0 * B;
  const int nv = min(nblk * B, n - v0);
  // a block larger than the value budget (and not all zero) is walked in
  // chunks; its fields are w1 bits each from payload bit s_off[0]
  const int w1 = s_w[1];
  const bool chunked = nblk == 1 && nv > kTileValues && w1 > 0;
  for (int c0 = 0; c0 < nv; c0 += kTileValues) {
    const int c1 = chunked ? min(c0 + kTileValues, nv) : nv;
    const int lo = chunked ? P + s_off[0] + c0 * w1 : P;
    const int hi = chunked ? P + s_off[0] + c1 * w1 : E;
    // words [base, end): the chunk's range and the window past its last
    // bit, inside the row and inside the shared memory (stage_tile needs
    // 3 words of room for the 16-byte phase)
    const int base = max(min(lo >> 5, W - 2), 0);
    const int end = max(min(min((hi >> 5) + 2, W), base + words_cap - 3),
                        base + 2);
    const int shift = stage_tile<kNT>(row, base, end,
                                      s_words TRPX_CHECKED_ARG(W, words_cap));
    __syncthreads();
    extract_tile<kNT, OutT, kSigned, kB>(
        Staged{s_words, base - shift, base, end TRPX_CHECKED_ARG(words_cap)},
        P, B, b0, v0 + c0, v0 + c1, s_off, s_w, o TRPX_CHECKED_ARG(nblk, n));
    if (!chunked) break;
    __syncthreads();  // the next chunk restages s_words
  }
}

template <typename OutT, bool kSigned, int kB>
cudaError_t launch(const void* words, const void* widths, int F, int W,
                   int n, int block, int nb, int T, int tb,
                   const TileSmem& sm, int* part, int* start, void* out,
                   int device, cudaStream_t stream) {
  auto kernel = unpack_tiles<OutT, kSigned, kB>;
  // the attributes once per device, the residency once per (device,
  // shared-memory size): the launch is on every decode's hot path
  static Residency cache;
  int resident = 0;
  cudaError_t err = cache.get(kernel, kNT, sm.total, device, resident);
  if (err != cudaSuccess) return err;
  const uint8_t* wd = static_cast<const uint8_t*>(widths);
  const int tiles_total = F * T;
  tile_part_bits<<<(tiles_total + kPartThreads / 32 - 1) / (kPartThreads / 32),
                   kPartThreads, 0, stream>>>(wd, n, block, nb, tb,
                                              tiles_total, T, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_starts<<<F, kScanThreads, 0, stream>>>(part, wd, nb, tb, T, start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(tiles_total), kNT, sm.total, stream>>>(
      static_cast<const uint32_t*>(words), wd, W, n, block, nb, T, tb,
      sm.words_cap, start, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename OutT, bool kSigned>
cudaError_t launch_block(const void* words, const void* widths, int F, int W,
                         int n, int block, int nb, int T, int tb,
                         const TileSmem& sm, int* part, int* start,
                         void* out, int device, cudaStream_t stream) {
  if (block == 12) {  // DEFAULT_BLOCK: division by a constant
    return launch<OutT, kSigned, 12>(words, widths, F, W, n, block, nb, T,
                                     tb, sm, part, start, out, device,
                                     stream);
  }
  return launch<OutT, kSigned, 0>(words, widths, F, W, n, block, nb, T, tb,
                                  sm, part, start, out, device, stream);
}

}  // namespace
}  // namespace trpx

// Decodes F frames in tiles of `tile_blocks` blocks: `words` (F, W)
// uint32 streams with W >= 2 and at least two words after each stream's
// last bit, `widths` (F, nb) uint8 block widths, into `out` (F, n) of
// `lane_bytes`-byte lanes: uint8 (1, unsigned targets of at most 8 bits),
// uint16 (2, unsigned targets of at most 16 bits) or int32 (4). Rows start
// at any byte: each row's ragged ends are stored a value at a time.
// Sign-extends iff `is_signed`. `max_width` is the target's widest field
// (shared memory is sized for it). A tile of one block of more than
// kTileValues values is decoded in chunks of kTileValues values, a tile of
// several blocks in one piece. `smem_bytes` must be the dynamic shared
// memory of an unpack_tiles CTA (ops/cuda_unpack.py:tiled_unpack_geometry).
// Scratch: (F, T) int32 of tile bits, then (F, T + 1) int32 of tile
// starts, T = ceil(nb / tile_blocks) (tiled_unpack_scratch_ints).
// Launches on `stream` of device `device` and returns the first CUDA
// error.
extern "C" int trpx_unpack_tiled(const void* words, const void* widths,
                                 int F, int W, int n, int block,
                                 int tile_blocks, int max_width,
                                 int smem_bytes, int is_signed,
                                 int lane_bytes,
                                 void* scratch, void* out, int device,
                                 void* stream) {
  const trpx::DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || W < 2 || tile_blocks <= 0 ||
      max_width <= 0 || (lane_bytes != 1 && lane_bytes != 2 &&
                         lane_bytes != 4) ||
      (lane_bytes != 4 && is_signed)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  const int T = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * T > INT_MAX / 4) return int(cudaErrorInvalidValue);
  // a one-block tile stages a chunk of at most kTileValues values
  const bool one = tile_blocks == 1;
  const trpx::TileSmem sm(max_width,
                          one ? min(block, trpx::kTileValues) : block,
                          tile_blocks);
  if (sm.total != smem_bytes) return int(cudaErrorInvalidValue);
  int* part = static_cast<int*>(scratch);
  int* start = part + size_t(F) * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_bytes == 1) {
    err = trpx::launch_block<uint8_t, false>(words, widths, F, W, n, block,
                                             nb, T, tile_blocks, sm, part,
                                             start, out, device, s);
  } else if (lane_bytes == 2) {
    err = trpx::launch_block<uint16_t, false>(words, widths, F, W, n, block,
                                              nb, T, tile_blocks, sm, part,
                                              start, out, device, s);
  } else if (is_signed) {
    err = trpx::launch_block<int32_t, true>(words, widths, F, W, n, block,
                                            nb, T, tile_blocks, sm, part,
                                            start, out, device, s);
  } else {
    err = trpx::launch_block<int32_t, false>(words, widths, F, W, n, block,
                                             nb, T, tile_blocks, sm, part,
                                             start, out, device, s);
  }
  return int(err);
}
