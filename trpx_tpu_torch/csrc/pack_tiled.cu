// TRPX tiled encode kernels for Hopper (sm_90a): blocks of any size.
//
// Replaces the TPU kernel
// trpx_tpu/ops/pallas_pack.py:encode_batch_pallas_tiled (_tiled_kernel).
// It computes the stream of pack.cu, frame by frame: the block widths, the
// repeat/3/5/11-bit headers, every block's bit offset and the packed
// LSB-first words, plus each frame's bits and largest width. What the TPU
// kernel carries in SMEM from one sequential grid step to the next (the
// previous tile's last width and the running bit count) comes here from
// a scan between two parallel passes.
//
// Bound on the H100: bytes moved. 4 frames of 2048x2048 int32 in blocks
// of 1,024 read 67.1 MB of values and write 23.1 MB of words, against a
// few integer operations per value.
//
// It is the pack with no block-size limit (ops/coding.py routes to it the
// blocks too large for pack.cu's shared memory). Tiles hold
// max(1, kTileValues / block) whole blocks (tile.cuh;
// ops/cuda_pack.py:tiled_pack_geometry), so a batch makes thousands of
// CTAs whatever its block size. Three launches:
//   1. plan_tiles, one CTA per tile: the values in 16-byte coalesced loads;
//      each thread ORs the magnitudes of its vector, a warp whose vectors
//      lie in one block ORs them with __reduce_or_sync, others merge with
//      shared-memory atomicOr per block. Out: the block widths (F, nb) u8,
//      the tile's bits without its first header, and its largest width.
//   2. pack_starts, one CTA per frame: each tile's first header (against
//      the width of the block before it, from the table) and the
//      exclusive prefix, so a tile's start is one int to read; the frame's
//      bits and largest width. It zeroes the word holding each tile's
//      first bit and the word holding the frame's end.
//   3. place_tiles, one CTA per tile, value-parallel: block offsets by a
//      CTA scan; a thread per block ORs its header into the tile's stream
//      in shared memory, and a thread per 16-byte vector of values (one
//      coalesced load, straight from device memory) its fields: value j
//      of block i goes to bit s_off[i] + j * w_i, a run of fields of one
//      block through pack.cu's bit writer (atomicOr on the run's first and
//      last word, plain stores between). The tile's words then go out in
//      coalesced stores, plain for a word wholly inside the tile, atomicOr
//      for the two it shares with its neighbours, which launch 2 zeroed.
//      A tile of one block larger than kTileValues is placed in chunks of
//      kTileValues values, each handing its last, partial word to the next.
// Every word [0, bits / 32] of a frame is written (zero above its last
// bit); the words after them are left as they were, so the output needs
// no zero-fill. This holds for tiles of any bit count: a tile of a few
// all-zero blocks has a few header bits, and many tiles then share a word.
// Bit offsets are int32: the wrapper's FrameSpec refuses frames whose
// worst case reaches 2^31 bits.
#include <climits>

#include "tile.cuh"

namespace trpx {
namespace {

constexpr int kNT = 256;
constexpr int kScanThreads = 1024;

// Scratch of a launch (int32 words): per (frame, tile) its bits without
// the first header and its largest width, then the tile starts (F, T + 1),
// then the block widths (F, nb) u8. ops/cuda_pack.py:tiled_pack_scratch_ints.
struct PackTiledScratch {
  int* part;
  int* tmax;
  int* start;
  uint8_t* widths;
  PackTiledScratch(int* base, int F, int T) {
    part = base;
    tmax = part + size_t(F) * T;
    start = tmax + size_t(F) * T;
    widths = reinterpret_cast<uint8_t*>(start + size_t(F) * (T + 1));
  }
};

// 16 bytes of values in registers.
template <typename T>
union Vec {
  uint4 u;
  T e[16 / sizeof(T)];
};

// Vector c of the 16-byte aligned `base`: one 16-byte load (kStream:
// evict-first) when elements [lo, hi) hold it whole, else its elements
// inside [lo, hi) one at a time and zeros for the others.
template <bool kStream, typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* base, int c, int lo,
                                           int hi) {
  constexpr int kVec = 16 / int(sizeof(T));
  const int e0 = c * kVec;
  Vec<T> v;
  if (e0 >= lo && e0 + kVec <= hi) {
    const uint4* p = reinterpret_cast<const uint4*>(base + e0);
    v.u = kStream ? __ldcs(p) : *p;
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      v.e[q] = e0 + q >= lo && e0 + q < hi ? base[e0 + q] : T(0);
    }
  }
  return v;
}

template <typename T, int kB>
__global__ void __launch_bounds__(kNT)
plan_tiles(const T* __restrict__ frames, int n, int stride, int block_rt,
           int nb, int tb, int tiles, uint8_t* __restrict__ widths,
           int* __restrict__ part, int* __restrict__ tmax) {
  extern __shared__ uint32_t s_or[];  // tb: the OR of each block
  __shared__ int s_scan[kNT / 32 + 1];
  __shared__ int s_max;
  constexpr int kVec = 16 / int(sizeof(T));
  const unsigned full = 0xffffffffu;
  const int B = kB > 0 ? kB : block_rt;
  const int f = blockIdx.x / tiles;
  const int t = blockIdx.x - f * tiles;
  const int b0 = t * tb;
  const int nblk = min(tb, nb - b0);
  const int lane = threadIdx.x & 31;
  // the values read below are the tile's, of the row's stride elements;
  // s_or holds tb blocks
  TRPX_CHECK(t < tiles && nblk >= 1 && nblk <= tb &&
             (static_cast<long long>(b0) + nblk) * B <= stride);
  for (int i = threadIdx.x; i < nblk; i += kNT) s_or[i] = 0u;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();

  // the tile's values (zero past n) as 16-byte vectors from the aligned
  // address at or below its first; element e of `base` is value
  // e - shift of the tile
  const T* row = frames + size_t(f) * stride + size_t(b0) * B;
  const int shift = int((reinterpret_cast<uintptr_t>(row) & 15u) / sizeof(T));
  const T* base = row - shift;
  const int count = nblk * B + shift;
  const int nvec = (count + kVec - 1) / kVec;
  for (int c0 = 0; c0 < nvec; c0 += kNT) {  // the same trips for every warp
    const int c = c0 + int(threadIdx.x);
    const Vec<T> v = load_vec<false>(base, c, shift, count);
    const int lo = max(c * kVec, shift), hi = min(c * kVec + kVec, count);
    const bool valid = lo < hi;
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) m |= magnitude(v.e[q]);
    // blocks i0..i1 of the tile hold this vector's values
    const int i0 = valid ? (lo - shift) / B : -1;
    const int j0 = lo - shift - i0 * B;
    const int i1 = valid ? i0 + (j0 + hi - lo - 1) / B : -1;
    const int lead = __shfl_sync(full, i0, 0);
    if (__all_sync(full, !valid || (i0 == i1 && i0 == lead))) {
      m = __reduce_or_sync(full, m);
      TRPX_CHECK(!(lane == 0 && m) || (lead >= 0 && lead < nblk));
      if (lane == 0 && m) atomicOr(s_or + lead, m);
    } else if (valid && i0 == i1) {
      TRPX_CHECK(i0 >= 0 && i0 < nblk);
      if (m) atomicOr(s_or + i0, m);
    } else if (valid) {
      int i = i0, j = j0;
      uint32_t mm = 0;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        if (c * kVec + q >= lo && c * kVec + q < hi) {
          mm |= magnitude(v.e[q]);
          TRPX_CHECK(i >= 0 && i < nblk);
          if (++j == B) {
            if (mm) atomicOr(s_or + i, mm);
            mm = 0;
            j = 0;
            ++i;
          }
        }
      }
      TRPX_CHECK(!mm || (i >= 0 && i < nblk));
      if (mm) atomicOr(s_or + i, mm);
    }
  }
  __syncthreads();

  // widths into the table, and in place of the ORs
  uint8_t* wd = widths + size_t(f) * nb + b0;
  for (int i = threadIdx.x; i < nblk; i += kNT) {
    TRPX_CHECK(b0 + i < nb);
    const int w = width_of<T>(s_or[i]);
    wd[i] = uint8_t(w);
    s_or[i] = uint32_t(w);
  }
  __syncthreads();
  int sum = 0, mx = 0;
  for (int i = threadIdx.x; i < nblk; i += kNT) {
    const int w = int(s_or[i]);
    mx = max(mx, w);
    sum += (i ? header_bits(w, int(s_or[i - 1])) : 0) +
           w * block_count(b0 + i, B, n);
  }
  mx = __reduce_max_sync(full, mx);
  if (lane == 0) atomicMax(&s_max, mx);
  int total;
  cta_scan<kNT>(sum, s_scan, total);  // its barriers order s_max too
  if (threadIdx.x == 0) {
    part[blockIdx.x] = total;
    tmax[blockIdx.x] = s_max;
  }
}

__global__ void __launch_bounds__(kScanThreads)
pack_starts(const int* __restrict__ part, const int* __restrict__ tmax,
            const uint8_t* __restrict__ widths, int nb, int tb, int tiles,
            int n_words, int* __restrict__ start,
            uint32_t* __restrict__ words, int* __restrict__ bits,
            int* __restrict__ maxw) {
  __shared__ int s_scan[kScanThreads / 32 + 1];
  __shared__ int s_max;
  const int f = blockIdx.x;
  if (threadIdx.x == 0) s_max = 0;
  uint32_t* row = words + size_t(f) * n_words;
  const int total = scan_tile_starts<kScanThreads>(
      part, widths, nb, tb, tiles, start, s_scan,
      [row TRPX_CHECKED_ARG(n_words)](int, int P) {
        TRPX_CHECK(P >= 0 && (P >> 5) < n_words);
        row[P >> 5] = 0u;
      });
  int mx = 0;
  for (int t = threadIdx.x; t < tiles; t += kScanThreads) {
    mx = max(mx, tmax[size_t(f) * tiles + t]);
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_max, mx);
  __syncthreads();
  if (threadIdx.x == 0) {
    bits[f] = total;
    maxw[f] = s_max;
  }
}

// Ors v (a header, at most 12 bits) into the words at bit `pos`. Checked
// build: words holds cap words.
__device__ __forceinline__ void or_bits(uint32_t* words, int pos,
                                        uint32_t v TRPX_CHECKED_ARG(int cap)) {
  const uint64_t x = uint64_t(v) << (pos & 31);
  TRPX_CHECK(pos >= 0 && (pos >> 5) + ((x >> 32) ? 1 : 0) < cap);
  atomicOr(words + (pos >> 5), uint32_t(x));
  if (x >> 32) atomicOr(words + (pos >> 5) + 1, uint32_t(x >> 32));
}

template <typename T, int kB>
__global__ void __launch_bounds__(kNT)
place_tiles(const T* __restrict__ frames, int n, int stride, int block_rt,
            int nb, int tb, int tiles, int words_cap, int n_words,
            const uint8_t* __restrict__ widths,
            const int* __restrict__ start, uint32_t* __restrict__ words) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[kNT / 32 + 1];
  constexpr int kVec = 16 / int(sizeof(T));
  const int B = kB > 0 ? kB : block_rt;
  const int f = blockIdx.x / tiles;
  const int t = blockIdx.x - f * tiles;
  const int b0 = t * tb;
  const int nblk = min(tb, nb - b0);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(s_words + words_cap);
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_off + tb);

  // the tile's bit range and widths (s_w[0]: the block before the tile, 0
  // for the first), then each block's first payload bit in the tile
  // the values read below are the tile's, of the row's stride elements
  TRPX_CHECK(t < tiles && nblk >= 1 && nblk <= tb &&
             (static_cast<long long>(b0) + nblk) * B <= stride);
  const int P = start[size_t(f) * (tiles + 1) + t];
  const int bits = start[size_t(f) * (tiles + 1) + t + 1] - P;
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

  // bit p of the tile is bit r + p of its word 0, word P / 32 of the frame
  const int r = P & 31;
  uint32_t* out = words + size_t(f) * n_words + (P >> 5);
  // the tile's values as 16-byte vectors from the aligned address at or
  // below its first: element e of `base` is value e - shift of the tile
  const T* row = frames + size_t(f) * stride + size_t(b0) * B;
  const int shift = int((reinterpret_cast<uintptr_t>(row) & 15u) / sizeof(T));
  const T* base = row - shift;
  const int nv = nblk * B;  // zero past n
  const int w1 = s_w[1];
  // a block larger than the value budget is placed in chunks; one with no
  // fields (all zero) loads nothing
  const bool chunked = nblk == 1 && nv > kTileValues && w1 > 0;
  const bool fields = !(nblk == 1 && w1 == 0);
  // s_words[k] is word g0 + k of the tile; a chunk leaves its last, partial
  // word to the next (carry)
  int g0 = 0;
  uint32_t carry = 0;
  for (int c0 = 0; c0 < nv; c0 += kTileValues) {
    const int c1 = chunked ? min(c0 + kTileValues, nv) : nv;
    const bool last = c1 == nv;
    const int e1 = last ? r + bits : r + s_off[0] + c1 * w1;  // its end
    const int used = ((e1 + 31) >> 5) - g0;
    TRPX_CHECK(P >= 0 && used <= words_cap);
    for (int k = threadIdx.x; k < used; k += kNT) s_words[k] = k ? 0u : carry;
    __syncthreads();
    if (c0 == 0) {
      for (int i = threadIdx.x; i < nblk; i += kNT) {
        const int w = s_w[i + 1], prev = s_w[i];
        or_bits(s_words, r + s_off[i] - header_bits(w, prev),
                header_value(w, prev) TRPX_CHECKED_ARG(words_cap));
      }
    }
    // each thread a vector of values: it ORs their fields, a run of
    // consecutive fields of one block at a time, into the shared words
    const int lo_e = c0 + shift, hi_e = c1 + shift;
    for (int c = lo_e / kVec + int(threadIdx.x); fields && c * kVec < hi_e;
         c += kNT) {
      const Vec<T> v = load_vec<true>(base, c, lo_e, hi_e);
      const int e0 = c * kVec;
      const int lo = max(e0, lo_e), hi = min(e0 + kVec, hi_e);
      int i = (lo - shift) / B;
      int j = lo - shift - i * B;
      TRPX_CHECK(i >= 0 && i < nblk);
      int w = s_w[i + 1];
      int count = block_count(b0 + i, B, n);
      BitWriter bw(s_words, 0 TRPX_CHECKED_ARG(words_cap));
      bool open = false;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        if (e0 + q >= lo && e0 + q < hi) {
          if (j == B) {  // the next block
            if (open) bw.finish();
            open = false;
            ++i;
            j = 0;
            TRPX_CHECK(i < nblk);
            w = s_w[i + 1];
            count = block_count(b0 + i, B, n);
          }
          if (w && j < count) {
            if (!open) {
              bw = BitWriter(s_words, r + s_off[i] + j * w -
                                          32 * g0 TRPX_CHECKED_ARG(words_cap));
              open = true;
            }
            bw.put(field(v.e[q], w), w);
          }
          ++j;
        }
      }
      if (open) bw.finish();
    }
    __syncthreads();
    // words [g0, g1) are whole now: a plain coalesced store for a word
    // wholly inside the tile, atomicOr for the two it shares with its
    // neighbours (zeroed by pack_starts)
    const int g1 = last ? (e1 + 31) >> 5 : e1 >> 5;
    for (int g = g0 + int(threadIdx.x); g < g1; g += kNT) {
      TRPX_CHECK(g - g0 < words_cap && (P >> 5) + g < n_words);
      const uint32_t x = s_words[g - g0];
      const int q = 32 * g - r;
      if (q >= 0 && q + 32 <= bits) {
        out[g] = x;
      } else {
        atomicOr(out + g, x);
      }
    }
    if (last) break;
    TRPX_CHECK(!(e1 & 31) || g1 - g0 < words_cap);
    carry = (e1 & 31) ? s_words[g1 - g0] : 0u;
    g0 = g1;
    __syncthreads();  // the next chunk rewrites s_words
  }
}

template <typename T, int kB>
cudaError_t launch(const void* frames, int F, int n, int stride, int block,
                   int nb, int tb, int tiles, const TileSmem& sm,
                   int n_words, const PackTiledScratch& sc, void* words,
                   void* bits, void* maxw, int device, cudaStream_t stream) {
  const T* x = static_cast<const T*>(frames);
  // each kernel's attributes once per device, its residency once per
  // (device, shared-memory size)
  static Residency plan_cache, place_cache;
  int resident = 0;
  const int plan_smem = 4 * tb;
  auto plan = plan_tiles<T, kB>;
  auto place = place_tiles<T, kB>;
  cudaError_t err = plan_cache.get(plan, kNT, plan_smem, device, resident);
  if (err != cudaSuccess) return err;
  err = place_cache.get(place, kNT, sm.total, device, resident);
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned(F) * unsigned(tiles);
  plan<<<grid, kNT, plan_smem, stream>>>(
      x, n, stride, block, nb, tb, tiles, sc.widths, sc.part, sc.tmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pack_starts<<<F, kScanThreads, 0, stream>>>(
      sc.part, sc.tmax, sc.widths, nb, tb, tiles, n_words, sc.start,
      static_cast<uint32_t*>(words), static_cast<int*>(bits),
      static_cast<int*>(maxw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place<<<grid, kNT, sm.total, stream>>>(
      x, n, stride, block, nb, tb, tiles, sm.words_cap, n_words, sc.widths,
      sc.start, static_cast<uint32_t*>(words));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* frames, int F, int n, int stride,
                         int block, int nb, int tb, int tiles,
                         const TileSmem& sm, int n_words,
                         const PackTiledScratch& sc, void* words, void* bits,
                         void* maxw, int device, cudaStream_t stream) {
  if (block == 12) {  // DEFAULT_BLOCK: division by a constant
    return launch<T, 12>(frames, F, n, stride, block, nb, tb, tiles, sm,
                         n_words, sc, words, bits, maxw, device, stream);
  }
  return launch<T, 0>(frames, F, n, stride, block, nb, tb, tiles, sm,
                      n_words, sc, words, bits, maxw, device, stream);
}

}  // namespace
}  // namespace trpx

// Encodes F frames of n values each (row stride `stride` >= nb * block
// elements, zero past n; element size `itemsize` bytes, signed iff
// `is_signed`) in tiles of `tile_blocks` blocks into `words` (F, n_words)
// uint32: words [0, bits / 32] of each frame hold its stream, zero above
// its last bit; the words after them are left as they were. Writes each
// frame's total bits and largest width into `bits` and `maxw` (F,) int32.
// `smem_bytes` must be the dynamic shared memory of a place_tiles CTA
// (ops/cuda_pack.py:tiled_pack_geometry). `scratch` holds
// ops/cuda_pack.py:tiled_pack_scratch_ints int32 (PackTiledScratch).
// Nothing needs to be zero on entry. Launches on `stream` of device
// `device` and returns the first CUDA error.
extern "C" int trpx_pack_tiled(const void* frames, int itemsize,
                               int is_signed, int F, int n, int stride,
                               int block, int n_words, int tile_blocks,
                               int smem_bytes, void* words, void* bits,
                               void* maxw, void* scratch, int device,
                               void* stream) {
  const trpx::DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || n_words < 2 || tile_blocks <= 0 ||
      (itemsize != 1 && itemsize != 2 && itemsize != 4)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  if (int64_t(nb) * block > stride) return int(cudaErrorInvalidValue);
  const int tiles = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * tiles > INT_MAX / 4) return int(cudaErrorInvalidValue);
  // a one-block tile places a chunk of at most kTileValues values
  const trpx::TileSmem sm(
      8 * itemsize + (is_signed ? 1 : 0),
      tile_blocks == 1 ? min(block, trpx::kTileValues) : block, tile_blocks);
  if (sm.total != smem_bytes) return int(cudaErrorInvalidValue);
  const trpx::PackTiledScratch sc(static_cast<int*>(scratch), F, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRPX_LAUNCH(T)                                                     \
  err = trpx::launch_block<T>(frames, F, n, stride, block, nb, tile_blocks, \
                              tiles, sm, n_words, sc, words, bits, maxw,    \
                              device, s)
  switch (itemsize * 2 + (is_signed ? 1 : 0)) {
    case 2: TRPX_LAUNCH(uint8_t); break;
    case 3: TRPX_LAUNCH(int8_t); break;
    case 4: TRPX_LAUNCH(uint16_t); break;
    case 5: TRPX_LAUNCH(int16_t); break;
    case 8: TRPX_LAUNCH(uint32_t); break;
    case 9: TRPX_LAUNCH(int32_t); break;
    default: return int(cudaErrorInvalidValue);
  }
#undef TRPX_LAUNCH
  return int(err);
}
