// TRPX encode kernel for Hopper (sm_90a): one pass over the frames.
//
// Replaces the TPU kernel trpx_tpu/ops/pallas_pack.py:encode_batch_pallas
// (_kernel -> _encode_body -> _plan_planes). It computes what that kernel
// computes for each frame of a batch: the block widths, the repeat/3/5/11-bit
// header codes, an exclusive prefix of the block bit lengths, and the packed
// LSB-first stream in little-endian 32-bit words, plus the frame's total bits
// and largest width. It does not copy the TPU kernel's merge tree, which
// exists only because scatter serialises on a TPU.
//
// Bound on the H100: bytes moved. 256 frames of 512x512 uint16 read 134 MB
// of pixels and write 28.5 MB of words (Poisson-like data) against a few
// integer operations per value; the L2 (50 MB) holds a third of the batch,
// so every pixel must come from device memory once and only once.
//
// Design. Each frame is cut into tiles of `tile_blocks` blocks. The only
// value that chains the tiles of a frame is each tile's bit offset, and it
// comes from a per-frame decoupled look-back over tile descriptors in the
// same pass. A grid of persistent CTAs (as many as fit on the card at
// once) takes tiles from an atomic ticket in tile-major order: ticket v is
// tile v / F of frame v % F, so a tile only ever waits on tiles of smaller
// tickets, which CTAs already hold (the waits always end), and the tile
// before it was taken F tickets earlier. For each tile a CTA
//   1. has its values, and those of the block before the tile (whose
//      width codes the tile's first header), in shared memory: cp.async
//      copied them in 16-byte chunks while the CTA wrote out its previous
//      tile (the values are free once a tile is assembled), and its ticket
//      was taken meanwhile; a stream buffer sized for the worst case is
//      zeroed;
//   2. computes the block widths (a block of 12 values in three vector
//      loads) and, by a CTA scan, each block's offset in the tile;
//   3. in warp 0: computes the last 32 bits of the tile's stream from its
//      last 32 blocks and publishes them with its bit count, then sums the
//      bit counts of the tiles before it back to the first whose inclusive
//      prefix is published (its offset P), publishes its own prefix and
//      reads the previous tile's last 32 bits; meanwhile
//   4. the other warps assemble the tile's stream at bit 0 in shared
//      memory (atomicOr only on the two words a block shares with its
//      neighbours; fields of up to 8 or 16 bits go in fours or pairs);
//   5. writes the global words [P / 32, P_next / 32) with coalesced plain
//      stores, each shifted into place with __funnelshift_l; the first
//      word takes the previous tile's last P % 32 bits from that tile's
//      descriptor. Every output word is written once, by one tile, so the
//      words need no zero-fill; the frame's last tile also writes the word
//      holding bit `bits` (zero above the stream).
// Words past (bits / 32) of each frame are left undefined. The frame's
// largest width is one atomicMax per tile into the zeroed (F,) maxw.
// Tiles hold at least 32 blocks (each at least one header bit), so the 32
// bits before a tile all belong to the tile before it.
#include "tile.cuh"

namespace trpx {
namespace {

// 256 threads a CTA, and at least 5 CTAs an SM (at most 51 registers a
// thread): with ~41 KB of shared memory a CTA (pack_geometry) five fit an
// SM, and on an H100 80GB HBM3 at 256 x 512x512 u16 this beat 128- and
// 512-thread CTAs and 4 CTAs an SM (PERF.md, section 6)
constexpr int kNT = 256;
constexpr int kMinCtas = 5;
constexpr unsigned long long kPublished = 1ull << 63;

// Shared-memory carve-up of a pack CTA: the staged values (16-byte
// rounded; the tile, the block before it and the 16-byte phase),
// the stream words, the block offsets and the widths (with the block
// before the tile first). ops/cuda_pack.py:pack_smem_bytes computes the
// same numbers.
struct PackSmem {
  int vals_bytes, out_words, total;
  __host__ __device__ PackSmem(int itemsize, int max_width, int block,
                               int tile_blocks) {
    const long long vals =
        (static_cast<long long>(tile_blocks + 1) * block + 16 / itemsize) *
        itemsize;
    vals_bytes = int((vals + 15) / 16 * 16);
    const long long bits =
        static_cast<long long>(tile_blocks) * (12 + block * max_width);
    out_words = int(((bits + 31) / 32 + 4 + 3) / 4 * 4);
    total = vals_bytes + 4 * out_words + 4 * tile_blocks +
            (tile_blocks + 1 + 15) / 16 * 16;
  }
};

// Per-launch scratch, zero on entry: the ticket counter (and a pad word),
// then per (frame, tile) two descriptors, bit 63 = published: the
// aggregate (bits 32..62 the tile's bit count, bits 0..31 the last 32
// bits of its stream) and the inclusive prefix (bits 0..31 the frame's
// bits up to the tile's end); then the frames' largest widths.
struct PackScratch {
  unsigned* ticket;
  unsigned long long* agg;
  unsigned long long* incl;
  int* maxw;
  __host__ __device__ PackScratch(int* base, int tiles_total) {
    ticket = reinterpret_cast<unsigned*>(base);
    agg = reinterpret_cast<unsigned long long*>(base + 2);
    incl = agg + tiles_total;
    maxw = reinterpret_cast<int*>(incl + tiles_total);
  }
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p),
               "l"(kPublished | v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spins until the descriptor is published; returns it.
__device__ __forceinline__ unsigned long long wait_published(
    const unsigned long long* p) {
  unsigned long long v;
  while (!((v = load_acquire(p)) & kPublished)) __nanosleep(32);
  return v;
}

// The exclusive prefix of tile t at index idx = f * tiles + t: the bit
// counts of tiles t-1, t-2, ... up to the first whose inclusive prefix is
// published.
__device__ __forceinline__ int look_back(const PackScratch& sc, int idx,
                                         int t) {
  int excl = 0;
  int j = idx - 1;
  const int first = idx - t;
  TRPX_CHECK(first >= 0);
  while (j >= first) {
    const unsigned long long p = load_acquire(sc.incl + j);
    if (p & kPublished) return excl + int(uint32_t(p));
    const unsigned long long g = load_acquire(sc.agg + j);
    if (g & kPublished) {
      excl += int((g >> 32) & 0x7fffffffull);
      --j;
    } else {
      __nanosleep(32);
    }
  }
  return excl;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Starts copying elements [lo, hi) of `row` into `dst` as stage_tile
// (tile.cuh) places them, without waiting: cp.async for every whole
// 16-byte chunk, committed as one group, and a register load for this
// thread's ragged-end element, if any (at most 30, one a thread). Returns
// the phase `shift`; land() stores the ragged element once the copy is
// waited for. Checked build: the row holds row_len elements, dst dst_cap.
template <typename T>
struct Staging {
  int shift, rag_at;
  T rag;
  __device__ __forceinline__ void start(
      const T* row, int lo, int hi,
      T* dst TRPX_CHECKED_ARG(int row_len, int dst_cap)) {
    constexpr int kVec = 16 / int(sizeof(T));
    shift = int((reinterpret_cast<uintptr_t>(row + lo) & 15u) / sizeof(T));
    const T* base = row + lo - shift;  // 16-byte aligned
    const int count = hi - lo + shift;
    const int c_lo = shift ? 1 : 0;
    const int c_hi = count / kVec;
    const unsigned d = unsigned(__cvta_generic_to_shared(dst));
    // element e of base is element lo - shift + e of the row, inside
    // [lo, hi) for e in [shift, count)
    TRPX_CHECK(0 <= lo && lo <= hi && hi <= row_len);
    for (int c = c_lo + int(threadIdx.x); c < c_hi; c += kNT) {
      TRPX_CHECK(c * kVec >= shift && (c + 1) * kVec <= count &&
                 (c + 1) * kVec <= dst_cap);
      cp_async16(d + 16u * unsigned(c), base + c * kVec);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    const int head_end = min(c_lo * kVec, count);
    const int tail_start = max(c_hi * kVec, head_end);
    const int k = int(threadIdx.x);
    const int heads = head_end - shift;
    rag_at = k < heads ? shift + k
                       : (k - heads < count - tail_start
                              ? tail_start + (k - heads) : -1);
    TRPX_CHECK(rag_at < 0 ||
               (rag_at >= shift && rag_at < count && rag_at < dst_cap));
    if (rag_at >= 0) rag = base[rag_at];
  }
  __device__ __forceinline__ void land(T* dst) const {
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (rag_at >= 0) dst[rag_at] = rag;
  }
};

struct TileOf {
  int f, t, b0, nblk, pre;
  __device__ __forceinline__ TileOf(int v, int F, int tile_blocks, int nb) {
    t = v / F;
    f = v - t * F;
    b0 = t * tile_blocks;
    nblk = min(tile_blocks, nb - b0);
    pre = t ? 1 : 0;  // the block before the tile is staged too
  }
};

// The part of an n-bit pattern `v` at bit `rel` of the stream that falls
// into the 32-bit window starting at bit 0 (rel < 32; rel may be negative).
__device__ __forceinline__ uint32_t in_window(uint64_t v, int rel, int n) {
  if (rel + n <= 0) return 0u;
  return rel >= 0 ? uint32_t(v << rel) : uint32_t(v >> -rel);
}

// The last 32 bits of a tile's stream of `total` >= 32 bits, by one warp:
// they lie in the tile's last 32 blocks (every block has a header bit), so
// lane k ORs in the bits of block nblk - 1 - k that fall into the window.
// Checked build: vals holds vcap values.
template <int kB, typename T>
__device__ __forceinline__ uint32_t stream_tail(
    const T* vals, int shift, int pre, int B, int n, int b0, int nblk,
    int total, const uint8_t* s_w, const int* s_off TRPX_CHECKED_ARG(
        int vcap)) {
  const int i = nblk - 1 - int(threadIdx.x & 31);
  uint32_t acc = 0;
  if (i >= 0) {
    const int lo = total - 32;
    const int w = s_w[i + 1], prev = s_w[i];
    const int hb = header_bits(w, prev);
    int p = s_off[i] - lo;
    if (p + hb + w * B > 0) {
      acc |= in_window(header_value(w, prev), p, hb);
      p += hb;
      const int count = min(B, n - (b0 + i) * B);
      TRPX_CHECK(shift + (i + pre) * B + count <= vcap);
      const T* xv = vals + shift + (i + pre) * B;
      for (int j = 0; j < count && w; ++j, p += w) {
        acc |= in_window(field(xv[j], w), p, w);
      }
    }
  }
  return __reduce_or_sync(0xffffffffu, acc);
}

// The 12 values of a block of a 12-value-block tile, read from shared
// memory with three vector loads (32-, 64- or 128-bit for 8-, 16- or
// 32-bit values) into 32-bit registers. A block of 12 values spans a
// multiple of the load width, so every block is aligned once the tile's
// phase `shift` is a multiple of 4 values.
template <typename T>
struct Block12 {
  static constexpr int kWords = 12 * int(sizeof(T)) / 4;
  uint32_t r[kWords];
  __device__ __forceinline__ explicit Block12(const T* x) {
    if constexpr (sizeof(T) == 1) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
      for (int k = 0; k < 3; ++k) r[k] = p[k];
    } else if constexpr (sizeof(T) == 2) {
      const uint2* p = reinterpret_cast<const uint2*>(x);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint2 v = p[k];
        r[2 * k] = v.x;
        r[2 * k + 1] = v.y;
      }
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(x);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 v = p[k];
        r[4 * k] = v.x;
        r[4 * k + 1] = v.y;
        r[4 * k + 2] = v.z;
        r[4 * k + 3] = v.w;
      }
    }
  }
  // value j (a compile-time index once unrolled)
  __device__ __forceinline__ T value(int j) const {
    if constexpr (sizeof(T) == 4) {
      return T(r[j]);
    } else {
      constexpr int kPer = 4 / int(sizeof(T));
      return T(r[j / kPer] >> (8 * int(sizeof(T)) * (j % kPer)));
    }
  }
  // the block's width: the bit length of the OR of its magnitudes, plus a
  // sign bit for signed types
  __device__ __forceinline__ int width() const {
    uint32_t m = 0;
    if constexpr (std::is_signed<T>::value) {
#pragma unroll
      for (int j = 0; j < 12; ++j) m |= magnitude(value(j));
      return m ? 33 - __clz(m) : 0;
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) m |= r[k];
      if constexpr (sizeof(T) == 1) m |= m >> 16;
      if constexpr (sizeof(T) <= 2) m = (m | (m >> (8 * sizeof(T)))) &
                                        ((1u << (8 * sizeof(T))) - 1u);
      return m ? 32 - __clz(m) : 0;
    }
  }
  // the w low bits of value j (w <= 32)
  __device__ __forceinline__ uint32_t field32(int j, int w) const {
    const uint32_t v = uint32_t(value(j));
    if constexpr (std::is_signed<T>::value) {
      return w < 32 ? v & ((1u << w) - 1u) : v;
    } else {
      return v;  // below 2^w already
    }
  }
  // writes the 12 fields of width w >= 1: four to a put where 4w <= 32,
  // two where 2w <= 32, else one (a 33-bit int32 field)
  __device__ __forceinline__ void put_fields(BitWriter& bw, int w) const {
    if (sizeof(T) == 1 && 4 * w <= 32) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bw.put(field32(4 * c, w) | (field32(4 * c + 1, w) << w) |
                   (field32(4 * c + 2, w) << (2 * w)) |
                   (field32(4 * c + 3, w) << (3 * w)),
               4 * w);
      }
    } else if (2 * w <= 32) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        bw.put(field32(2 * c, w) | (field32(2 * c + 1, w) << w), 2 * w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) bw.put(field(value(j), w), w);
    }
  }
};

// Encodes tile v of the batch from its staged values `vals` (phase
// `shift`): steps 2-4 of the design note, up to the tile's stream in
// s_out, its offset and the previous tile's tail in s_misc; returns the
// tile's bit count. Every thread must call it; it ends with a barrier,
// after which no staged value is read. Checked build: vals holds vcap
// values, s_out out_words words.
template <typename T, int kB>
__device__ __forceinline__ int pack_tile(
    int v, const T* vals, int shift, int F, int n, int B, int nb, int tiles,
    int tile_blocks, int n_words, uint32_t* __restrict__ words,
    int* __restrict__ bits, const PackScratch& sc, uint32_t* s_out,
    int* s_off, uint8_t* s_w, int* s_scan,
    int* s_misc TRPX_CHECKED_ARG(int vcap, int out_words)) {
  const TileOf tk(v, F, tile_blocks, nb);
  const int idx = tk.f * tiles + tk.t;
  const int pre = tk.pre;
  TRPX_CHECK(tk.f < F && idx < F * tiles && tk.nblk >= 1 &&
             tk.nblk <= tile_blocks);

  // 2. widths (s_w[i + 1] of block b0 + i, s_w[0] of the block before),
  //    then block offsets: a thread scans a run of consecutive blocks.
  //    12-value blocks whose vector loads are aligned (all of them, unless
  //    the frames start off a 16-byte boundary) take Block12
  const bool fast = kB == 12 && (shift & 3) == 0;
  int my_max = 0;
  for (int i = threadIdx.x; i < tk.nblk + pre; i += kNT) {
    const int b = tk.b0 - pre + i;
    const int count = min(B, n - b * B);
    // s_w holds tile_blocks + 1 widths
    TRPX_CHECK(i + 1 - pre <= tile_blocks && shift + i * B + count <= vcap);
    const T* xv = vals + shift + i * B;
    const int w = fast && count == 12 ? Block12<T>(xv).width()
                                      : tile_block_width<kB>(xv, count);
    s_w[i + 1 - pre] = uint8_t(w);
    if (i >= pre) my_max = max(my_max, w);
  }
  __syncthreads();
  const int per = (tk.nblk + kNT - 1) / kNT;
  const int i0 = min(int(threadIdx.x) * per, tk.nblk);
  const int i1 = min(i0 + per, tk.nblk);
  int sum = 0;
  for (int i = i0; i < i1; ++i) {
    TRPX_CHECK(i < tile_blocks);
    const int w = s_w[i + 1];
    sum += header_bits(w, s_w[i]) + w * min(B, n - (tk.b0 + i) * B);
  }
  int total;
  int run = cta_scan<kNT>(sum, s_scan, total);
  for (int i = i0; i < i1; ++i) {
    TRPX_CHECK(i < tile_blocks);
    const int w = s_w[i + 1];
    s_off[i] = run;
    run += header_bits(w, s_w[i]) + w * min(B, n - (tk.b0 + i) * B);
  }
  __syncthreads();

  // 3. warp 0: the tile's tail and bit count out, then its offset in the
  //    frame and the previous tile's tail in (the look-back overlaps the
  //    other warps' assembly)
  if (threadIdx.x < 32) {
    const uint32_t tail =
        total >= 32 ? stream_tail<kB>(vals, shift, pre, B, n, tk.b0, tk.nblk,
                                      total, s_w,
                                      s_off TRPX_CHECKED_ARG(vcap))
                    : 0u;
    if (threadIdx.x == 0) {
      store_release(sc.agg + idx,
                    (static_cast<unsigned long long>(total) << 32) | tail);
      int off = 0;
      uint32_t pred = 0;
      if (tk.t == 0) {
        store_release(sc.incl + idx, uint32_t(total));
      } else {
        off = look_back(sc, idx, tk.t);
        store_release(sc.incl + idx, uint32_t(off + total));
        pred = uint32_t(wait_published(sc.agg + idx - 1));
      }
      s_misc[1] = off;
      s_misc[2] = int(pred);
      if (tk.t == tiles - 1) bits[tk.f] = off + total;
    }
  }

  // 4. assemble the tile's stream from bit 0
  for (int i = threadIdx.x; i < tk.nblk; i += kNT) {
    TRPX_CHECK(i < tile_blocks);
    const int w = s_w[i + 1];
    const int prev = s_w[i];
    const int count = min(B, n - (tk.b0 + i) * B);
    BitWriter bw(s_out, s_off[i] TRPX_CHECKED_ARG(out_words));
    bw.put(header_value(w, prev), header_bits(w, prev));
    if (w) {
      TRPX_CHECK(shift + (i + pre) * B + count <= vcap);
      const T* xv = vals + shift + (i + pre) * B;
      if (fast && count == 12) {
        Block12<T>(xv).put_fields(bw, w);
      } else if (kB > 0 && count == kB) {
#pragma unroll
        for (int j = 0; j < (kB > 0 ? kB : 1); ++j) {
          bw.put(field(xv[j], w), w);
        }
      } else {
        for (int j = 0; j < count; ++j) bw.put(field(xv[j], w), w);
      }
    }
    bw.finish();
  }
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_misc[3], my_max);
  __syncthreads();

  if (threadIdx.x == 0) atomicMax(sc.maxw + tk.f, s_misc[3]);
  return total;
}

// Step 5 of tile v, whose stream of `total` bits is in s_out and whose
// offset and previous tail pack_tile left in s_misc: the tile's words,
// shifted to the offset's phase. Reads no staged value. Checked build:
// s_out holds out_words words.
__device__ __forceinline__ void write_tile(
    int v, int total, int F, int tiles, int n_words,
    uint32_t* __restrict__ words, const uint32_t* s_out,
    const int* s_misc TRPX_CHECKED_ARG(int out_words)) {
  const int t = v / F, f = v - t * F;
  const int off = s_misc[1];
  const uint32_t pred = uint32_t(s_misc[2]);
  const int r = off & 31;
  const int nw = ((off + total) >> 5) - (off >> 5) + (t == tiles - 1);
  uint32_t* out = words + size_t(f) * n_words + (off >> 5);
  for (int k = threadIdx.x; k < nw; k += kNT) {
    TRPX_CHECK(off >= 0 && (off >> 5) + k < n_words && k < out_words);
    const uint32_t hi = s_out[k];
    const uint32_t lo = k ? s_out[k - 1] : pred;
    out[k] = r ? __funnelshift_l(lo, hi, r) : hi;
  }
}

template <typename T, int kB>
__global__ void __launch_bounds__(kNT, kMinCtas)
pack_kernel(const T* __restrict__ frames, int F, int n, int stride,
            int block_rt, int nb, int tiles, int tile_blocks, int vals_bytes,
            int out_words, int n_words, uint32_t* __restrict__ words,
            int* __restrict__ bits, PackScratch sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[kNT / 32 + 1];
  // ticket, offset, previous tail, max width, next ticket
  __shared__ int s_misc[5];
  const int B = kB > 0 ? kB : block_rt;
  const int n_tiles = F * tiles;
  T* s_vals = reinterpret_cast<T*>(smem);
  uint32_t* s_out = reinterpret_cast<uint32_t*>(smem + vals_bytes);
  int* s_off = reinterpret_cast<int*>(s_out + out_words);
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_off + tile_blocks);
  uint4* s_out4 = reinterpret_cast<uint4*>(s_out);

  // the first tile: its ticket, its copy, a zeroed stream buffer
  if (threadIdx.x == 0) {
    s_misc[0] = int(atomicAdd(sc.ticket, 1u));
    s_misc[3] = 0;
  }
  for (int i = threadIdx.x; i < out_words / 4; i += kNT) {
    s_out4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  int v = s_misc[0];
  if (v >= n_tiles) return;
  Staging<T> stage;
  {
    const TileOf tl(v, F, tile_blocks, nb);
    stage.start(frames + size_t(tl.f) * stride, (tl.b0 - tl.pre) * B,
                (tl.b0 + tl.nblk) * B,
                s_vals TRPX_CHECKED_ARG(stride, vals_bytes / int(sizeof(T))));
  }
  while (true) {
    // the next ticket, taken while this tile's copy lands
    if (threadIdx.x == 0) s_misc[4] = int(atomicAdd(sc.ticket, 1u));
    stage.land(s_vals);
    if (threadIdx.x == 0 && v < F) s_w[0] = 0;  // a frame starts at 0
    __syncthreads();
    const int total = pack_tile<T, kB>(
        v, s_vals, stage.shift, F, n, B, nb, tiles, tile_blocks, n_words,
        words, bits, sc, s_out, s_off, s_w, s_scan,
        s_misc TRPX_CHECKED_ARG(vals_bytes / int(sizeof(T)), out_words));
    // the staged values are free: the next tile's copy overlaps this
    // tile's writes
    const int vn = s_misc[4];
    if (vn < n_tiles) {
      const TileOf tn(vn, F, tile_blocks, nb);
      stage.start(frames + size_t(tn.f) * stride, (tn.b0 - tn.pre) * B,
                  (tn.b0 + tn.nblk) * B,
                  s_vals TRPX_CHECKED_ARG(stride,
                                          vals_bytes / int(sizeof(T))));
    }
    write_tile(v, total, F, tiles, n_words, words, s_out,
               s_misc TRPX_CHECKED_ARG(out_words));
    if (vn >= n_tiles) break;
    __syncthreads();  // the writes are done with s_out and s_misc
    if (threadIdx.x == 0) s_misc[3] = 0;
    for (int i = threadIdx.x; i < out_words / 4; i += kNT) {
      s_out4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    v = vn;
  }
}

template <typename T, int kB>
cudaError_t launch(const void* frames, int F, int n, int stride, int block,
                   int nb, int tiles, int tile_blocks, const PackSmem& sm,
                   int n_words, void* words, void* bits,
                   const PackScratch& sc, int device, cudaStream_t stream) {
  auto kernel = pack_kernel<T, kB>;
  // resident CTAs of this instance at this shared-memory size, looked up
  // once per (device, size): the launch is on every encode's hot path
  static Residency cache;
  int resident = 0;
  cudaError_t err = cache.get(kernel, kNT, sm.total, device, resident);
  if (err != cudaSuccess) return err;
  const long long ctas = min(static_cast<long long>(F) * tiles,
                             static_cast<long long>(resident));
  kernel<<<unsigned(ctas), kNT, sm.total, stream>>>(
      static_cast<const T*>(frames), F, n, stride, block, nb, tiles,
      tile_blocks, sm.vals_bytes, sm.out_words, n_words,
      static_cast<uint32_t*>(words), static_cast<int*>(bits), sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* frames, int F, int n, int stride,
                         int block, int nb, int tiles, int tile_blocks,
                         const PackSmem& sm, int n_words, void* words,
                         void* bits, const PackScratch& sc, int device,
                         cudaStream_t stream) {
  if (block == 12) {  // DEFAULT_BLOCK: loops over a block unrolled
    return launch<T, 12>(frames, F, n, stride, block, nb, tiles, tile_blocks,
                         sm, n_words, words, bits, sc, device, stream);
  }
  return launch<T, 0>(frames, F, n, stride, block, nb, tiles, tile_blocks,
                      sm, n_words, words, bits, sc, device, stream);
}

}  // namespace
}  // namespace trpx

// Encodes F frames of n values each (row stride `stride` >= nb * block
// elements, zero past n; element size `itemsize` bytes, signed iff
// `is_signed`) in tiles of `tile_blocks` >= 32 blocks into `words`
// (F, n_words) uint32: words [0, bits / 32] of each frame hold its stream,
// zero above its last bit; the words after them are left as they were.
// Writes each frame's total bits into `bits` (F,) int32. `scratch` holds
// 2 + 4 * F * tiles + F int32, zero on entry; its last F are the frames'
// largest widths (int32). `smem_bytes` must be the dynamic shared memory
// of a CTA (ops/cuda_pack.py:pack_smem_bytes). Launches on `stream` of
// device `device` and returns the first CUDA error.
extern "C" int trpx_pack(const void* frames, int itemsize, int is_signed,
                         int F, int n, int stride, int block, int n_words,
                         int tile_blocks, int smem_bytes, void* words,
                         void* bits, void* scratch, int device,
                         void* stream) {
  const trpx::DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (F <= 0 || n <= 0 || block <= 0 || n_words < 2 || tile_blocks < 32 ||
      (itemsize != 1 && itemsize != 2 && itemsize != 4)) {
    return int(cudaErrorInvalidValue);
  }
  const int nb = (n - 1) / block + 1;
  if (int64_t(nb) * block > stride) return int(cudaErrorInvalidValue);
  const int tiles = (nb - 1) / tile_blocks + 1;
  if (int64_t(F) * tiles > (1 << 27)) return int(cudaErrorInvalidValue);
  const trpx::PackSmem sm(itemsize, 8 * itemsize + (is_signed ? 1 : 0),
                          block, tile_blocks);
  if (sm.total != smem_bytes) return int(cudaErrorInvalidValue);
  const trpx::PackScratch sc(static_cast<int*>(scratch), F * tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRPX_LAUNCH(T)                                                     \
  err = trpx::launch_block<T>(frames, F, n, stride, block, nb, tiles,      \
                              tile_blocks, sm, n_words, words, bits, sc,   \
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

// Message of a CUDA error code returned by a launch function.
extern "C" const char* trpx_cuda_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

#ifdef TRPX_CHECKED
namespace {

// Fails its one TRPX_CHECK in every thread: the checked library's proof
// that its asserts are compiled in.
__global__ void checked_selftest(int limit) {
  const int i = int(threadIdx.x);
  TRPX_CHECK(i < limit);  // trpx_checked_selftest trips this line
}

}  // namespace

// Checked build only: launches checked_selftest on device `device` and
// waits. Returns the sticky cudaErrorAssert; the process's context is
// unusable afterwards, so call it in a process of its own.
extern "C" int trpx_checked_selftest(int device) {
  const trpx::DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  checked_selftest<<<1, 1>>>(0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(cudaDeviceSynchronize());
}
#endif
