// TRPX header walk of one frame on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package walks every frame's block
// headers on the host (native/host_codec.cpp:walk_blocks_wide), and so did
// this port until a frame of millions of blocks spent most of its decode in
// that serial walk while the card waited (one 4362x4148 u32 image, 1.5 M
// blocks: ~20 ms on the host, 0.04 ms for the tiled unpack that follows).
// Its output is what the host walk hands the unpack: every block's width
// (uint8), the frame's end bit and its widest block.
//
// A header's position depends on every block before it, but the walker's
// whole state is (bit position, current width): two walkers that reach
// the same state walk alike from there on. So the stream's 8 * nbytes bits
// are cut into S subsequences of L = 2^lg_bits bits, a header belonging to
// the subsequence that holds its first bit, and (the speculative decoding
// of Weissenberger and Schmidt, "Massively Parallel Huffman Decoding on
// GPUs", ICPP 2018):
//   1. walk_mark: a subsequence (not the first) whose L bits are all ones
//      is absorbed by the kept subsequence before it. Through all-ones bits
//      every header is a repeat, and a walker of the wrong phase or width
//      never meets the right one there (the module gaps of a detector
//      image, 2^32-1 in every pixel, run for millions of bits), so such a
//      run is crossed in one step by whoever enters it instead of being
//      handed on one subsequence a round.
//   2. walk_speculate: each kept subsequence is walked from its first bit
//      at width 0 to the first header at or past its end; its exit state
//      and its header count are kept, the exit as the entry of the next
//      kept subsequence.
//   3. walk_round, Jacobi rounds, double-buffered: each kept subsequence
//      is walked again from its predecessor's exit when that differs from
//      the entry it was last walked from; a round in which no exit changed
//      proves every entry exact (after round r at least subsequences 0..r
//      are). A round returns at once when the round before changed
//      nothing; the host launches the rounds in batches and reads the
//      changes once a batch, up to a cap, so a crafted stream cannot buy S
//      launches.
//   4. walk_sums, walk_offsets, walk_emit, only once the rounds have
//      converged: an exclusive scan of the counts gives each subsequence
//      its first block's index; each walks again from its exact entry and
//      writes the widths of blocks below nb, the one holding block nb - 1
//      applies the partial tail and writes the frame's end bit, and a
//      reduction gives the widest block.
// Counts are of headers whose first bit lies inside the payload, so fewer
// than nb of them is the host walk's "ran past end"; blocks are counted as
// full ones until the emit, since the tail block moves no header before it.
//
// Each step reads a 12-bit window of the stream (two words, a funnel
// shift) in the host walker's advance table (build_adv_lut: width in bits
// 16..23, repeat flag in bit 24, header bits in 25..29), built in shared
// memory by every CTA. The advance is header bits + width * block: the
// host's pre-multiplied 16-bit advance field bounds the block at 897
// values, and the card's multiply-add is not what the chain waits on.
// Zero-width repeats are taken 32 bits at a time, as the host's zero-run
// path takes them. A step's chain of dependent instructions is the walk's
// time, so inside a part the steps run on 32-bit offsets from the part's
// first bit.
//
// Bound on the H100: the payload read once by the mark and a few times,
// from L2, by the walks, 1 byte per block written: ~3.3 us for an
// EIGER2 X 16M image (9.47 MB in, 1.51 MB out). The walks are chains of
// dependent steps, a subsequence's headers one after another, so the time
// goes to latency: a few walks of L bits each.
#include <climits>

#include "common.cuh"

namespace trpx {
namespace {

constexpr int kWalkThreads = 128;   // a subsequence a thread
constexpr int kScanThreads = 1024;  // walk_offsets: one CTA
constexpr int kMaxRounds = 32;
// the largest block: a step's advance, at most 12 + 73 * block bits, and
// the part's bits stay below 2^31 (ops/cuda_walk.py:MAX_BLOCK)
constexpr int kMaxBlock = 1 << 20;
// status words: the header count, the widest block, the end bit, then
// each round's changed exits (round r at kChanged + r; round 0 unused)
constexpr int kTotal = 0, kWmax = 1, kEnd = 2, kChanged = 4;
constexpr int kStatusWords = kChanged + kMaxRounds + 4;

using u64 = unsigned long long;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ u64 pack_state(int64_t p, int w) {
  return (u64(p) << 8) | u64(w);
}

// The host walker's advance-table entry of a 12-bit window, without the
// pre-multiplied advance (native/host_codec.cpp:build_adv_lut).
__device__ __forceinline__ uint32_t adv_entry(uint32_t bits) {
  if (bits & 1u) return (1u << 24) | (1u << 25);  // repeat: one bit
  int wf = int((bits >> 1) & 7u), w, hb;
  if (wf < 7) {
    w = wf;
    hb = 4;
  } else {
    wf += int((bits >> 4) & 3u);
    if (wf < 10) {
      w = wf;
      hb = 6;
    } else {
      w = wf + int((bits >> 6) & 63u);
      hb = 12;
    }
  }
  return (uint32_t(w) << 16) | (uint32_t(hb) << 25);
}

__device__ __forceinline__ void build_lut(uint32_t* lut) {
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) {
    lut[i] = adv_entry(uint32_t(i));
  }
}

__device__ __forceinline__ int trailing_ones(uint32_t v) {
  return v == 0xFFFFFFFFu ? 32 : __ffs(~v) - 1;
}

// What every walk shares: the stream, the absorbed flags, the geometry.
struct Stream {
  const uint32_t* words;
  const uint8_t* absorbed;
  int64_t nbits;
  int lg;       // log2 of the subsequence's bits
  int S;
  int64_t block;
#ifdef TRPX_CHECKED
  int64_t nwords;
#endif

  // the end of kept subsequence s's bits: where the next kept one starts
  __device__ __forceinline__ int64_t end(int next) const {
    return lmin(int64_t(next) << lg, nbits);
  }
};

// The 32 stream bits from bit r of the words at wp, LSB first.
__device__ __forceinline__ uint32_t window(const uint32_t* wp, uint32_t r) {
  const uint32_t i = r >> 5;
  return __funnelshift_r(__ldg(wp + i), __ldg(wp + i + 1), r);
}

// Walks headers from state (p, w), p at or past the first bit of kept
// subsequence s, while p < E; returns how many it passed and leaves (p, w)
// at the first header at or past E. Inside s's own bits the steps run on
// 32-bit offsets from its first bit (the step's chain of dependent
// instructions is the walk's time); past them, up to E, lie only absorbed
// subsequences, all ones, where every header is a repeat of width w,
// d = 1 + w * block bits apart, crossed in one step.
__device__ __forceinline__ int64_t walk_run(const Stream& st,
                                            const uint32_t* lut, int s,
                                            int64_t E, int64_t& p, int& w) {
  const int64_t base = int64_t(s) << st.lg;
  const uint32_t* wp = st.words + (base >> 5);
  const uint32_t stop =
      uint32_t(lmin(E, base + (int64_t(1) << st.lg)) - base);
  const uint32_t blk = uint32_t(st.block);
  TRPX_CHECK(p >= base && p - base < (int64_t(1) << 31));
  uint32_t r = uint32_t(p - base), n = 0;
  while (r < stop) {
    TRPX_CHECK(((base + r) >> 5) + 1 < st.nwords);
    const uint32_t v = window(wp, r);
    if (w == 0 && (v & 1u)) {  // zero-width repeats: one bit each
      const uint32_t k = min(uint32_t(trailing_ones(v)), stop - r);
      r += k;
      n += k;
      continue;
    }
    const uint32_t e = lut[v & 0xFFFu];
    if (!(e & (1u << 24))) w = int((e >> 16) & 255u);
    r += (e >> 25) + uint32_t(w) * blk;
    ++n;
  }
  p = base + r;
  int64_t cnt = n;
  if (p < E) {  // the absorbed ones after s
    const int64_t d = 1 + int64_t(w) * st.block;
    const int64_t k = (E - p + d - 1) / d;
    p += k * d;
    cnt += k;
  }
  return cnt;
}

// The first kept subsequence after s, or S: the flags are padded with
// zeros to a multiple of 16 past S, and read 16 at a time.
__device__ __forceinline__ int next_kept(const uint8_t* absorbed, int s) {
  int t = s + 1;
  while ((t & 15) && absorbed[t]) ++t;
  if (t & 15) return t;
  for (;;) {
    const uint4 q = *reinterpret_cast<const uint4*>(absorbed + t);
    if ((q.x & q.y & q.z & q.w) != 0x01010101u) break;
    t += 16;
  }
  while (absorbed[t]) ++t;
  return t;
}

// True once some launched round up to `last` changed no exit.
__device__ __forceinline__ bool converged(const u64* status, int last) {
  for (int r = 1; r <= last; ++r) {
    if (status[kChanged + r] == 0) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kWalkThreads)
walk_mark(const uint32_t* __restrict__ words, int64_t nbits, int lg, int S,
          int A, uint8_t* __restrict__ absorbed) {
  const int u = blockIdx.x * kWalkThreads + threadIdx.x;
  if (u >= A) return;
  bool ones = u > 0 && u < S && (int64_t(u + 1) << lg) <= nbits;
  if (ones) {
    // L / 128 16-byte loads; a subsequence starts on a 16-byte boundary
    const uint4* q =
        reinterpret_cast<const uint4*>(words + (int64_t(u) << (lg - 5)));
    const int nq = 1 << (lg - 7);
    for (int i = 0; i < nq && ones; ++i) {
      const uint4 x = q[i];
      ones = (x.x & x.y & x.z & x.w) == 0xFFFFFFFFu;
    }
  }
  absorbed[u] = ones ? 1 : 0;
}

__global__ void __launch_bounds__(kWalkThreads)
walk_speculate(Stream st, int* __restrict__ nxt, u64* __restrict__ used,
               u64* __restrict__ last, int64_t* __restrict__ cnt,
               u64* __restrict__ in0) {
  __shared__ uint32_t lut[4096];
  build_lut(lut);
  __syncthreads();
  const int s = blockIdx.x * kWalkThreads + threadIdx.x;
  if (s >= st.S) return;
  if (st.absorbed[s]) {
    cnt[s] = 0;
    return;
  }
  const int t = next_kept(st.absorbed, s);
  TRPX_CHECK(t > s && t <= st.S);
  nxt[s] = t;
  int64_t p = int64_t(s) << st.lg;
  int w = 0;
  used[s] = pack_state(p, 0);
  cnt[s] = walk_run(st, lut, s, st.end(t), p, w);
  const u64 x = pack_state(p, w);
  last[s] = x;
  in0[t] = x;
}

__global__ void __launch_bounds__(kWalkThreads)
walk_round(Stream st, int r, const int* __restrict__ nxt,
           u64* __restrict__ used, u64* __restrict__ last,
           int64_t* __restrict__ cnt, const u64* __restrict__ in_prev,
           u64* __restrict__ in_cur, u64* __restrict__ status) {
  if (r >= 2 && status[kChanged + r - 1] == 0) return;  // converged
  __shared__ uint32_t lut[4096];
  build_lut(lut);
  __syncthreads();
  const int s = blockIdx.x * kWalkThreads + threadIdx.x;
  if (s >= st.S || st.absorbed[s]) return;
  const int t = nxt[s];
  const u64 e = s == 0 ? 0ull : in_prev[s];
  u64 x = last[s];
  if (e != used[s]) {
    int64_t p = int64_t(e >> 8);
    int w = int(e & 255u);
    cnt[s] = walk_run(st, lut, s, st.end(t), p, w);
    used[s] = e;
    const u64 y = pack_state(p, w);
    if (y != x) {
      last[s] = y;
      x = y;
      atomicAdd(status + kChanged + r, 1ull);
    }
  }
  in_cur[t] = x;
}

__global__ void __launch_bounds__(kWalkThreads)
walk_sums(const int64_t* __restrict__ cnt, int S, int64_t* __restrict__ bsum,
          const u64* __restrict__ status, int last_round) {
  if (!converged(status, last_round)) return;
  __shared__ int64_t part[kWalkThreads / 32];
  const int s = blockIdx.x * kWalkThreads + threadIdx.x;
  int64_t v = s < S ? cnt[s] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t sum = 0;
#pragma unroll
    for (int i = 0; i < kWalkThreads / 32; ++i) sum += part[i];
    bsum[blockIdx.x] = sum;
  }
}

// In place: each CTA's sum becomes the sum of the CTAs before it; the
// total is the header count.
__global__ void __launch_bounds__(kScanThreads)
walk_offsets(int64_t* __restrict__ bsum, int G, u64* __restrict__ status,
             int last_round) {
  if (!converged(status, last_round)) return;
  __shared__ int64_t warp_tot[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < G; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int64_t v = i < G ? bsum[i] : 0;
    int64_t x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t t = warp_tot[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    if (i < G) bsum[i] = carry + (warp > 0 ? warp_tot[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_tot[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) status[kTotal] = u64(carry);
}

// Bytes [b, b + k) of out set to w, 16 at a time where aligned (out is).
__device__ __forceinline__ void fill(uint8_t* out, int64_t b, int64_t k,
                                     int w TRPX_CHECKED_ARG(int64_t nb)) {
  TRPX_CHECK(b >= 0 && k >= 0 && b + k <= nb);
  int64_t i = b;
  const int64_t e = b + k;
  for (; i < e && (i & 15); ++i) out[i] = uint8_t(w);
  const uint32_t x = 0x01010101u * uint32_t(w);
  const uint4 q = make_uint4(x, x, x, x);
  for (; i + 16 <= e; i += 16) *reinterpret_cast<uint4*>(out + i) = q;
  for (; i < e; ++i) out[i] = uint8_t(w);
}

__global__ void __launch_bounds__(kWalkThreads)
walk_emit(Stream st, const int* __restrict__ nxt,
          const u64* __restrict__ used, const int64_t* __restrict__ cnt,
          const int64_t* __restrict__ boff, int64_t nb, int64_t tail,
          u64* __restrict__ status, int last_round,
          uint8_t* __restrict__ widths) {
  if (!converged(status, last_round)) return;
  __shared__ uint32_t lut[4096];
  __shared__ int64_t warp_tot[kWalkThreads / 32];
  build_lut(lut);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWalkThreads + threadIdx.x;
  const int64_t c = s < st.S ? cnt[s] : 0;
  int64_t x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();  // also the table's
  int64_t b = boff[blockIdx.x] + x - c;
  for (int i = 0; i < warp; ++i) b += warp_tot[i];
  int wm = 0;
  if (c > 0 && b < nb && !st.absorbed[s]) {
    const u64 e = used[s];
    int w = int(e & 255u);
    const int64_t E = st.end(nxt[s]);
    // walk_run's steps, writing each width, the tail's end at nb - 1
    const int64_t base = int64_t(s) << st.lg;
    const uint32_t* wp = st.words + (base >> 5);
    const uint32_t stop =
        uint32_t(lmin(E, base + (int64_t(1) << st.lg)) - base);
    const uint32_t blk = uint32_t(st.block);
    uint32_t r = uint32_t(int64_t(e >> 8) - base);
    bool ended = false;
    while (r < stop) {
      TRPX_CHECK(((base + r) >> 5) + 1 < st.nwords);
      const uint32_t v = window(wp, r);
      if (w == 0 && (v & 1u)) {
        int64_t k = min(uint32_t(trailing_ones(v)), stop - r);
        ended = b + k >= nb;
        if (ended) k = nb - b;
        fill(widths, b, k, 0 TRPX_CHECKED_ARG(nb));
        if (ended) {
          status[kEnd] = u64(base + r + k);
          break;
        }
        b += k;
        r += uint32_t(k);
        continue;
      }
      const uint32_t en = lut[v & 0xFFFu];
      if (!(en & (1u << 24))) w = int((en >> 16) & 255u);
      const uint32_t hb = en >> 25;
      TRPX_CHECK(b < nb);
      widths[b] = uint8_t(w);
      wm = max(wm, w);
      if (b == nb - 1) {
        status[kEnd] = u64(base + r + hb + int64_t(w) * tail);
        ended = true;
        break;
      }
      r += hb + uint32_t(w) * blk;
      ++b;
    }
    const int64_t p = base + r;
    if (!ended && p < E) {  // the absorbed ones after s
      const int64_t d = 1 + int64_t(w) * st.block;
      int64_t k = (E - p + d - 1) / d;
      if (b + k >= nb) {  // block nb - 1 is among the repeats
        k = nb - b;
        status[kEnd] = u64(p + (k - 1) * d + 1 + int64_t(w) * tail);
      }
      fill(widths, b, k, w TRPX_CHECKED_ARG(nb));
      wm = max(wm, w);
    }
  }
  wm = __reduce_max_sync(0xffffffffu, wm);
  if (lane == 0 && wm > 0) atomicMax(status + kWmax, u64(wm));
}

// Bytes of each piece of the scratch, in order, each a multiple of 16.
struct Scratch {
  u64* status;
  uint8_t* absorbed;
  int* nxt;
  u64* used;
  u64* last;
  int64_t* cnt;
  u64* in0;
  u64* in1;
  int64_t* bsum;
  int64_t bytes;

  __host__ Scratch(void* base, int S, int A, int G) {
    char* p = static_cast<char*>(base);
    int64_t off = 0;
    auto take = [&](int64_t n) {
      char* q = p ? p + off : nullptr;
      off += (n + 15) / 16 * 16;
      return q;
    };
    status = reinterpret_cast<u64*>(take(8 * int64_t(kStatusWords)));
    absorbed = reinterpret_cast<uint8_t*>(take(A));
    nxt = reinterpret_cast<int*>(take(4 * int64_t(S)));
    used = reinterpret_cast<u64*>(take(8 * int64_t(S)));
    last = reinterpret_cast<u64*>(take(8 * int64_t(S)));
    cnt = reinterpret_cast<int64_t*>(take(8 * int64_t(S)));
    in0 = reinterpret_cast<u64*>(take(8 * (int64_t(S) + 1)));
    in1 = reinterpret_cast<u64*>(take(8 * (int64_t(S) + 1)));
    bsum = reinterpret_cast<int64_t*>(take(8 * int64_t(G)));
    bytes = off;
  }
};

}  // namespace
}  // namespace trpx

// Scratch bytes of trpx_walk_frame for a stream of `nbytes` bytes cut into
// subsequences of 2^lg_bits bits, or -1 for arguments it refuses.
extern "C" int64_t trpx_walk_scratch_bytes(int64_t nbytes, int lg_bits) {
  if (nbytes <= 0 || lg_bits < 7 || lg_bits > 24) return -1;
  const int64_t S64 = ((nbytes << 3) + (int64_t(1) << lg_bits) - 1) >> lg_bits;
  if (S64 > INT_MAX / 2) return -1;
  const int S = int(S64);
  const int A = (S + 15) / 16 * 16 + 16;
  const int G = (S + trpx::kWalkThreads - 1) / trpx::kWalkThreads;
  return trpx::Scratch(nullptr, S, A, G).bytes;
}

// Walks the block headers of the one frame whose `nbytes`-byte stream is
// `words` (uint32, 16-byte aligned, zero from byte nbytes on, at least
// nbytes + 8 bytes), a frame of `n` values in blocks of `block` (at most
// kMaxBlock), in subsequences of 2^lg_bits bits. With first_round == 1 it zeroes the status, marks the
// all-ones subsequences and walks each kept one from its first bit; then
// it launches rounds first_round..last_round (at most 32), and, where one
// of the rounds up to last_round changed no exit, writes the widths of
// the blocks that start inside the payload into `widths` (nb uint8,
// 16-byte aligned). `scratch` (scratch_bytes, trpx_walk_scratch_bytes)
// starts with the status, int64: [0] headers starting inside the payload,
// [1] the widest block, [2] the end bit (written when block nb - 1 starts
// inside), [4 + r] the exits round r changed. Launches on `stream` of
// device `device` and returns the first CUDA error.
extern "C" int trpx_walk_frame(const void* words, int64_t nbytes, int64_t n,
                               int block, int lg_bits, int first_round,
                               int last_round, void* scratch,
                               int64_t scratch_bytes, void* widths,
                               int device, void* stream) {
  using namespace trpx;
  const DeviceGuard guard;  // restores the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t need = trpx_walk_scratch_bytes(nbytes, lg_bits);
  if (need < 0 || need != scratch_bytes || n <= 0 || block <= 0 ||
      block > kMaxBlock ||
      first_round < 1 || last_round < first_round ||
      last_round > kMaxRounds || (reinterpret_cast<uintptr_t>(widths) & 15) ||
      (reinterpret_cast<uintptr_t>(words) & 15) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15)) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t nbits = nbytes << 3;
  const int S = int((nbits + (int64_t(1) << lg_bits) - 1) >> lg_bits);
  const int A = (S + 15) / 16 * 16 + 16;
  const int G = (S + kWalkThreads - 1) / kWalkThreads;
  const int64_t nb = (n - 1) / block + 1;
  const int64_t tail = n - (nb - 1) * block;
  Scratch sc(scratch, S, A, G);
  Stream st{static_cast<const uint32_t*>(words), sc.absorbed, nbits,
            lg_bits, S, block
#ifdef TRPX_CHECKED
            , (nbytes + 8 + 3) / 4
#endif
  };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (first_round == 1) {
    err = cudaMemsetAsync(sc.status, 0, 8 * kStatusWords, s);
    if (err != cudaSuccess) return int(err);
    walk_mark<<<(A + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0, s>>>(
        st.words, nbits, lg_bits, S, A, sc.absorbed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    walk_speculate<<<G, kWalkThreads, 0, s>>>(st, sc.nxt, sc.used, sc.last,
                                              sc.cnt, sc.in0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  for (int r = first_round; r <= last_round; ++r) {
    const u64* in_prev = (r & 1) ? sc.in0 : sc.in1;
    u64* in_cur = (r & 1) ? sc.in1 : sc.in0;
    walk_round<<<G, kWalkThreads, 0, s>>>(st, r, sc.nxt, sc.used, sc.last,
                                          sc.cnt, in_prev, in_cur, sc.status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  walk_sums<<<G, kWalkThreads, 0, s>>>(sc.cnt, S, sc.bsum, sc.status,
                                       last_round);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  walk_offsets<<<1, kScanThreads, 0, s>>>(sc.bsum, G, sc.status, last_round);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  walk_emit<<<G, kWalkThreads, 0, s>>>(st, sc.nxt, sc.used, sc.cnt, sc.bsum,
                                       nb, tail, sc.status, last_round,
                                       static_cast<uint8_t*>(widths));
  return int(cudaGetLastError());
}

// Copies a frame's `nbytes`-byte stream from host memory (pageable) into
// the device buffer `dst` of `dst_bytes` bytes and zeroes the rest, on
// `stream` of device `device`; returns the first CUDA error.
extern "C" int trpx_walk_upload(void* dst, const void* src, int64_t nbytes,
                                int64_t dst_bytes, int device, void* stream) {
  const trpx::DeviceGuard guard;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (nbytes < 0 || dst_bytes < nbytes) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dst);
  if (nbytes > 0) {
    err = cudaMemcpyAsync(d, src, size_t(nbytes), cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaMemsetAsync(d + nbytes, 0, size_t(dst_bytes - nbytes), s));
}
