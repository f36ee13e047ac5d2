// TRPX host runtime: C++ implementation of the serial/host side of the codec.
//
// From-scratch implementation of the TRPX bitstream semantics (reference:
// Terse.hpp:500-549 encode, :352-389 decode, Bit_pointer.hpp:597-792 field
// extraction; see SURVEY.md §2.1) — NOT a copy of the reference: one flat
// LSB-first word-carry writer/reader instead of the Bit_pointer abstraction,
// absolute frame offsets (fixing reference bugs B1/B2), and correct 64-bit
// magnitude handling (fixing B6).
//
// Exposed C ABI (driven from Python via ctypes, native/__init__.py):
//   trpx_walk          — header walk: per-block width & payload bit offsets
//                        + per-frame byte starts for a whole archive
//   trpx_encode_frames — bit-identical encoder, any width <= 65
//   trpx_decode_frames — decoder with reference extraction semantics
//                        (sign-extension into signed targets, clamping)
//
// Build: g++ -O3 -std=c++20 -shared -fPIC (no external dependencies).

#include <array>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <algorithm>
#include <vector>


namespace {

// ----------------------------------------------------------- bit writer ---

// LSB-first bit appender over a caller-provided byte buffer.
struct BitWriter {
    uint8_t* buf;
    uint64_t pos;  // next free bit index

    // append the low `nbits` (<= 57 safe via memcpy-64 path) of v
    inline void put(uint64_t v, int nbits) {
        if (nbits <= 0) return;
        uint64_t byte = pos >> 3;
        int shift = pos & 7;
        // assemble into a 128-bit window so any nbits <= 64 + shift fits
        unsigned __int128 window;
        std::memcpy(&window, buf + byte, 16);
        unsigned __int128 field = (unsigned __int128)(v & ((nbits >= 64)
            ? ~0ULL : ((1ULL << nbits) - 1)));
        window |= field << shift;
        std::memcpy(buf + byte, &window, 16);
        pos += nbits;
    }

    // append a field that can be up to 65 bits (value + explicit sign bit)
    inline void put_wide(uint64_t lo, int nbits, int sign_bit) {
        if (nbits <= 64) {
            put(lo, nbits);
        } else {
            put(lo, 64);
            put((uint64_t)sign_bit, nbits - 64);
        }
    }
};

// Sequential LSB-first writer with a carry buffer: one 8-byte store per
// flush instead of BitWriter's 16-byte load+OR+store per field. Valid
// for strictly append-only use (each frame encodes front to back) into
// a buffer with >= 8 bytes of slack past the logical end; the caller
// zero-fills the buffer's tail byte (the scratch is zero-initialized).
struct SeqWriter {
    uint8_t* p;        // next flush position (byte-aligned)
    uint64_t acc = 0;  // pending bits, LSB-first
    int n = 0;         // pending bit count (< 8 after flush)

    inline void flush() {
        // store the full 8-byte window, advance by the complete bytes
        std::memcpy(p, &acc, 8);
        int adv = n >> 3;
        p += adv;
        // n can be exactly 64 (a put that filled acc to the brim);
        // acc >>= 64 would be UB (x86: no-op), leaving stale bits
        acc = (adv >= 8) ? 0 : (acc >> (adv * 8));
        n &= 7;
    }
    // append the low nbits (<= 56) of v
    inline void put(uint64_t v, int nbits) {
        if (n + nbits > 64) flush();  // leaves n <= 7, so n+nbits <= 63
        acc |= (v & ((1ULL << nbits) - 1)) << n;
        n += nbits;
    }
    // append up to 65 bits (value + explicit sign bit)
    inline void put_wide(uint64_t lo, int nbits, int sign_bit) {
        if (nbits <= 56) { put(lo, nbits); return; }
        put(lo & 0xFFFFFFFFULL, 32);
        if (nbits <= 64) {
            put(lo >> 32, nbits - 32);
        } else {
            put(lo >> 32, 32);
            put((uint64_t)sign_bit, nbits - 64);
        }
    }
    inline void finish() { flush(); if (n) *p = (uint8_t)acc; }
};

// ----------------------------------------------------------- bit reader ---

// NOTE: both reader and writer use unconditional 16-byte window memcpys;
// callers (the ctypes wrapper) must provide buffers with >= 16 bytes of
// accessible slack beyond the logical length.
struct BitReader {
    const uint8_t* buf;
    uint64_t len;  // logical bytes (slack excluded)
    uint64_t pos;  // bit index

    inline uint64_t get(int nbits) {
        if (nbits <= 0) return 0;
        uint64_t byte = pos >> 3;
        int shift = pos & 7;
        unsigned __int128 window;
        std::memcpy(&window, buf + byte, 16);
        pos += nbits;
        uint64_t mask = (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
        return (uint64_t)(window >> shift) & mask;
    }
};

inline int highest_set_bit(uint64_t v) {
    return v ? 64 - __builtin_clzll(v) : 0;
}

// Parse one block header (Terse.hpp:359-372 state machine) from a
// pre-shifted bit window; returns bits consumed (1/4/6/12).
static inline int parse_header(uint64_t bits, int& width) {
    if (bits & 1) return 1;                   // repeat header
    int wf = (int)((bits >> 1) & 7);
    if (wf < 7) { width = wf; return 4; }
    wf += (int)((bits >> 4) & 3);
    if (wf < 10) { width = wf; return 6; }
    width = wf + (int)((bits >> 6) & 63);
    return 12;
}

// A header is at most 12 bits, so its next 12 bits fully determine it:
// precompute every header form into a 4096-entry table (8 KiB, L1-hot).
// Entry packing: bits 0..5 = header length, 6..13 = explicit width,
// bit 14 = repeat flag (length 1, width stays).
inline constexpr std::array<uint16_t, 4096> kHeaderLut = [] {
    std::array<uint16_t, 4096> lut{};
    for (uint32_t bits = 0; bits < 4096; ++bits) {
        if (bits & 1) { lut[bits] = 1 | (1u << 14); continue; }
        int wf = (int)((bits >> 1) & 7), hb, width;
        if (wf < 7) { width = wf; hb = 4; }
        else {
            wf += (int)((bits >> 4) & 3);
            if (wf < 10) { width = wf; hb = 6; }
            else { width = wf + (int)((bits >> 6) & 63); hb = 12; }
        }
        lut[bits] = (uint16_t)(hb | (width << 6));
    }
    return lut;
}();

// Advance LUT for the branchless wide-stream walk (see walk_blocks_wide):
// one u32 per 12-bit header window, derived from kHeaderLut for a FIXED
// block size so the per-block bit advance needs no multiply on the
// serial chain. Packing: bits 0..15 = full advance of an explicit
// header with a full block (hb + width*block), 16..23 = explicit width,
// 24 = repeat flag, 25..29 = header bits (1 for repeats).
static void build_adv_lut(uint32_t* adv, int64_t block) {
    for (uint32_t bits = 0; bits < 4096; ++bits) {
        uint16_t e = kHeaderLut[bits];
        if (e & (1u << 14)) {
            adv[bits] = 1u | (1u << 24) | (1u << 25);
            continue;
        }
        uint32_t hb = e & 63u, w = (e >> 6) & 255u;
        uint32_t a = hb + w * (uint32_t)block;
        adv[bits] = (a & 0xFFFFu) | (w << 16) | (hb << 25);
    }
}

// Walk the block headers of one frame. Two fast paths over a scalar
// LUT loop (all three measured against real diffraction streams — see
// tools/walk_bench.py; the per-block branchy/cached-window variants of
// rounds 1-2 lose to this on every profile):
//  * zero-width runs: repeat headers are 1 bit and carry no payload, so
//    one 8-byte load covers a run of up to ~56 via ctz of the inverted
//    window (sparse/dark frames walk at several hundred Mblk/s);
//  * everything else: one fresh unaligned 8-byte load per block + the
//    12-bit header LUT. The repeat/explicit branch predicts well on
//    diffraction data (widths come in runs), and during a run the next
//    load's address resolves one add after the previous — loads stay
//    pipelined instead of serializing on a cached-window refill test.
// Returns false if the walk ran past the payload.
inline bool walk_blocks(const uint8_t* buf, uint64_t payload_len,
                        uint64_t& pos, int& width, int& wmax,
                        int64_t nblocks, int64_t nvalues, int64_t block,
                        int32_t* widths, int64_t* poffs) {
    const int64_t last = nblocks - 1;
    const uint64_t tail = (uint64_t)(nvalues - last * block);
    const uint64_t blk = (uint64_t)block;
    int64_t b = 0;
    while (b < nblocks) {
        // one bounds check per block: loads past the logical end are
        // safe (callers guarantee >= 16 bytes of slack), and a runaway
        // walk advances `base` every iteration, so it is caught here
        uint64_t base = pos >> 3;
        if (base >= payload_len) return false;
        if (width == 0) {
            // zero-width repeats: 1 bit each, no payload for ANY count
            // (the last block's partial tail included)
            uint64_t w64;
            std::memcpy(&w64, buf + base, 8);
            uint64_t off = pos & 7;
            uint64_t inv = ~(w64 >> off);
            int m = inv ? __builtin_ctzll(inv) : (int)(64 - off);
            if (m > (int)(56 - off)) m = (int)(56 - off);
            if (m > nblocks - b) m = (int)(nblocks - b);
            if (m > 0) {
                for (int k = 0; k < m; ++k) {
                    widths[b + k] = 0;
                    if (poffs) poffs[b + k] = (int64_t)(pos + k + 1);
                }
                pos += (uint64_t)m;
                b += m;
                continue;
            }
        }
        uint64_t w64;
        std::memcpy(&w64, buf + base, 8);
        uint16_t e = kHeaderLut[(w64 >> (pos & 7)) & 0xFFF];
        uint64_t cnt = (b == last) ? tail : blk;
        if (e & (1u << 14)) {  // repeat header
            widths[b] = width;
            if (poffs) poffs[b] = (int64_t)(pos + 1);
            pos += 1 + (uint64_t)width * cnt;
        } else {
            int hb = e & 63;
            width = (int)((e >> 6) & 255);
            if (width > wmax) wmax = width;
            widths[b] = width;
            if (poffs) poffs[b] = (int64_t)(pos + (uint64_t)hb);
            pos += (uint64_t)hb + (uint64_t)width * cnt;
        }
        ++b;
    }
    return true;
}

// Branchless walk for WIDE streams (overflow-heavy u32 archives: widths
// jump block to block, so walk_blocks' repeat/explicit branch
// mispredicts ~every run boundary — measured 52 Mblk/s at 2048² u32 vs
// 141 at u16, VERDICT r3 weak #1). Differences:
//  * the repeat/explicit split is compiled to cmovs — no speculation,
//    no mispredict flushes on unpredictable width sequences;
//  * the per-block advance comes from the pre-multiplied LUT
//    (build_adv_lut), so the serial pos chain is load → LUT load →
//    cmov → add, with no imul: ~2.5x the wide-stream walk rate.
// The zero-run fast path is kept (dark regions exist in wide streams
// too; its gate is a well-predicted width==0 test). Callers select this
// variant via the `wide` flag (prolix_bits > 16) — on narrow streams
// with run-structured widths the BRANCHY loop stays faster (the
// predictor runs ahead of the LUT load; measured round 3).
inline bool walk_blocks_wide(const uint8_t* buf, uint64_t payload_len,
                             uint64_t& pos, int& width, int& wmax,
                             int64_t nblocks, int64_t nvalues,
                             int64_t block, const uint32_t* adv,
                             int32_t* widths, int64_t* poffs) {
    const int64_t last = nblocks - 1;
    const int64_t tail = nvalues - last * block;
    int64_t wblk = (int64_t)width * block;
    int64_t b = 0;
    while (b < nblocks) {
        uint64_t base = pos >> 3;
        if (base >= payload_len) return false;
        if (width == 0) {
            uint64_t w64;
            std::memcpy(&w64, buf + base, 8);
            uint64_t off = pos & 7;
            uint64_t inv = ~(w64 >> off);
            int m = inv ? __builtin_ctzll(inv) : (int)(64 - off);
            if (m > (int)(56 - off)) m = (int)(56 - off);
            if (m > nblocks - b) m = (int)(nblocks - b);
            if (m > 0) {
                for (int k = 0; k < m; ++k) {
                    widths[b + k] = 0;
                    if (poffs) poffs[b + k] = (int64_t)(pos + k + 1);
                }
                pos += (uint64_t)m;
                b += m;
                continue;
            }
        }
        uint64_t w64;
        std::memcpy(&w64, buf + base, 8);
        uint32_t e = adv[(w64 >> (pos & 7)) & 0xFFF];
        int rep = (int)(e >> 24) & 1;
        int hb = (int)(e >> 25) & 31;
        int wexp = (int)(e >> 16) & 255;
        int64_t a_exp = (int64_t)(e & 0xFFFF);
        width = rep ? width : wexp;                    // cmov
        wblk = rep ? wblk : (a_exp - hb);              // cmov
        int64_t advance = rep ? (1 + wblk) : a_exp;    // cmov
        wmax = width > wmax ? width : wmax;
        widths[b] = width;
        if (poffs) poffs[b] = (int64_t)pos + hb;
        if (b == last)  // partial tail block: taken exactly once
            advance = hb + (int64_t)width * tail;
        pos += (uint64_t)advance;
        ++b;
    }
    return true;
}

// Minimum per-call work (in rough bytes touched) before an OpenMP
// parallel region pays for itself. Region entry/exit is not free — on a
// contended 4-vCPU host a single fork/join measured ~1-7 ms, turning a
// 0.5 ms single-frame encode into 14 ms (the many-small-files CLI
// case). Below this, `if()` collapses the region to the calling thread;
// above it (streaming chunks, whole-archive walks) the fork cost is
// noise.
static const int64_t kOmpMinBytes = 4 << 20;

}  // namespace

extern "C" {

// Walk the block headers of `nframes` frames (Terse.hpp:359-372 state
// machine). Outputs, all caller-allocated:
//   widths   [nframes * nblocks] int32  — payload field width per block
//   poffs    [nframes * nblocks] int64  — ABSOLUTE payload bit offset
//   fstarts  [nframes + 1]       int64  — byte offset of each frame
//                                          (+ end of last frame)
// Returns the maximum block width seen (>= 0) — callers compare it
// against the header's prolix_bits to reject corrupt streams (the
// encoder guarantees prolix_bits == max width, Terse.hpp:516) — or -1
// if the walk ran past the payload.
// `wide` != 0 selects the branchless cmov walk (walk_blocks_wide) —
// callers pass prolix_bits > 16 (overflow-heavy u32 archives, where the
// repeat/explicit branch mispredicts); 0 keeps the branchy loop that
// wins on run-structured narrow streams.
int trpx_walk(const uint8_t* payload, int64_t payload_len,
              int64_t nframes, int64_t nvalues, int64_t block,
              int32_t* widths, int64_t* poffs, int64_t* fstarts,
              int wide) {
    int64_t nblocks = (nvalues + block - 1) / block;
    int64_t start_byte = 0;
    int wmax = 0;
    uint32_t adv[4096];
    bool use_wide = wide && (12 + 73 * block <= 0xFFFF);
    if (use_wide) build_adv_lut(adv, block);
    for (int64_t f = 0; f < nframes; ++f) {
        fstarts[f] = start_byte;
        uint64_t pos = (uint64_t)start_byte * 8;
        int width = 0;  // persists across blocks within a frame
        bool ok = use_wide
            ? walk_blocks_wide(payload, (uint64_t)payload_len, pos, width,
                               wmax, nblocks, nvalues, block, adv,
                               widths + f * nblocks,
                               poffs ? poffs + f * nblocks : nullptr)
            : walk_blocks(payload, (uint64_t)payload_len, pos, width, wmax,
                          nblocks, nvalues, block,
                          widths + f * nblocks,
                          poffs ? poffs + f * nblocks : nullptr);
        if (!ok) return -1;
        // next frame: byte after the terminal byte (Terse.hpp:547)
        start_byte += 1 + (int64_t)((pos - (uint64_t)start_byte * 8) >> 3);
        if (start_byte > payload_len) return -1;
    }
    fstarts[nframes] = start_byte;
    return wmax;
}

// Scatter per-frame payload chunks into fixed-stride rows (the decode
// kernels' per-frame word buffers), zeroing each row's tail. Parallel
// memcpy (OpenMP) — replaces a Python per-frame copy loop that cost as
// much as the walk itself. starts/ends: absolute byte ranges per frame.
void trpx_gather_frames(const uint8_t* payload, const int64_t* starts,
                        const int64_t* ends, int64_t nframes,
                        uint8_t* out, int64_t row_bytes) {
#pragma omp parallel for schedule(static) \
    if(nframes * row_bytes >= kOmpMinBytes)
    for (int64_t f = 0; f < nframes; ++f) {
        int64_t len = ends[f] - starts[f];
        if (len > row_bytes) len = row_bytes;
        if (len < 0) len = 0;
        uint8_t* row = out + f * row_bytes;
        std::memcpy(row, payload + starts[f], (size_t)len);
        std::memset(row + len, 0, (size_t)(row_bytes - len));
    }
}

// Walk frames whose byte offsets are ALREADY KNOWN (from a sidecar index
// or a previous walk): each frame's header walk is then independent and
// runs in parallel (OpenMP). fstarts: [nframes] absolute byte offsets.
// Returns the maximum block width seen (>= 0, see trpx_walk), or -1 if
// any frame's walk ran past its end.
int trpx_walk_indexed(const uint8_t* payload, int64_t payload_len,
                      int64_t nframes, int64_t nvalues, int64_t block,
                      const int64_t* fstarts,
                      int32_t* widths, int64_t* poffs, int wide) {
    int64_t nblocks = (nvalues + block - 1) / block;
    int bad = 0;
    int wmax = 0;
    uint32_t adv[4096];
    bool use_wide = wide && (12 + 73 * block <= 0xFFFF);
    if (use_wide) build_adv_lut(adv, block);
#pragma omp parallel for schedule(static) reduction(|:bad) \
    reduction(max:wmax) if(nframes * nblocks * 8 >= kOmpMinBytes)
    for (int64_t f = 0; f < nframes; ++f) {
        if (fstarts[f] < 0 || fstarts[f] >= payload_len) { bad |= 1; continue; }
        uint64_t pos = (uint64_t)fstarts[f] * 8;
        int width = 0;
        bool ok = use_wide
            ? walk_blocks_wide(payload, (uint64_t)payload_len, pos, width,
                               wmax, nblocks, nvalues, block, adv,
                               widths + f * nblocks,
                               poffs ? poffs + f * nblocks : nullptr)
            : walk_blocks(payload, (uint64_t)payload_len, pos, width, wmax,
                          nblocks, nvalues, block,
                          widths + f * nblocks,
                          poffs ? poffs + f * nblocks : nullptr);
        if (!ok) {
            bad |= 1;
        } else {
            // the serial walk rejects frames whose fields run past the
            // payload (start_byte > payload_len); hostile sidecars must
            // not bypass that here — a single huge-width header can
            // otherwise claim megabytes past the buffer (OOB reads in
            // the decode loads)
            int64_t end_byte = fstarts[f]
                + 1 + (int64_t)((pos - (uint64_t)fstarts[f] * 8) >> 3);
            if (end_byte > payload_len) bad |= 1;
        }
    }
    return bad ? -1 : wmax;
}

// Encode `nframes` frames of `nvalues` values of the CALLER's dtype
// (`itemsize` in {1,2,4,8} bytes, `is_signed` 0/1). Bit-identical to the
// reference encoder (Terse.hpp:500-549) with B5/B6 corrected.
//
//   values   [nframes * nvalues] native-endian elements
//   out      caller buffer; worst case per frame:
//            (max_width*nvalues + 12*nblocks)/8 + 2 bytes
//   fstarts  [nframes + 1] int64 — byte offset of each frame in `out`
// Returns total bytes written (>= 0), or -1 on unencodable width /
// insufficient out_cap.
namespace {

// Magnitude OR of one block -> field width (Terse.hpp:510-511,553).
// Templated on the SOURCE dtype: processing u16 pixels directly (instead
// of an int64-widened host copy) quarters the scan traffic of both
// passes and removes the widening copy entirely.
extern "C++" {
template <typename T>
inline int frame_block_width(const T* frame, int64_t lo, int64_t hi,
                             int is_signed) {
    uint64_t setbits = 0;
    if (is_signed) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t v = (int64_t)frame[i];
            setbits |= (v < 0 ? -(uint64_t)v : (uint64_t)v);
        }
    } else {
        using U = std::make_unsigned_t<T>;
        for (int64_t i = lo; i < hi; ++i)
            setbits |= (uint64_t)(U)frame[i];
    }
    int width = highest_set_bit(setbits);
    if (is_signed && width) width += 1;  // sign bit
    return width;
}

// Two-pass PARALLEL encoder: frame streams are byte-aligned (the
// 1 + bits/8 terminal-byte rule, Terse.hpp:547), so once a cheap
// parallel size pass fixes every frame's byte range, each frame encodes
// independently (OpenMP) into a private scratch and memcpys its exact
// bytes — the 16-byte writer windows would otherwise race on the shared
// buffer at frame boundaries. Pass 1 caches every block width so pass 2
// does not re-scan the pixels for the OR-reduce.
template <typename T>
int64_t encode_frames_impl(const T* values, int64_t nframes,
                           int64_t nvalues, int64_t block, int is_signed,
                           uint8_t* out, int64_t out_cap,
                           int64_t* fstarts, int32_t* prolix_bits_out) {
    int64_t nblocks = (nvalues + block - 1) / block;
    std::vector<int64_t> fbits((size_t)nframes);
    std::vector<int8_t> wtab((size_t)(nframes * nblocks));
    int prolix = 0;
    int bad = 0;
    // pass 1: per-frame bit sizes + widths + prolix (no stream writes)
#pragma omp parallel for schedule(static) \
    reduction(max:prolix) reduction(|:bad) \
    if(nframes * nvalues * (int64_t)sizeof(T) >= kOmpMinBytes)
    for (int64_t f = 0; f < nframes; ++f) {
        const T* frame = values + f * nvalues;
        int8_t* wrow = wtab.data() + f * nblocks;
        int prev = 0;  // reset per frame (Terse.hpp:505)
        int64_t bits = 0;
        for (int64_t b = 0; b < nblocks; ++b) {
            int64_t lo = b * block;
            int64_t hi = std::min(nvalues, lo + block);
            int width = frame_block_width(frame, lo, hi, is_signed);
            if (width > 73) { bad = 1; break; }
            wrow[b] = (int8_t)width;
            prolix = std::max(prolix, width);
            if (width == prev) {
                bits += 1;
            } else {
                bits += (width < 7) ? 4 : (width < 10) ? 6 : 12;
                prev = width;
            }
            bits += (int64_t)width * (hi - lo);
        }
        fbits[(size_t)f] = bits;
    }
    if (bad) return -1;
    int64_t start_byte = 0;
    for (int64_t f = 0; f < nframes; ++f) {
        fstarts[f] = start_byte;
        start_byte += 1 + (fbits[(size_t)f] >> 3);  // Terse.hpp:547
    }
    fstarts[nframes] = start_byte;
    if (start_byte > out_cap - 16) return -1;
    // pass 2: encode every frame independently at its known offset.
    // No global memset of `out`: the per-frame scratches are
    // zero-initialized and the fstarts ranges partition [0, start_byte)
    // exactly, so every returned byte is written by exactly one memcpy.
#pragma omp parallel for schedule(static) \
    if(nframes * nvalues * (int64_t)sizeof(T) >= kOmpMinBytes)
    for (int64_t f = 0; f < nframes; ++f) {
        int64_t len = fstarts[f + 1] - fstarts[f];
        std::vector<uint8_t> scratch((size_t)len + 32, 0);
        SeqWriter w{scratch.data()};
        const T* frame = values + f * nvalues;
        const int8_t* wrow = wtab.data() + f * nblocks;
        int prev = 0;
        for (int64_t b = 0; b < nblocks; ++b) {
            int64_t lo = b * block;
            int64_t hi = std::min(nvalues, lo + block);
            int width = wrow[b];
            // block header (Terse.hpp:517-535)
            if (width == prev) {
                w.put(1, 1);
            } else {
                if (width < 7)       w.put((uint64_t)width << 1, 4);
                else if (width < 10) w.put((uint64_t)(0b111 | ((width - 7) << 3)) << 1, 6);
                else                 w.put((uint64_t)(0b11111 | ((width - 10) << 5)) << 1, 12);
                prev = width;
            }
            if (width) {
                if (is_signed) {
                    for (int64_t i = lo; i < hi; ++i) {
                        int64_t v = (int64_t)frame[i];
                        w.put_wide((uint64_t)v, width, v < 0 ? 1 : 0);
                    }
                } else if (width <= 56) {
                    using U = std::make_unsigned_t<T>;
                    for (int64_t i = lo; i < hi; ++i)
                        w.put((uint64_t)(U)frame[i], width);
                } else {
                    using U = std::make_unsigned_t<T>;
                    for (int64_t i = lo; i < hi; ++i)
                        w.put_wide((uint64_t)(U)frame[i], width, 0);
                }
            }
        }
        w.finish();
        std::memcpy(out + fstarts[f], scratch.data(), (size_t)len);
    }
    *prolix_bits_out = prolix;
    return start_byte;
}

}  // extern "C++"
}  // namespace

int64_t trpx_encode_frames(const void* values, int itemsize, int is_signed,
                           int64_t nframes, int64_t nvalues, int64_t block,
                           uint8_t* out, int64_t out_cap,
                           int64_t* fstarts, int32_t* prolix_bits_out) {
#define TRPX_ENC(T, SGN) encode_frames_impl((const T*)values, nframes, \
    nvalues, block, SGN, out, out_cap, fstarts, prolix_bits_out)
    switch (itemsize) {
    case 1: return is_signed ? TRPX_ENC(int8_t, 1)  : TRPX_ENC(uint8_t, 0);
    case 2: return is_signed ? TRPX_ENC(int16_t, 1) : TRPX_ENC(uint16_t, 0);
    case 4: return is_signed ? TRPX_ENC(int32_t, 1) : TRPX_ENC(uint32_t, 0);
    case 8: return is_signed ? TRPX_ENC(int64_t, 1) : TRPX_ENC(uint64_t, 0);
    }
#undef TRPX_ENC
    return -1;
}


// Decode all frames into the caller's OUTPUT dtype (out_itemsize in
// {1,2,4,8}; 8 also serves float targets via int64/uint64 bit patterns),
// given the walk tables. Writing the target width directly (instead of
// an int64 buffer narrowed host-side) quarters the store traffic for
// u16 pixels. Extraction semantics per Bit_pointer.hpp:597-617,742-792:
//   * target_signed: sign-extend any field whose top bit is set (B4)
//   * clamp to [clamp_min, clamp_max] when the field width exceeds
//     target_bits (clamping disabled when target_bits >= 64); narrower
//     stores otherwise truncate to the output's low bits, matching
//     get_range's raw-pattern write
extern "C++" {
namespace {

template <typename OUT>
int decode_frames_impl(const uint8_t* payload, int64_t payload_len,
                       int64_t nframes, int64_t nvalues, int64_t block,
                       const int32_t* widths, const int64_t* poffs,
                       int target_signed, int target_bits,
                       int64_t clamp_min, int64_t clamp_max,
                       OUT* out) {
    int64_t nblocks = (nvalues + block - 1) / block;
    // frames decode independently: poffs are absolute, each thread
    // carries its own reader
#pragma omp parallel for schedule(static) \
    if(nframes * nvalues * (int64_t)sizeof(OUT) >= kOmpMinBytes)
    for (int64_t f = 0; f < nframes; ++f) {
        BitReader r{payload, (uint64_t)payload_len, 0};
        OUT* dst = out + f * nvalues;
        for (int64_t b = 0; b < nblocks; ++b) {
            int64_t idx = f * nblocks + b;
            int width = widths[idx];
            int64_t lo = b * block;
            int64_t hi = std::min(nvalues, lo + block);
            if (width == 0) {
                std::memset(dst + lo, 0, (size_t)(hi - lo) * sizeof(OUT));
                continue;
            }
            // fast path: width + max bit phase fits one 8-byte load and
            // no clamping can fire — one unaligned u64 load per value
            // (the general path's 16-byte reader window memcpy is ~2x
            // the traffic) with branchless sign extension
            if (width <= 57 && !(target_bits < 64 && width > target_bits)) {
                uint64_t pos = (uint64_t)poffs[idx];
                const uint64_t mask = (1ULL << width) - 1;
                const int sext = 64 - width;
                if (target_signed) {
                    for (int64_t i = lo; i < hi; ++i) {
                        uint64_t w64;
                        std::memcpy(&w64, payload + (pos >> 3), 8);
                        uint64_t u = (w64 >> (pos & 7)) & mask;
                        pos += (uint64_t)width;
                        dst[i] = (OUT)(((int64_t)(u << sext)) >> sext);
                    }
                } else {
                    for (int64_t i = lo; i < hi; ++i) {
                        uint64_t w64;
                        std::memcpy(&w64, payload + (pos >> 3), 8);
                        uint64_t u = (w64 >> (pos & 7)) & mask;
                        pos += (uint64_t)width;
                        dst[i] = (OUT)u;
                    }
                }
                continue;
            }
            r.pos = (uint64_t)poffs[idx];
            for (int64_t i = lo; i < hi; ++i) {
                int w64 = width > 64 ? 64 : width;
                uint64_t u = r.get(w64);
                int sign_bit;
                if (width > 64) {
                    sign_bit = (int)r.get(width - 64);
                } else {
                    sign_bit = (int)((u >> (width - 1)) & 1);
                }
                int64_t v;
                if (target_signed && sign_bit) {
                    // w-bit two's complement (width >= 65: low 64 bits are
                    // already the exact int64 pattern)
                    v = (width >= 64) ? (int64_t)u
                        : (int64_t)(u | (~0ULL << width));
                } else {
                    v = (int64_t)u;
                }
                if (target_bits < 64 && width > target_bits) {
                    if (target_signed || width < 64) {
                        v = std::min(std::max(v, clamp_min), clamp_max);
                    } else {
                        // unsigned 64-bit compare for u64 targets
                        uint64_t uv = (uint64_t)v;
                        uint64_t umax = (uint64_t)clamp_max;
                        v = (int64_t)(uv > umax ? umax : uv);
                    }
                }
                dst[i] = (OUT)v;
            }
        }
    }
    return 0;
}

}  // namespace
}  // extern "C++"

// Decode prepass tables for the tiled big-frame route: per-tile total
// bit lengths plus per-level maxima of the pairwise-sum trees, computed
// straight from the walk's width tables (the per-block bit length is
// fully determined by the header repeat chain + width*count,
// Terse.hpp:517-535 / SURVEY §2.1 — same rule as the Python
// block_bits_host). Replaces a host-numpy pipeline whose int64
// temporaries cost ~2 s per 32-frame 2048² batch on a contended host.
//
//   widths    [F * nb]   int32 — header-walk output
//   tile_bits [F * T]    int64 — total bits per tile, T = ceil(nb/Tb)
//   level_max [log2(Tb)] int64 — level i = the largest aligned node of
//             2^(i+1) blocks in any (frame, tile) subtree
//
// Tb must be a power of two (the kernels' grid); blocks at index >= nb
// (grid padding) contribute 0 bits. Returns 0, or -1 on bad arguments.
int trpx_tile_prepass(const int32_t* widths, int64_t F, int64_t nb,
                      int64_t nvalues, int64_t block, int64_t Tb,
                      int64_t* tile_bits, int64_t* level_max) {
    if (F < 0 || nb <= 0 || Tb <= 0 || (Tb & (Tb - 1)) || block <= 0)
        return -1;
    int64_t T = (nb + Tb - 1) / Tb;
    int levels = 0;
    while ((int64_t(1) << (levels + 1)) <= Tb) ++levels;
    for (int i = 0; i < levels; ++i) level_max[i] = 0;
#pragma omp parallel if(F * T * Tb * 16 >= kOmpMinBytes)
    {
        // per-thread node buffer + level maxima; merged once at the end
        std::vector<int64_t> buf((size_t)Tb);
        std::vector<int64_t> lmax((size_t)levels, 0);
#pragma omp for schedule(static) collapse(2)
        for (int64_t f = 0; f < F; ++f) {
            for (int64_t t = 0; t < T; ++t) {
                const int32_t* wrow = widths + f * nb;
                const int64_t base = t * Tb;
                int64_t sum = 0;
                for (int64_t j = 0; j < Tb; ++j) {
                    int64_t idx = base + j;
                    int64_t bits = 0;
                    if (idx < nb) {
                        int64_t w = wrow[idx];
                        int64_t prev = idx ? wrow[idx - 1] : 0;
                        int64_t hb = (w == prev)
                            ? 1 : (w < 7 ? 4 : (w < 10 ? 6 : 12));
                        int64_t count = nvalues - idx * block;
                        if (count > block) count = block;
                        bits = hb + w * count;
                    }
                    buf[(size_t)j] = bits;
                    sum += bits;
                }
                tile_bits[f * T + t] = sum;
                int64_t nn = Tb;
                for (int lvl = 0; lvl < levels; ++lvl) {
                    nn >>= 1;
                    int64_t mx = lmax[(size_t)lvl];
                    for (int64_t i = 0; i < nn; ++i) {
                        int64_t s = buf[2 * i] + buf[2 * i + 1];
                        buf[(size_t)i] = s;
                        if (s > mx) mx = s;
                    }
                    lmax[(size_t)lvl] = mx;
                }
            }
        }
#pragma omp critical
        for (int i = 0; i < levels; ++i)
            if (lmax[(size_t)i] > level_max[i])
                level_max[i] = lmax[(size_t)i];
    }
    return 0;
}

int trpx_decode_frames(const uint8_t* payload, int64_t payload_len,
                       int64_t nframes, int64_t nvalues, int64_t block,
                       const int32_t* widths, const int64_t* poffs,
                       int target_signed, int target_bits,
                       int64_t clamp_min, int64_t clamp_max,
                       void* out, int out_itemsize) {
#define TRPX_DEC(T) decode_frames_impl(payload, payload_len, nframes, \
    nvalues, block, widths, poffs, target_signed, target_bits, \
    clamp_min, clamp_max, (T*)out)
    switch (out_itemsize) {
    case 1: return TRPX_DEC(uint8_t);
    case 2: return TRPX_DEC(uint16_t);
    case 4: return TRPX_DEC(uint32_t);
    case 8: return TRPX_DEC(uint64_t);
    }
#undef TRPX_DEC
    return -1;
}

}  // extern "C"
