// Per-element math of the fault-free slot window, shared by the CUDA
// kernels (fused_window.cu) and a plain host build (g++) that the CPU
// tests use to check it against the reference closed form. The
// replica-major path tallies [R, T, S] planes directly; the [T, S, R]
// path first transposes each chunk in registers (bottom of this file).
//
// For each (slot t, shard s), with Q = quorum:
//   c1 = #{r : alive[r,s] and votes[r,t,s] == V1}, c0 likewise for V0
//   dec = V1 if c1 >= Q, else V0 if c0 >= Q, else ABSENT
//   ph  = 0 if dec != ABSENT else -1          (optional phase plane)
//
// Four lanes are handled per 32-bit word (SWAR): each byte of a counter
// word counts one lane. With R <= MAX_R = 8 replicas a byte never
// exceeds 8, so no carry crosses a byte boundary in any step below.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <atomic>
#endif

#if defined(__CUDACC__)
#define RW_HD __host__ __device__ __forceinline__
#define RW_UNROLL _Pragma("unroll")
#else
#define RW_HD inline
#define RW_UNROLL
#endif

namespace rw {

constexpr uint32_t ONES = 0x01010101u;
constexpr uint32_t HIGH = 0x80808080u;
constexpr int LANES = 16;   // shards per thread: one 16-byte vector per plane
constexpr int MAX_R = 8;    // keeps every per-byte counter below 0x80
constexpr int MAX_QUORUM = 128;
constexpr uint8_t CODE_V0 = 0, CODE_V1 = 1, CODE_ABSENT = 3;

// 0x01 in each byte where a and b agree, 0x00 elsewhere (exact: no
// false positives from borrows, unlike the usual has-zero-byte trick).
RW_HD uint32_t eq_bytes(uint32_t a, uint32_t b) {
    uint32_t x = a ^ b;
    uint32_t t = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;  // bit 7 set iff low 7 bits != 0
    t = ~(t | x | 0x7F7F7F7Fu);                    // bit 7 set iff byte == 0
    return t >> 7;
}

// 0x01 in each byte whose count (<= 8) is >= q, for 1 <= q <= 128:
// c + (0x80 - q) stays below 0x100 and has bit 7 set iff c >= q.
RW_HD uint32_t ge_bytes(uint32_t c, uint32_t q) {
    return ((c + (0x80u - q) * ONES) & HIGH) >> 7;
}

// Add one replica's word of four votes into the per-byte counters.
// `alive` holds 0x00 or 0x01 per byte.
RW_HD void tally_word(uint32_t votes, uint32_t alive, uint32_t& c0, uint32_t& c1) {
    c1 += eq_bytes(votes, CODE_V1 * ONES) & alive;
    c0 += eq_bytes(votes, CODE_V0 * ONES) & alive;
}

// Decision codes for four lanes: V1 where c1 >= q, else V0 where
// c0 >= q, else ABSENT.
RW_HD uint32_t decide_word(uint32_t c0, uint32_t c1, uint32_t q) {
    uint32_t ge1 = ge_bytes(c1, q);
    uint32_t ge0 = ge_bytes(c0, q);
    return ge1 | (((ge1 | ge0) ^ ONES) * CODE_ABSENT);
}

// The phase value of lane `i` (0..3) of a decision word.
RW_HD int32_t phase_of(uint32_t dec, int i) {
    return -static_cast<int32_t>((eq_bytes(dec, CODE_ABSENT * ONES) >> (8 * i)) & 1u);
}

// Byte-wise loads and stores of up to 16 lanes; lanes >= n read `pad`.
RW_HD void load_lanes(const uint8_t* p, int n, uint32_t w[4], uint8_t pad) {
    for (int k = 0; k < 4; ++k) {
        uint32_t x = 0;
        for (int b = 0; b < 4; ++b) {
            int i = 4 * k + b;
            uint32_t byte = i < n ? p[i] : pad;
            x |= byte << (8 * b);
        }
        w[k] = x;
    }
}

RW_HD void store_dec_lanes(int8_t* p, int n, const uint32_t d[4]) {
    for (int i = 0; i < n; ++i) p[i] = static_cast<int8_t>((d[i / 4] >> (8 * (i % 4))) & 0xFFu);
}

RW_HD void store_phase_lanes(int32_t* p, int n, const uint32_t d[4]) {
    for (int i = 0; i < n; ++i) p[i] = phase_of(d[i / 4], i % 4);
}

// One chunk of n <= 16 lanes through the byte-wise path: `votes` points
// at (r=0, t, s0) of an [R, T, S] tensor whose planes are `plane` bytes
// apart, `alive` at (r=0, s0) of an [R, S] tensor. `ph` may be null.
RW_HD void window_chunk_bytes(const int8_t* votes, int64_t plane,
                              const uint8_t* alive, int64_t S, int R, int n,
                              uint32_t q, int8_t* dec, int32_t* ph) {
    uint32_t c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
    for (int r = 0; r < R; ++r) {
        uint32_t v[4], a[4];
        load_lanes(reinterpret_cast<const uint8_t*>(votes + r * plane), n, v, CODE_ABSENT);
        load_lanes(alive + r * S, n, a, 0);
        for (int k = 0; k < 4; ++k) tally_word(v[k], a[k] & ONES, c0[k], c1[k]);
    }
    uint32_t d[4];
    for (int k = 0; k < 4; ++k) d[k] = decide_word(c0[k], c1[k], q);
    store_dec_lanes(dec, n, d);
    if (ph) store_phase_lanes(ph, n, d);
}

// ---- the [T, S, R] layout, read in place ----
//
// The 16 shards of a chunk of one slot row are 16*R contiguous bytes,
// shard-major: byte s*R + r is replica r's vote on shard s0 + s. Held as
// 4*R little-endian words w[], they are transposed in registers into the
// words that tally_word takes: word (k, r) holds replica r's votes on
// shards 4k..4k+3, one a byte. The alive row [S, R] of the same 16
// shards has the same layout and goes through the same transposition.
// With R a template argument and the loops unrolled, every word index
// and permute selector below is a compile-time constant.

// __byte_perm(x, y, s): byte n of the result is byte ((s >> 4n) & 7) of
// the eight bytes y:x (x holds bytes 0-3). The host build emulates it.
RW_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(x, y, s);
#else
    const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
    uint32_t out = 0;
    for (int n = 0; n < 4; ++n) {
        const uint32_t sel = (s >> (4 * n)) & 7u;
        out |= static_cast<uint32_t>((v >> (8 * sel)) & 0xFFu) << (8 * n);
    }
    return out;
#endif
}

// Word (k, r) of the transposition: bytes 4kR + r + iR (i = 0..3) of w.
// One permute where the four bytes lie in two neighbouring words, three
// (two pairs, then the pairs joined) where they span more.
template <int R>
RW_HD uint32_t lane_word(const uint32_t* w, int k, int r) {
    const int b0 = 4 * k * R + r;
    const int lo = b0 >> 2, hi = (b0 + 3 * R) >> 2;
    if (hi - lo <= 1) {
        uint32_t sel = 0;
        RW_UNROLL
        for (int i = 0; i < 4; ++i) sel |= static_cast<uint32_t>(b0 + i * R - 4 * lo) << (4 * i);
        return byte_perm(w[lo], w[hi], sel);
    }
    const int b1 = b0 + R, b2 = b0 + 2 * R, b3 = b0 + 3 * R;
    const uint32_t p01 = byte_perm(w[b0 >> 2], w[b1 >> 2], (b0 & 3) | ((4 + (b1 & 3)) << 4));
    const uint32_t p23 = byte_perm(w[b2 >> 2], w[b3 >> 2], (b2 & 3) | ((4 + (b3 & 3)) << 4));
    return byte_perm(p01, p23, 0x5410u);  // bytes 0, 1 of p01, then bytes 0, 1 of p23
}

// The alive words of a chunk, transposed and reduced to 0x00/0x01 bytes.
template <int R>
RW_HD void transpose_alive(const uint32_t* a, uint32_t at[4][R]) {
    RW_UNROLL
    for (int k = 0; k < 4; ++k) {
        RW_UNROLL
        for (int r = 0; r < R; ++r) at[k][r] = lane_word<R>(a, k, r) & ONES;
    }
}

// Decision words of a chunk from its 4*R vote words, transposed one word
// at a time into the same tally as the replica-major path.
template <int R>
RW_HD void decide_rows(const uint32_t* v, uint32_t at[4][R], uint32_t q, uint32_t d[4]) {
    RW_UNROLL
    for (int k = 0; k < 4; ++k) {
        uint32_t c0 = 0, c1 = 0;
        RW_UNROLL
        for (int r = 0; r < R; ++r) tally_word(lane_word<R>(v, k, r), at[k][r], c0, c1);
        d[k] = decide_word(c0, c1, q);
    }
}

// nw words from the bytes at p, of which the first nbytes are real and
// the rest read `pad`.
RW_HD void load_bytes(const uint8_t* p, int nbytes, uint32_t* w, int nw, uint8_t pad) {
    RW_UNROLL
    for (int j = 0; j < nw; ++j) {
        uint32_t x = 0;
        RW_UNROLL
        for (int b = 0; b < 4; ++b) {
            const int i = 4 * j + b;
            x |= static_cast<uint32_t>(i < nbytes ? p[i] : pad) << (8 * b);
        }
        w[j] = x;
    }
}

// One chunk of n <= 16 shards of [T, S, R] votes through the byte-wise
// path: `votes` points at (t, s0, r=0), `alive` at (s0, r=0) of an
// [S, R] tensor. `ph` may be null.
template <int R>
RW_HD void tsr_chunk_bytes(const int8_t* votes, const uint8_t* alive, int n, uint32_t q,
                           int8_t* dec, int32_t* ph) {
    uint32_t v[4 * R], a[4 * R], at[4][R], d[4];
    load_bytes(reinterpret_cast<const uint8_t*>(votes), n * R, v, 4 * R, CODE_ABSENT);
    load_bytes(alive, n * R, a, 4 * R, 0);
    transpose_alive<R>(a, at);
    decide_rows<R>(v, at, q, d);
    store_dec_lanes(dec, n, d);
    if (ph) store_phase_lanes(ph, n, d);
}

#if defined(__CUDACC__)
// ---- the [T, S, R] layout's vector loads and stores on the card ----
//
// Shared by fused_window.cu and cluster_round.cu, which read the same
// layout: one thread a chunk of 16 shards of one slot row, 16*R
// contiguous bytes; a warp's 32 chunks are 32*16*R contiguous bytes.

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 4*R words of the n*R bytes at p (pad past them): R vector loads where
// the chunk is whole and aligned.
template <int R>
__device__ __forceinline__ void load_chunk(const uint8_t* p, int n, uint32_t* w, uint8_t pad) {
    if (n == LANES && aligned16(p)) {
        const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const uint4 x = __ldg(p4 + j);
            w[4 * j] = x.x; w[4 * j + 1] = x.y; w[4 * j + 2] = x.z; w[4 * j + 3] = x.w;
        }
    } else {
        load_bytes(p, n * R, w, 4 * R, pad);
    }
}

// The warp's 32*R vote vectors at pw (16-byte aligned), lane l loading
// vectors l, l + 32, ..., into `buf`; then each lane takes its own R.
template <int R>
__device__ __forceinline__ void load_warp_row(const uint4* pw, uint4* buf, int lane, uint32_t* w) {
#pragma unroll
    for (int j = 0; j < R; ++j) buf[32 * j + lane] = __ldg(pw + 32 * j + lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const uint4 x = buf[R * lane + j];
        w[4 * j] = x.x; w[4 * j + 1] = x.y; w[4 * j + 2] = x.z; w[4 * j + 3] = x.w;
    }
    __syncwarp();
}

// The warp's 32*16 phases at pw (16-byte aligned), lane l holding the
// four vectors p[] of its 16 shards: lane l's vector k goes to
// buf[4l + (k ^ swz(l))], so each quarter warp's stores and reads hit
// eight distinct 16-byte bank groups; then store k of lane l writes
// vector 32k + l.
__device__ __forceinline__ int swz(int l) { return (l >> 1) & 3; }

__device__ __forceinline__ void store_warp_phases(int4* pw, int4* buf, int lane, const int4 p[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) buf[4 * lane + (k ^ swz(lane))] = p[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int g = 32 * k + lane, src = g >> 2;
        pw[g] = buf[4 * src + ((g & 3) ^ swz(src))];
    }
    __syncwarp();
}

// The card's SM count, read once.
inline int sm_count() {
    static std::atomic<int> sms{0};
    int v = sms.load();
    if (v == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            v = 0;
        }
        sms.store(v);
    }
    return v;
}

// The launch shape of a kernel that walks [T, S, R] rows a chunk a
// thread: x the chunks of a row (a warp's chunks neighbour), y the rows.
// About 16 blocks an SM walk the rows, each thread an equal share, so a
// thread's transposed alive row serves many rows. Returns 0, or the
// error that keeps the launch from happening.
inline int tsr_launch_shape(int64_t T, int64_t S, dim3& grid, dim3& block) {
    const int64_t chunks = (S + LANES - 1) / LANES;
    const int bx = static_cast<int>(chunks >= 256 ? 256 : (chunks + 31) / 32 * 32);
    const int by = 256 / bx;
    const int64_t gx = (chunks + bx - 1) / bx;
    const int sms = sm_count();
    if (sms == 0) return static_cast<int>(cudaGetLastError());
    const int64_t rows_y = (T + by - 1) / by;
    const int64_t slots_y = (16LL * sms + gx - 1) / gx;  // blocks along y that fill the card
    const int64_t per = (rows_y + slots_y - 1) / slots_y;
    int64_t gy = (rows_y + per - 1) / per;
    if (gy > 65535) gy = 65535;  // the stride loop covers the rest
    if (gx > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    block = dim3(bx, by);
    return 0;
}
#endif  // __CUDACC__

}  // namespace rw
