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

}  // namespace rw
