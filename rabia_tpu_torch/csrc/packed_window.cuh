// Per-word math of the packed-vote window, shared by the CUDA kernel
// (packed_window.cu) and a plain host build (g++) that the CPU tests
// check against the reference's packed_window_rmajor.
//
// A uint32 word holds 16 two-bit vote codes (V0=00, V1=01, V?=10,
// ABSENT=11), lane k in bits 2k..2k+1. For each replica r, with
// lo = w & 0x55555555 and hi = (w >> 1) & 0x55555555 (one bit per lane,
// at the lane's low bit):
//   V1 plane = lo & ~hi & alive[r],   V0 plane = ~(lo | hi) & m & alive[r]
// where m = 0x55555555. Each plane is added into a bit-sliced counter of
// CAP = bit_length(R) planes (carry-save ripple, add_plane), and each
// counter is compared with the quorum, MSB first (ge_const). A lane
// decides V1 where its V1 count reaches the quorum, else V0 where its V0
// count does, else ABSENT; the codes go back in the same 2-bit layout.
// Every shift is on uint32_t, so every shift is logical.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define PW_HD __host__ __device__ __forceinline__
#define PW_UNROLL _Pragma("unroll")
#else
#define PW_HD inline
#define PW_UNROLL
#endif

namespace pw {

constexpr uint32_t EVEN = 0x55555555u;  // the lane-LSB positions (bits 0, 2, ..., 30)
constexpr int MAX_CAP = 7;              // counter planes: R <= 127

// Planes needed to count to R >= 1: bit_length(R).
PW_HD constexpr int cap_of(int R) {
    int c = 1;
    while ((R >> c) != 0) ++c;
    return c;
}

// The V1 and V0 planes of one replica's word under its alive bits.
PW_HD uint32_t v1_plane(uint32_t w, uint32_t alive) {
    const uint32_t lo = w & EVEN, hi = (w >> 1) & EVEN;
    return lo & ~hi & alive;
}
PW_HD uint32_t v0_plane(uint32_t w, uint32_t alive) {
    const uint32_t lo = w & EVEN, hi = (w >> 1) & EVEN;
    return ((lo | hi) ^ EVEN) & alive;
}

// Add plane b (one bit per lane) into the bit-sliced counter c[0..cap)
// (LSB first). The counts stay <= R < 2^cap, so the last carry is zero.
template <int CAP>
PW_HD void add_plane(uint32_t (&c)[CAP], uint32_t b, int cap) {
    uint32_t carry = b;
    PW_UNROLL
    for (int k = 0; k < CAP; ++k) {
        if (k < cap) {
            const uint32_t p = c[k];
            c[k] = p ^ carry;
            carry = p & carry;
        }
    }
}

// Lanes (at their low bit) whose count c[0..cap) is >= q: every lane for
// q <= 0, none for q > 2^cap - 1, else an MSB-first magnitude scan.
template <int CAP>
PW_HD uint32_t ge_const(const uint32_t (&c)[CAP], int cap, int q) {
    if (q <= 0) return EVEN;
    if (q > (1 << cap) - 1) return 0;
    uint32_t ge = 0, eq = EVEN;
    PW_UNROLL
    for (int k = CAP - 1; k >= 0; --k) {
        if (k < cap) {
            if ((q >> k) & 1) {
                eq &= c[k];
            } else {
                ge |= eq & c[k];
            }
        }
    }
    return ge | eq;
}

// The packed decision word from the two counters: V1 = 01 where ge1,
// else V0 = 00 where ge0, else ABSENT = 11.
template <int CAP>
PW_HD uint32_t decide(const uint32_t (&c1)[CAP], const uint32_t (&c0)[CAP], int cap, int q) {
    const uint32_t ge1 = ge_const(c1, cap, q);
    const uint32_t ge0 = ge_const(c0, cap, q);
    const uint32_t absent = (ge1 | ge0) ^ EVEN;
    return ge1 | absent | (absent << 1);
}

// One output word from the R replicas' words words[r * stride] and
// alive bits alive[r * astride]; R <= 2^CAP - 1.
template <int CAP>
PW_HD uint32_t decide_word(const uint32_t* words, int64_t stride, const uint32_t* alive,
                           int64_t astride, int R, int q) {
    const int cap = cap_of(R);
    uint32_t c1[CAP] = {}, c0[CAP] = {};
    for (int r = 0; r < R; ++r) {
        const uint32_t w = words[r * stride], a = alive[r * astride];
        add_plane(c1, v1_plane(w, a), cap);
        add_plane(c0, v0_plane(w, a), cap);
    }
    return decide(c1, c0, cap, q);
}

// ---- the packers (pack_codes, pack_alive, unpack_codes) ----
//
// Word w of a row of S one-byte codes holds codes 16w .. 16w+15, lane k
// in bits 2k..2k+1; lanes past the row's end take `fill` (ABSENT for the
// votes, 0 for the alive bits). A word is the sum of its lanes' values
// shifted into place, in uint32 arithmetic: for codes 0..3 that is their
// bitwise or, and for any byte it is what the plain version's int64 sum
// leaves in 32 bits.

// The word of the n <= 16 codes c[0..n), the other lanes `fill`.
PW_HD uint32_t pack16(const int8_t* c, int n, int fill) {
    uint32_t w = 0;
    PW_UNROLL
    for (int k = 0; k < 16; ++k) {
        const int32_t v = k < n ? static_cast<int32_t>(c[k]) : fill;
        w += static_cast<uint32_t>(v) << (2 * k);
    }
    return w;
}

// The alive word of the n <= 16 flags a[0..n): the low bit of lane k
// where a[k] != 0; other lanes and the high bits 0.
PW_HD uint32_t pack16_alive(const uint8_t* a, int n) {
    uint32_t w = 0;
    PW_UNROLL
    for (int k = 0; k < 16; ++k) {
        w |= (k < n && a[k] != 0) ? (1u << (2 * k)) : 0u;
    }
    return w;
}

// The n <= 16 codes of word w into out[0..n) (a logical shift of the
// uint32 pattern, so the top lane never sees a sign bit).
PW_HD void unpack16(uint32_t w, int8_t* out, int n) {
    PW_UNROLL
    for (int k = 0; k < 16; ++k) {
        if (k < n) out[k] = static_cast<int8_t>((w >> (2 * k)) & 3u);
    }
}

}  // namespace pw
