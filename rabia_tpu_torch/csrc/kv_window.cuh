// Per-op math of the device KV table's window programs, shared by the
// CUDA kernel (kv_window.cu) and a plain host build (g++) that the CPU
// tests check against the reference's XLA programs.
//
// The table of one shard is P slots: used, key words [K4], key length,
// version, value words [VW4], value length; plus the shard version
// counter. One op per (wave t, shard s) has a kind (0 none, 1 SET,
// 2 GET, 3 DEL, 4 EXISTS), a key (klen bytes, ku4 words; words past ku4
// read as zero, so prefix equality is full-key equality against the
// zero-tailed stored keys) and a value (vlen bytes, vwu4 words). Waves
// apply in order; every read sees the wave-entry state:
//
//   match  = lowest used slot whose key length and every key word equal
//   found  = match exists
//   rfound = found and kind >= GET and klen > 0         (read output)
//   GET    = found and kind == GET: ver/vlen/value of the match
//   DEL    = present and kind == DEL and found: free the match, sver += 1
//   SET    = present and kind == SET: target the match, else the lowest
//            free slot; with neither the shard overflows and nothing
//            changes; else sver += 1 and the slot takes the key, the
//            value, and the version sver
//
// "present" is t < depth (the waves the window decides). Keys are unique
// among a shard's used slots: SET updates the matching slot and inserts
// only when none matches, so the programs keep that invariant.
//
// An op's key and value come in one of two forms (op_row): the row form,
// [W, S, ...] planes with one row per (wave, shard), or the dictionary
// form, [S, D, ...] planes with each shard's D distinct rows and a rank
// idx u8[W, S] naming the row of each (wave, shard). A window without a
// kind plane gives every op one kind (implied_kind): a SET, or a read of
// every non-empty key (the lookups).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define KV_HD __host__ __device__ __forceinline__
#else
#define KV_HD inline
#endif

namespace kvw {

constexpr int KIND_NONE = 0, KIND_SET = 1, KIND_GET = 2, KIND_DEL = 3, KIND_EXISTS = 4;

// i32 version arithmetic wraps (the reference's int32 counters do).
KV_HD int32_t bump(int32_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v) + 1u); }

// Word j of an op's key or value, zero past its bucketed width wu.
KV_HD int32_t op_word(const int32_t* w, int j, int wu) { return j < wu ? w[j] : 0; }

// Does a used slot hold the op's key? Slot word j is slot_kw[j * stride];
// op_kw holds the op's K4 words (already zero past its width).
KV_HD bool key_matches(bool used, int32_t slot_klen, const int32_t* slot_kw, int stride,
                       int32_t klen, const int32_t* op_kw, int K4) {
    if (!used || slot_klen != klen) return false;
    for (int j = 0; j < K4; ++j) {
        if (slot_kw[j * stride] != op_kw[j]) return false;
    }
    return true;
}

// What one op does, from its kind, presence, key length, the lowest
// matching slot and the lowest free slot (-1 for none).
struct Step {
    bool rfound;    // read output: found and kind >= GET and klen > 0
    bool get_hit;   // GET reads the matching slot's version and value
    bool del_hit;   // DEL frees the matching slot and bumps sver
    bool apply;     // SET writes `slot` and bumps sver
    bool overflow;  // SET of a fresh key on a full shard
    int slot;
};

KV_HD Step wave_step(int kind, bool present, int32_t klen, int match, int first_free) {
    Step r;
    const bool found = match >= 0;
    const bool is_set = present && kind == KIND_SET;
    const bool full = first_free < 0;
    r.rfound = found && kind >= KIND_GET && klen > 0;
    r.get_hit = found && kind == KIND_GET;
    r.del_hit = present && kind == KIND_DEL && found;
    r.apply = is_set && (found || !full);
    r.overflow = is_set && !found && full;
    r.slot = found ? match : first_free;
    return r;
}

// ---- the window's flags, when one launch decides and applies ----
//
// i32[3] = [every wave below depth decided V1, a shard overflowed, a
// shard's version counter reached VERSION_WRAP]. Each shard contributes
// bits whose OR over the shards is the reduction: bit 0 is the inverse
// of the shard's all-V1.
constexpr int32_t VERSION_WRAP = 2147483646;  // 2^31 - 2: the lane demotes at it
constexpr uint32_t FLAG_NOT_ALL_V1 = 1u, FLAG_OVERFLOW = 2u, FLAG_WRAP = 4u;

KV_HD uint32_t shard_flags(bool all_v1, bool overflow, int32_t sver) {
    return (all_v1 ? 0u : FLAG_NOT_ALL_V1) | (overflow ? FLAG_OVERFLOW : 0u) |
           (sver >= VERSION_WRAP ? FLAG_WRAP : 0u);
}

KV_HD void window_flags(uint32_t bits, int32_t* flags) {
    flags[0] = (bits & FLAG_NOT_ALL_V1) ? 0 : 1;
    flags[1] = (bits & FLAG_OVERFLOW) ? 1 : 0;
    flags[2] = (bits & FLAG_WRAP) ? 1 : 0;
}

// Where one shard's kind and outputs live in the [W, S, ...] planes.
KV_HD int64_t op_index(int t, int64_t S, int64_t s) { return static_cast<int64_t>(t) * S + s; }

// The row of op (wave t, shard s) in its key and value planes: row
// op_index(t, S, s) of the [W, S, ...] planes (idx null: the row form),
// else row s * D + idx[t, s] of the [S, D, ...] dictionary planes. A rank
// at or past D names no row (-1): the op is empty (key and value of
// length 0), as the reference's one-hot expansion over D gives zeros.
KV_HD int64_t op_row(const uint8_t* idx, int D, int t, int64_t S, int64_t s) {
    const int64_t o = op_index(t, S, s);
    if (idx == nullptr) return o;
    const int r = idx[o];
    return r < D ? s * D + r : -1;
}

// The kind of an op in a window without a kind plane: every op a SET
// (kind_all == KIND_SET), or a read of every non-empty key (KIND_GET).
KV_HD int implied_kind(int kind_all, int32_t klen) {
    return kind_all == KIND_GET ? (klen > 0 ? KIND_GET : KIND_NONE) : KIND_SET;
}

// The window for one shard, serially, in place on row-major [S, P, ...]
// table arrays (the host build's definition of the kernel's result), on
// ops of either form (op_row; D is ignored without idx). kind may be
// null (implied_kind of kind_all), op_vlen null (every value empty) and
// op_vw null with vwu4 0. The read planes may be null; when given they
// are written for every (wave, shard): zero where the op reads nothing.
KV_HD void scan_shard_ops(int64_t s, int W, int depth, int64_t S, int P, int K4, int VW4,
                          int ku4, int vwu4, int D, int kind_all,
                          uint8_t* used, int32_t* keyw, int32_t* klen, int32_t* ver,
                          int32_t* valw, int32_t* vlen, int32_t* sver,
                          const int8_t* kind, const uint8_t* idx, const int16_t* op_klen,
                          const int16_t* op_vlen, const int32_t* op_kw, const int32_t* op_vw,
                          uint8_t* overflow, uint8_t* r_found, int32_t* r_ver, int32_t* r_vlen,
                          int32_t* r_val, int32_t* key_scratch) {
    uint8_t* u = used + s * P;
    int32_t* kw = keyw + s * P * K4;
    int32_t* kl = klen + s * P;
    int32_t* vr = ver + s * P;
    int32_t* vw = valw + s * P * VW4;
    int32_t* vl = vlen + s * P;
    int32_t sv = sver[s];
    bool over = false;
    for (int t = 0; t < W; ++t) {
        const int64_t o = op_index(t, S, s);
        const int64_t row = op_row(idx, D, t, S, s);
        const int32_t kl_t = row < 0 ? 0 : op_klen[row];
        const int32_t vl_t = row < 0 || op_vlen == nullptr ? 0 : op_vlen[row];
        const int k = kind != nullptr ? kind[o] : implied_kind(kind_all, kl_t);
        for (int j = 0; j < K4; ++j)
            key_scratch[j] = row < 0 ? 0 : op_word(op_kw + row * ku4, j, ku4);
        int match = -1, first_free = -1;
        for (int p = 0; p < P; ++p) {
            if (match < 0 && key_matches(u[p] != 0, kl[p], kw + p * K4, 1, kl_t, key_scratch, K4))
                match = p;
            if (first_free < 0 && !u[p]) first_free = p;
        }
        const Step st = wave_step(k, t < depth, kl_t, match, first_free);
        if (r_found) {
            r_found[o] = st.rfound;
            r_ver[o] = st.get_hit ? vr[match] : 0;
            r_vlen[o] = st.get_hit ? vl[match] : 0;
            for (int j = 0; j < VW4; ++j) r_val[o * VW4 + j] = st.get_hit ? vw[match * VW4 + j] : 0;
        }
        if (st.del_hit) {
            u[match] = 0;
            sv = bump(sv);
        }
        if (st.apply) {
            sv = bump(sv);
            u[st.slot] = 1;
            kl[st.slot] = kl_t;
            vl[st.slot] = vl_t;
            vr[st.slot] = sv;
            for (int j = 0; j < K4; ++j) kw[st.slot * K4 + j] = key_scratch[j];
            for (int j = 0; j < VW4; ++j)
                vw[st.slot * VW4 + j] = row < 0 ? 0 : op_word(op_vw + row * vwu4, j, vwu4);
        }
        over = over || st.overflow;
    }
    sver[s] = sv;
    overflow[s] = over;
}

// ---- the read-only windows (kv_read.cu): the probe and the GET window ----
//
// A window with no output table reads the non-empty key of every op
// (implied_kind of KIND_GET) and writes nothing, so every wave sees the
// table as it was when the window began and the waves are independent:
// wave t's match is the lowest used slot holding op t's key, and a found
// GET reads that slot's version, length and value (wave_step). The kernel
// finds the match in two steps: a 32-bit tag of each key (its length and
// words) picks the candidate slots, and the full rows are compared only
// there, lowest slot first.

// One word more into a tag.
KV_HD uint32_t tag_add(uint32_t h, int32_t w) { return h * 0x9E3779B1u + static_cast<uint32_t>(w); }

// The tag of a key of length klen: words w[0..wu), then zeros to n words
// (w may be null with wu 0). Equal keys have equal tags.
KV_HD uint32_t key_tag(int32_t klen, const int32_t* w, int wu, int n) {
    uint32_t h = static_cast<uint32_t>(klen);
    for (int j = 0; j < n; ++j) h = tag_add(h, op_word(w, j, wu));
    return h;
}

KV_HD int lowest_bit(uint64_t v) {
#if defined(__CUDA_ARCH__)
    return __ffsll(static_cast<long long>(v)) - 1;
#else
    return __builtin_ctzll(v);
#endif
}

// The match among the candidates: bit i of cand is slot p0 + i, used and
// with the op's tag. The lowest candidate whose key length and K4 words
// (slot p's at keyw + p * K4) equal the op's (op_kw's ku4 words, zero
// past them), or -1.
KV_HD int read_match(uint64_t cand, int p0, const int32_t* klen, const int32_t* keyw, int K4,
                     int32_t op_klen, const int32_t* op_kw, int ku4) {
    for (uint64_t v = cand; v != 0; v &= v - 1) {
        const int p = p0 + lowest_bit(v);
        if (klen[p] != op_klen) continue;
        bool eq = true;
        for (int j = 0; j < K4 && eq; ++j) eq = keyw[p * K4 + j] == op_word(op_kw, j, ku4);
        if (eq) return p;
    }
    return -1;
}

// What one read wave writes: its found flag, and the slot it gathers the
// version, length and value from (-1: zeros).
struct Read {
    bool found;
    int slot;
};

KV_HD Read read_of(int32_t klen, int match) {
    const Step st = wave_step(implied_kind(KIND_GET, klen), false, klen, match, -1);
    return Read{st.rfound, st.get_hit ? match : -1};
}

// The read-only window of shard s, wave by wave, from the pieces above:
// the host build's definition of the read kernel's result. Ops in either
// form (op_row); the table is [S, P, ...] as in scan_shard_ops. The read
// planes are written for every (wave, shard).
KV_HD void read_shard(int64_t s, int W, int64_t S, int P, int K4, int VW4, int ku4, int D,
                      const uint8_t* used, const int32_t* keyw, const int32_t* klen,
                      const int32_t* ver, const int32_t* valw, const int32_t* vlen,
                      const uint8_t* idx, const int16_t* op_klen, const int32_t* op_kw,
                      uint8_t* r_found, int32_t* r_ver, int32_t* r_vlen, int32_t* r_val) {
    const uint8_t* u = used + s * P;
    const int32_t* kw = keyw + s * P * K4;
    const int32_t* kl = klen + s * P;
    for (int t = 0; t < W; ++t) {
        const int64_t o = op_index(t, S, s);
        const int64_t row = op_row(idx, D, t, S, s);
        const int32_t kl_t = row < 0 ? 0 : op_klen[row];
        const int32_t* ow = row < 0 ? nullptr : op_kw + row * ku4;
        const int wu = row < 0 ? 0 : ku4;
        const uint32_t tag = key_tag(kl_t, ow, wu, K4);
        int match = -1;
        for (int p0 = 0; p0 < P && match < 0; p0 += 64) {
            uint64_t cand = 0;
            for (int i = 0; i < 64 && p0 + i < P; ++i) {
                const int p = p0 + i;
                if (u[p] && key_tag(kl[p], kw + p * K4, K4, K4) == tag) cand |= uint64_t{1} << i;
            }
            match = read_match(cand, p0, kl, kw, K4, kl_t, ow, wu);
        }
        const Read r = read_of(kl_t, match);
        const int64_t q = s * P + r.slot;
        r_found[o] = r.found;
        r_ver[o] = r.slot < 0 ? 0 : ver[q];
        r_vlen[o] = r.slot < 0 ? 0 : vlen[q];
        for (int j = 0; j < VW4; ++j) r_val[o * VW4 + j] = r.slot < 0 ? 0 : valw[q * VW4 + j];
    }
}

// scan_shard_ops on row-form ops with a kind plane.
KV_HD void scan_shard(int64_t s, int W, int depth, int64_t S, int P, int K4, int VW4,
                      int ku4, int vwu4,
                      uint8_t* used, int32_t* keyw, int32_t* klen, int32_t* ver,
                      int32_t* valw, int32_t* vlen, int32_t* sver,
                      const int8_t* kind, const int16_t* op_klen, const int16_t* op_vlen,
                      const int32_t* op_kw, const int32_t* op_vw,
                      uint8_t* overflow, uint8_t* r_found, int32_t* r_ver, int32_t* r_vlen,
                      int32_t* r_val, int32_t* key_scratch) {
    scan_shard_ops(s, W, depth, S, P, K4, VW4, ku4, vwu4, 0, KIND_SET, used, keyw, klen, ver,
                   valw, vlen, sver, kind, nullptr, op_klen, op_vlen, op_kw, op_vw, overflow,
                   r_found, r_ver, r_vlen, r_val, key_scratch);
}

}  // namespace kvw
