// Per-shard math of the device KV table's write window on dictionary-form
// ops, shared by the CUDA kernel (kv_dict.cu) and a plain host build (g++)
// that the CPU tests hold against kv_window_plain and the reference's
// programs. The per-op rules are kv_window.cuh's (kvw::wave_step).
//
// A dictionary window gives each shard D distinct op rows (key length,
// key words, value length, value words) and each (wave, shard) a rank
// naming one of them; a rank at or past D names the empty op, here the
// null row r = D (key length 0, no words, empty value). Which slot an op
// matches depends only on its row's key, and which free slot a SET takes
// only on the used slots, so the window runs on bitmasks:
//
//   class   cls[r] = the lowest row q <= r whose key (length and K4 words,
//           zero past ku4) equals row r's. Rows can share a key with
//           different values: the dictionary tells rows apart on key and
//           value, the table on key alone.
//   cand    cand[c], for each class root c, the slots whose stored key is
//           c's (used or not); scls[p] the class whose key slot p holds
//           (NONE: no row's). Both are set once, before the waves, from
//           32-bit tags of the keys and one full compare where tags agree.
//   wave    match = the lowest bit of used & cand[cls[r]], free = the
//           lowest clear bit of used (bits past P read as used); the step
//           is kvw::wave_step. A SET that puts a fresh key into slot p
//           moves bit p from cand[scls[p]] to cand[c] (scls[p] = c), and
//           every SET records its row and the version it gave in
//           wrow[p] / wver[p]. A DEL clears bit p of used; the key stays.
//
// So no wave touches a key or value word. A read records where its
// version, length and value come from (a record): the input table's slot
// (no SET of the window wrote it yet), the dictionary row of the slot's
// last writer with the version that SET gave, or nothing (zeros). After
// the waves the fresh table takes, slot by slot, the input row or the
// row of its last writer, and each read row resolves its record.
#pragma once

#include <stdint.h>

#include "kv_window.cuh"

namespace kvd {

constexpr uint16_t NONE = 0xFFFF;      // no class, writer or source
constexpr uint32_t FROM_ROW = 0x8000;  // a record's source is a dictionary row
constexpr uint32_t FOUND = 1u << 16;   // a record's found bit

// Row r (0..D; D is the null row) of shard s: key and value lengths, and
// word j of a key or value plane of wu words a row (zero past wu, zero on
// the null row; a null plane has no words).
KV_HD int32_t row_klen(const int16_t* dkl, int64_t s, int D, int r) {
    return r < D ? dkl[s * D + r] : 0;
}
KV_HD int32_t row_vlen(const int16_t* dvl, int64_t s, int D, int r) {
    return r < D && dvl != nullptr ? dvl[s * D + r] : 0;
}
KV_HD int32_t row_word(const int32_t* w, int64_t s, int D, int wu, int r, int j) {
    return r < D && j < wu ? w[(s * D + r) * wu + j] : 0;
}

// Do two keys agree: length, and K4 words (a's wa words and b's wb
// words, each zero past its width; a null row has none)?
KV_HD bool same_key(int32_t kla, const int32_t* a, int wa, int32_t klb, const int32_t* b, int wb,
                    int K4) {
    if (kla != klb) return false;
    for (int j = 0; j < K4; ++j)
        if (kvw::op_word(a, j, wa) != kvw::op_word(b, j, wb)) return false;
    return true;
}

// Row r's key words (ku4 of them; none on the null row).
KV_HD const int32_t* row_key(const int32_t* dk, int64_t s, int D, int ku4, int r) {
    return r < D ? dk + (s * D + r) * ku4 : nullptr;
}

// Do rows q and r of shard s hold the same key?
KV_HD bool rows_same_key(const int16_t* dkl, const int32_t* dk, int64_t s, int D, int ku4, int K4,
                         int q, int r) {
    return same_key(row_klen(dkl, s, D, q), row_key(dk, s, D, ku4, q), q < D ? ku4 : 0,
                    row_klen(dkl, s, D, r), row_key(dk, s, D, ku4, r), r < D ? ku4 : 0, K4);
}

// Does a slot of key length slot_klen and K4 words slot_kw hold row r's key?
KV_HD bool slot_has_row_key(int32_t slot_klen, const int32_t* slot_kw, const int16_t* dkl,
                            const int32_t* dk, int64_t s, int D, int ku4, int K4, int r) {
    return same_key(slot_klen, slot_kw, K4, row_klen(dkl, s, D, r), row_key(dk, s, D, ku4, r),
                    r < D ? ku4 : 0, K4);
}

KV_HD uint64_t bit(int p) { return uint64_t{1} << p; }

// The used mask of a shard's P <= 64 slots; bits past P read as used.
KV_HD uint64_t used_mask(const uint8_t* used_row, int P) {
    uint64_t u = P < 64 ? ~uint64_t{0} << P : 0;
    for (int p = 0; p < P; ++p) u |= used_row[p] ? bit(p) : 0;
    return u;
}

// What a read saw: code = source (NONE, a slot p, or FROM_ROW | row) |
// FOUND; ver = the version of a row source (a slot's is the table's).
struct Rec {
    uint32_t code;
    int32_t ver;
};

// One wave of one shard on its masks. cand, scls, wrow and wver are the
// shard's arrays at stride st (the kernel interleaves shards); used, sver
// and overflow its running state. Returns the wave's read record (READS:
// the kernel's SET windows, which read nothing, leave it out). Written
// with selects where it can be: on a card one lane runs a shard's waves
// as one dependent chain, and branches that split the lanes cost more
// than the loads they would skip.
template <bool READS = true>
KV_HD Rec wave(int kind, bool present, int32_t klen, int row, int cls, uint64_t& used,
               int32_t& sver, bool& overflow, uint64_t* cand, uint16_t* scls, uint16_t* wrow,
               int32_t* wver, int st) {
    const uint64_t hit = used & cand[cls * st];
    const int match = hit != 0 ? kvw::lowest_bit(hit) : -1;
    const int first_free = ~used != 0 ? kvw::lowest_bit(~used) : -1;
    const kvw::Step step = kvw::wave_step(kind, present, klen, match, first_free);
    const int mi = match < 0 ? 0 : match;
    Rec rec{NONE, 0};
    if (READS) {
        const uint16_t w = wrow[mi * st];
        const int32_t wv = wver[mi * st];
        const uint32_t found = step.rfound ? FOUND : 0u;
        rec.code = NONE | found;
        if (step.get_hit) {
            rec.code = (w == NONE ? static_cast<uint32_t>(mi) : FROM_ROW | w) | found;
            rec.ver = w == NONE ? 0 : wv;
        }
    }
    used = step.del_hit ? used & ~bit(mi) : used;
    sver = step.del_hit || step.apply ? kvw::bump(sver) : sver;
    if (step.apply) {
        const int p = step.slot;
        used |= bit(p);
        wrow[p * st] = static_cast<uint16_t>(row);
        wver[p * st] = sver;
        if (match < 0) {  // a fresh key: slot p now holds class cls's key
            const uint16_t old = scls[p * st];
            if (old != NONE) cand[old * st] &= ~bit(p);
            cand[cls * st] |= bit(p);
            scls[p * st] = static_cast<uint16_t>(cls);
        }
    }
    overflow = overflow || step.overflow;
    return rec;
}

// Does every wave of a shard decide V1 at once when all its live
// replicas vote V1? Phase 0 of mw::decide sees n = popcount(alive) V1
// votes: at n >= quorum every R2 vote is V1, and at n >= f1 the phase
// decides V1, whatever the coin. Otherwise each wave needs
// mw::decide_v1_wave (its coin depends on the slot).
KV_HD bool all_v1_at_once(int n_alive, int quorum, int f1, int max_phases) {
    return max_phases > 0 && n_alive > 0 && n_alive >= quorum && n_alive >= f1;
}

// The read outputs, gathered: row g is wave gidx[g] (mixed_apply's GET
// waves; a caller that wants every wave's reads passes 0..W-1). ver is
// meta[0] and vlen meta[1] of meta i32[2, G, S], holding (vlen << 1) |
// found; val is gval i32[G, S, VW4].
struct ReadOut {
    int32_t* ver;
    int32_t* vlen;
    int32_t* val;
    const int32_t* gidx;
    int G;
};

KV_HD void put_scalars(const ReadOut& rd, int64_t o, bool found, int32_t ver, int32_t vlen) {
    rd.ver[o] = ver;
    rd.vlen[o] = static_cast<int32_t>(static_cast<uint32_t>(vlen) << 1) | (found ? 1 : 0);
}

// A record's source: the slot (>= 0) or row (>= 0) it reads, the other -1.
struct Source {
    int slot, row;
};

KV_HD Source source_of(uint32_t code) {
    const uint32_t src = code & 0xFFFFu;
    if (src == NONE) return Source{-1, -1};
    if (src & FROM_ROW) return Source{-1, static_cast<int>(src & ~FROM_ROW)};
    return Source{static_cast<int>(src), -1};
}

// Classes and candidates of shard s (the kernel computes the same with
// tags across a warp): cls[0..D], cand[0..D] (zero but at class roots),
// scls[0..P).
KV_HD void classes(int64_t s, int P, int K4, int ku4, int D, const int32_t* keyw,
                   const int32_t* klen, const int16_t* dkl, const int32_t* dk, uint16_t* cls,
                   uint64_t* cand, uint16_t* scls) {
    for (int r = 0; r <= D; ++r) {
        cls[r] = static_cast<uint16_t>(r);
        cand[r] = 0;
        for (int q = 0; q < r; ++q) {
            if (rows_same_key(dkl, dk, s, D, ku4, K4, q, r)) {
                cls[r] = static_cast<uint16_t>(q);
                break;
            }
        }
    }
    for (int p = 0; p < P; ++p) {
        scls[p] = NONE;
        const int64_t q = s * P + p;
        for (int r = 0; r <= D; ++r) {
            if (cls[r] == r && slot_has_row_key(klen[q], keyw + q * K4, dkl, dk, s, D, ku4, K4, r)) {
                scls[p] = static_cast<uint16_t>(r);
                cand[r] |= bit(p);
                break;
            }
        }
    }
}

// The window for shard s, serially (the host build's definition of the
// kernel's result): input table [S, P, ...] (P <= 64), output table of
// the same shape, dictionary ops (kind may be null: implied_kind of
// kind_all; dvl null: empty values; dv null with vwu4 0), overflow[s],
// and the read outputs when rd.ver is not null. Scratch: cand u64[D+1],
// cls u16[D+1], scls, wrow u16[P], wver i32[P], recs Rec[W].
KV_HD void window_shard(int64_t s, int W, int depth, int64_t S, int P, int K4, int VW4, int ku4,
                        int vwu4, int D, int kind_all, const uint8_t* used, const int32_t* keyw,
                        const int32_t* klen, const int32_t* ver, const int32_t* valw,
                        const int32_t* vlen, const int32_t* sver, uint8_t* o_used,
                        int32_t* o_keyw, int32_t* o_klen, int32_t* o_ver, int32_t* o_valw,
                        int32_t* o_vlen, int32_t* o_sver, const int8_t* kind, const uint8_t* idx,
                        const int16_t* dkl, const int16_t* dvl, const int32_t* dk,
                        const int32_t* dv, uint8_t* overflow, ReadOut rd, uint64_t* cand,
                        uint16_t* cls, uint16_t* scls, uint16_t* wrow, int32_t* wver, Rec* recs) {
    classes(s, P, K4, ku4, D, keyw, klen, dkl, dk, cls, cand, scls);
    for (int p = 0; p < P; ++p) wrow[p] = NONE;
    uint64_t u = used_mask(used + s * P, P);
    int32_t sv = sver[s];
    bool over = false;
    for (int t = 0; t < W; ++t) {
        const int64_t o = kvw::op_index(t, S, s);
        const int r = idx[o] < D ? idx[o] : D;
        const int32_t kl = row_klen(dkl, s, D, r);
        const int k = kind != nullptr ? kind[o] : kvw::implied_kind(kind_all, kl);
        recs[t] = wave(k, t < depth, kl, r, cls[r], u, sv, over, cand, scls, wrow, wver, 1);
    }
    if (rd.ver != nullptr) {
        for (int g = 0; g < rd.G; ++g) {
            const Rec rec = recs[rd.gidx[g]];
            const Source src = source_of(rec.code);
            const int64_t q = s * P + src.slot;
            const int32_t v = src.slot >= 0 ? ver[q] : rec.ver;
            const int32_t l = src.slot >= 0 ? vlen[q] : src.row >= 0 ? row_vlen(dvl, s, D, src.row) : 0;
            const int64_t o = kvw::op_index(g, S, s);
            put_scalars(rd, o, (rec.code & FOUND) != 0, v, l);
            for (int j = 0; j < VW4; ++j)
                rd.val[o * VW4 + j] = src.slot >= 0  ? valw[q * VW4 + j]
                                      : src.row >= 0 ? row_word(dv, s, D, vwu4, src.row, j)
                                                     : 0;
        }
    }
    for (int p = 0; p < P; ++p) {
        const int64_t q = s * P + p;
        const int w = wrow[p] == NONE ? -1 : wrow[p];
        o_used[q] = (u >> p) & 1u;
        o_klen[q] = w < 0 ? klen[q] : row_klen(dkl, s, D, w);
        o_ver[q] = w < 0 ? ver[q] : wver[p];
        o_vlen[q] = w < 0 ? vlen[q] : row_vlen(dvl, s, D, w);
        for (int j = 0; j < K4; ++j)
            o_keyw[q * K4 + j] = w < 0 ? keyw[q * K4 + j] : row_word(dk, s, D, ku4, w, j);
        for (int j = 0; j < VW4; ++j)
            o_valw[q * VW4 + j] = w < 0 ? valw[q * VW4 + j] : row_word(dv, s, D, vwu4, w, j);
    }
    o_sver[s] = sv;
    overflow[s] = over;
}

}  // namespace kvd
