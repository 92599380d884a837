// The device KV table's write windows as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the wave scans of the reference's XLA programs in
// rabia_tpu/apps/device_kv.py that write a table: `_apply_set_wave`
// scanned by `_build_fused` (decide_apply) and `step_body` scanned by
// `_build_mixed` (mixed_apply). A SET window passes no kind plane (every
// op a SET), a mixed window its real kinds. Windows that only read (the
// probe `_build_lookup_only` and the GET window `_build_lookup`) have a
// kernel of their own, kv_read.cu: this one always writes a table. The
// per-op rules are kv_window.cuh.
//
// The op rows come in the row form ([W, S, ...] planes) or in the
// reference's dictionary form (`_build_fused_dict` and the `D` branch
// of `_build_mixed`): each
// shard's D distinct rows ([S, D, ...] planes) and a rank u8[W, S]. The
// only place that reads op rows, issue_ops, takes each wave's row from
// kvw::op_row, so the dictionary is read in place; the rest of the
// kernel does not see the form. The wrapper sends dictionary windows on
// tables of at most 64 slots to kv_dict.cu, which runs the waves on the
// dictionary's key classes; here they come only on wider tables ("dict
// wide" in the wrapper's counts).
//
// A window's reads come gathered to the waves gidx names (row g is
// wave gidx[g]; Reads): mixed_apply's meta and gval, written by the
// launch itself, so a mixed window is one launch and one upload. A
// caller that wants every wave's reads passes gidx = 0..W-1.
//
// Bound: bytes. A window reads the table once and writes a fresh copy
// (the programs are functional: a dirty window rolls back by keeping
// the input table), reads the op planes once, and writes the read
// rows when asked for. At S=4096, P=64, K=32 B, VW=64 B that is
// ~28 MB of table each way and ~11 MB of op planes and read rows, ~20 us at
// the H100 SXM's 3.35 TB/s; the compares are a few integer operations
// per byte.
//
// Design: one warp per shard, every byte it touches staged in shared
// memory at once, and a wave loop that is a short chain of bit
// operations in registers.
//   1. Staging. Lane 0 issues the shard's table planes (keys, values,
//      lengths, versions, used flags: ~7 KB at the lane's shapes) as TMA
//      1D bulk copies completing on one mbarrier; the lanes issue all W
//      op key and value rows (S rows apart in the op planes) as cp.async
//      pieces, and load the op scalars and the shard version into
//      registers. A plane that is not 16-byte sized and aligned
//      moves as cp.async pieces instead (4-byte ones where its rows are
//      not whole 16-byte pieces). Key and value rows sit in shared memory
//      rounded up to whole 16-byte pieces, zero-padded, so every later
//      access is a 16-byte one. The warp waits once.
//   2. Candidates. Before the waves, every op's key is compared with
//      every slot's key and every earlier op's: a 32-bit tag of each row
//      first (lane i holds op i's; lane l slots l and l + 32), the full
//      rows where the tags agree. The result is bitmasks: cand[i] holds
//      the slots whose key is op i's; the used slots are one more.
//   3. Waves. Op i's match is the lowest set bit of used & cand[i], the
//      free slot the lowest clear bit of used; the warp-uniform step
//      (kv_window.cuh) then frees a slot or marks it written by wave i.
//      A SET that puts a fresh key into slot p sets or clears bit p of
//      every later op's cand, by whether that op's key is this one. No
//      wave compares keys or moves a row: a GET records the slot it read
//      and that slot's writer then, and after the loop all lanes write
//      the read rows (16-byte stores of the value rows) and then copy
//      each written slot's last SET rows into place.
//   4. Out. The fresh table leaves as TMA bulk stores of the staged
//      planes (16-byte or 4-byte stores where a plane is not bulk-sized
//      and aligned).
// Waves are staged 32 at a time; at the lane's W=16 there is one chunk.
// Tables wider than 64 slots keep their masks in shared memory and move
// rows in place as the waves go (chunk_wide). Measured on an H100 (see
// PERF.md), the lane's W=16 mixed window runs at about half its bytes
// bound: a warp's copies and its waves' dependent chain overlap only
// with other warps'.
//
// Decide and apply in one launch (kvw_decide_window). The reference's
// device programs also decide the window's slots first, with
// MeshPhaseKernel.slot_window on votes that are V1 from every replica
// for the waves that carry ops, and reduce to flags i32[3] = [all waves
// decided V1, any overflow, any version at the wrap]. Here that is part
// of the same kernel: the shard's alive row and base load as its copies
// are issued, and while the copies are in flight lane i of the shard's
// warp decides wave t0 + i with the header math of mesh_window.cuh
// (mw::decide_v1_wave: row_masks, coin_prefix, slot_of, decide,
// unchanged), from the alive row and a row of V1 votes in shared memory
// (no vote tensor exists); one ballot reduces the chunk. Each warp ORs
// its shard's flag bits (kv_window.cuh) into a scratch word; the last
// block to finish, counted on a scratch counter after a fence, writes
// the three flags and clears both words, so the scratch is zero between
// launches (and across CUDA-graph replays). The fold costs about 4%
// of the window's device time (PERF.md): a few registers, and a fence
// and an atomic a block, so its launch takes the largest block that
// keeps the most warps resident.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "kv_window.cuh"
#include "mesh_window.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct Table {
    const uint8_t* used;
    const int32_t* keyw;
    const int32_t* klen;
    const int32_t* ver;
    const int32_t* valw;
    const int32_t* vlen;
    const int32_t* sver;
};

struct OutTable {
    uint8_t* used;
    int32_t* keyw;
    int32_t* klen;
    int32_t* ver;
    int32_t* valw;
    int32_t* vlen;
    int32_t* sver;
};

struct Ops {
    const int8_t* kind;  // [W, S]; null: every op is kvw::implied_kind(kind_all)
    const int16_t* klen;  // [W, S], or [S, D] with idx
    const int16_t* vlen;  // as klen; null: every value is empty
    const int32_t* kw;    // [W, S, ku4], or [S, D, ku4] with idx
    const int32_t* vw;    // as kw with vwu4; null where vwu4 is 0
    const uint8_t* idx;   // [W, S] dictionary ranks; null: the row form
};

struct Reads {
    uint8_t* overflow;  // [S], always written
    // the reads, gathered (ver null: none): row g of ver and vlen (meta
    // i32[2, G, S]: the version, (vlen << 1) | found) and of val (gval
    // i32[G, S, VW4]) is wave gidx[g]
    int32_t* ver;
    int32_t* vlen;
    int32_t* val;
    const int32_t* gidx;
    int G;
};

struct Dims {
    int64_t S;
    int W, depth, P, K4, VW4, ku4, vwu4;
    int D;          // dictionary rows a shard (with Ops::idx)
    int kind_all;   // the kind of every op without a kind plane (SET or GET)
    int K4p, VW4p;  // key and value rows in shared memory: whole 16-byte pieces
    int MW;         // 64-bit words of a slot bitmask
    int wc;         // waves staged at once (<= 32)
    int R;          // replicas of the folded decision; 0 without one
};

// The window's decision, folded into the launch (kvw_decide_window).
struct Decide {
    const uint8_t* alive;  // u8[S, R], 0/1
    const int32_t* base;   // i32[S]: wave t of shard s is slot base[s] + t
    int quorum, f1, max_phases;
    uint32_t seed, threshold;
    int32_t* flags;      // i32[3] out
    uint32_t* scratch;   // u32[2]: blocks done, OR of shard flag bits; zero between launches
    uint32_t shard0;     // the global index of shard 0 (the coin's shard is shard0 + s)
};

__host__ __device__ inline int64_t align16(int64_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of one warp's shared-memory regions, each 16-byte aligned.
struct Layout {
    int64_t bar, umask, keys, vals, klen, ver, vlen, used, alive, v1row, opk, opv, orec, cand,
        total;
};

__host__ __device__ inline Layout layout(const Dims& d) {
    const int64_t P = d.P, wc = d.wc;
    Layout L;
    L.bar = 0;
    L.umask = 16;                                 // u64[MW]: used slots, and every p >= P
    L.keys = L.umask + align16(8 * d.MW);         // i32[P, K4p]
    L.vals = L.keys + align16(4 * P * d.K4p);     // i32[P, VW4p]
    L.klen = L.vals + align16(4 * P * d.VW4p);    // i32[P]
    L.ver = L.klen + align16(4 * P);              // i32[P]
    L.vlen = L.ver + align16(4 * P);              // i32[P]
    L.used = L.vlen + align16(4 * P);             // u8[P]
    L.alive = L.used + align16(P);                // u8[R]: the shard's alive row
    L.v1row = L.alive + align16(d.R);             // i8[R]: V1 votes
    L.opk = L.v1row + align16(d.R);               // i32[wc, K4p], zero past ku4
    L.opv = L.opk + align16(4 * wc * d.K4p);      // i32[wc, VW4p], zero past vwu4
    L.orec = L.opv + align16(4 * wc * d.VW4p);    // int4[wc]: kind, klen, vlen
    L.cand = L.orec + 16 * wc;                    // u64[wc, MW]
    L.total = L.cand + align16(8 * wc * d.MW);
    return L;
}

// ---- PTX: shared addresses, TMA bulk copies, cp.async, the mbarrier ----

__device__ __forceinline__ uint32_t sptr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(sptr(dst)), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(sptr(src)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sptr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sptr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// ---- moving planes between device and shared memory ----

// Can `rows` rows of `rw` words at `src` move as one bulk copy into rows
// of `ds` words? Only where the rows are unpadded and the run is
// 16-byte sized and aligned.
__device__ __forceinline__ bool bulk_ok(const void* g, int rows, int rw, int ds) {
    return rw == ds && (4LL * rows * rw) % 16 == 0 && aligned16(g);
}

// rows x rw words from contiguous src into shared rows of ds words, as
// cp.async pieces over the lanes: 16 bytes where the rows are whole
// 16-byte pieces on both sides, else 4 bytes. Pad words rw..ds-1 are
// zeroed.
__device__ void async_rows(int32_t* dst, const int32_t* src, int rows, int rw, int ds, int lane) {
    if (rw % 4 == 0 && ds % 4 == 0 && aligned16(src)) {
        const int per_row = rw / 4, n = rows * per_row;
        for (int i = lane; i < n; i += 32) {
            const int r = i / per_row, c = i - r * per_row;
            async16(dst + r * ds + 4 * c, src + r * rw + 4 * c);
        }
    } else {
        const int n = rows * rw;
        for (int i = lane; i < n; i += 32) {
            const int r = i / rw;
            async4(dst + r * ds + (i - r * rw), src + i);
        }
    }
    const int pad = ds - rw, np = rows * pad;
    for (int i = lane; i < np; i += 32) {
        const int r = i / pad;
        dst[r * ds + rw + (i - r * pad)] = 0;
    }
}

// rows x rw words from shared rows of ds words to contiguous dst: 16-byte
// stores where both sides allow, else 4-byte ones.
__device__ void store_rows(int32_t* dst, const int32_t* src, int rows, int rw, int ds, int lane) {
    if (rw % 4 == 0 && ds % 4 == 0 && aligned16(dst)) {
        const int per_row = rw / 4, n = rows * per_row;
        for (int i = lane; i < n; i += 32) {
            const int r = i / per_row, c = i - r * per_row;
            *reinterpret_cast<int4*>(dst + r * rw + 4 * c) =
                *reinterpret_cast<const int4*>(src + r * ds + 4 * c);
        }
        return;
    }
    const int n = rows * rw;
    for (int i = lane; i < n; i += 32) {
        const int r = i / rw;
        dst[i] = src[r * ds + (i - r * rw)];
    }
}

// ---- key compares ----

// A 32-bit tag of a key row (K4p words, whole 16-byte pieces) and its
// length: equal keys have equal tags, so only rows whose tags agree are
// compared in full.
__device__ __forceinline__ uint32_t key_tag(const int32_t* row, int K4p, int32_t klen) {
    const int4* r = reinterpret_cast<const int4*>(row);
    uint32_t h = static_cast<uint32_t>(klen);
    for (int c = 0; c < K4p / 4; ++c) {
        const int4 x = r[c];
        h = h * 0x9E3779B1u + static_cast<uint32_t>(x.x);
        h = h * 0x9E3779B1u + static_cast<uint32_t>(x.y);
        h = h * 0x9E3779B1u + static_cast<uint32_t>(x.z);
        h = h * 0x9E3779B1u + static_cast<uint32_t>(x.w);
    }
    return h;
}

__device__ __forceinline__ bool rows_equal(const int32_t* a, const int32_t* b, int K4p) {
    const int4* x = reinterpret_cast<const int4*>(a);
    const int4* y = reinterpret_cast<const int4*>(b);
    int diff = 0;
    for (int c = 0; c < K4p / 4; ++c) {
        const int4 u = x[c], v = y[c];
        diff |= (u.x ^ v.x) | (u.y ^ v.y) | (u.z ^ v.z) | (u.w ^ v.w);
    }
    return diff == 0;
}

// One warp's shard in shared memory (see Layout).
struct Smem {
    uint64_t* umask;
    int32_t* keys;
    int32_t* vals;
    int32_t* klen;
    int32_t* ver;
    int32_t* vlen;
    uint8_t* used;
    uint8_t* alive;
    int8_t* v1row;
    int32_t* opk;
    int32_t* opv;
    int4* orec;
    uint64_t* cand;
};

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
    const uint32_t lo = __shfl_sync(FULL, static_cast<uint32_t>(v), src);
    const uint32_t hi = __shfl_sync(FULL, static_cast<uint32_t>(v >> 32), src);
    return (static_cast<uint64_t>(hi) << 32) | lo;
}

// A chunk of nw waves on a table of at most 64 slots: lane l owns slots
// l and l + 32, lane i (< nw) owns wave t0 + i. The wave loop is register
// bookkeeping only: the used mask U (uniform), each wave's candidate mask
// (held by the wave's lane), each slot's source (-1: the staged row, else
// the chunk's last SET wave that wrote it, held by the slot's lane). The
// read outputs and the written rows move after the loop, over all lanes.
__device__ void chunk_small(const Smem& m, const Dims& d, const Reads& rd, int64_t s, int t0,
                           int nw, int4 rec, int lane, uint64_t& U, int32_t& sver,
                           bool& overflow) {
    const int P = d.P, K4p = d.K4p, VW4p = d.VW4p, VW4 = d.VW4;
    const int pA = lane, pB = lane + 32;
    const bool hasA = pA < P, hasB = pB < P;

    // ---- 2. candidates: tags compared all at once, then rows in full ----
    const uint32_t my_tag = lane < nw ? key_tag(m.opk + lane * K4p, K4p, rec.y) : 0u;
    const uint32_t tagA = hasA ? key_tag(m.keys + pA * K4p, K4p, m.klen[pA]) : 0u;
    const uint32_t tagB = hasB ? key_tag(m.keys + pB * K4p, K4p, m.klen[pB]) : 0u;
    uint64_t cmine = 0;  // lane i: the slots whose tag is op i's
    uint32_t ve = 0;     // lane i: the earlier ops whose tag is op i's
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        if (i >= nw) break;
        const uint32_t ti = __shfl_sync(FULL, my_tag, i);
        const uint32_t lo = __ballot_sync(FULL, hasA && tagA == ti);
        const uint32_t hi = __ballot_sync(FULL, hasB && tagB == ti);
        if (lane == i) cmine = (static_cast<uint64_t>(hi) << 32) | lo;
        ve |= (i < lane && lane < nw && my_tag == ti) ? 1u << i : 0u;
    }
    // ... of which those whose key is op i's, row for row
    for (uint64_t v = cmine; v != 0; v &= v - 1) {
        const int p = __ffsll(static_cast<long long>(v)) - 1;
        if (m.klen[p] != rec.y || !rows_equal(m.keys + p * K4p, m.opk + lane * K4p, K4p))
            cmine &= ~(uint64_t{1} << p);
    }
    uint32_t eqrow = 0;
    for (uint32_t v = ve; v != 0; v &= v - 1) {
        const int i = __ffs(v) - 1;
        if (rec.y == m.orec[i].y && rows_equal(m.opk + lane * K4p, m.opk + i * K4p, K4p))
            eqrow |= 1u << i;
    }

    // ---- 3. the waves ----
    int srcA = -1, srcB = -1;
    int r_slot = -1, r_src = -1;  // lane i: the slot wave i's GET read, and its source then
    bool r_found = false;
    int32_t wver = 0;  // lane i: the version wave i's SET gave its slot
    const int kind_kl = rec.y * 256 + (rec.x & 0xFF);  // lane i: op i's kind and key length
    for (int i = 0; i < nw; ++i) {
        const uint64_t c = shfl64(cmine, i);
        const int kk = __shfl_sync(FULL, kind_kl, i);
        const int kind = static_cast<int8_t>(kk & 0xFF), kl = kk >> 8;
        const uint64_t hit = U & c;
        const int match = hit != 0 ? __ffsll(static_cast<long long>(hit)) - 1 : -1;
        int free_slot = -1;  // only a SET of a fresh key looks for one
        if (kind == kvw::KIND_SET && match < 0 && ~U != 0)
            free_slot = __ffsll(static_cast<long long>(~U)) - 1;
        const kvw::Step st = kvw::wave_step(kind, t0 + i < d.depth, kl, match, free_slot);
        if (lane == i) r_found = st.rfound;
        if (st.get_hit) {
            const int msrc = __shfl_sync(FULL, match >= 32 ? srcB : srcA, match & 31);
            if (lane == i) {
                r_slot = match;
                r_src = msrc;
            }
        }
        if (st.del_hit) {
            U &= ~(uint64_t{1} << match);
            sver = kvw::bump(sver);
        }
        if (st.apply) {
            sver = kvw::bump(sver);
            const int p = st.slot;
            const uint64_t bit = uint64_t{1} << p;
            U |= bit;
            if (lane == (p & 31)) (p >= 32 ? srcB : srcA) = i;
            if (lane == i) wver = sver;
            if (match < 0 && lane > i)  // a fresh key in slot p
                cmine = (eqrow >> i) & 1u ? (cmine | bit) : (cmine & ~bit);
        }
        overflow = overflow || st.overflow;
    }

    // ---- the read rows, from the wave-entry rows: lane l takes row g0 + l,
    // if its wave gidx[g] is in this chunk (a row a lane: a chunk walks
    // the G rows once, and moves only its own rows' values) ----
    if (rd.ver != nullptr) {
        const int src_c = r_src < 0 ? 0 : r_src;
        const int32_t sv = __shfl_sync(FULL, wver, src_c);
        const int32_t sl = __shfl_sync(FULL, rec.z, src_c);
        const int slot_c = r_slot < 0 ? 0 : r_slot;
        const int32_t my_ver = r_slot < 0 ? 0 : (r_src < 0 ? m.ver[slot_c] : sv);
        const int32_t my_vlen = r_slot < 0 ? 0 : (r_src < 0 ? m.vlen[slot_c] : sl);
        const bool vec = VW4 % 4 == 0 && aligned16(rd.val);
        for (int g0 = 0; g0 < rd.G; g0 += 32) {
            const int g = g0 + lane;
            const int i = g < rd.G ? rd.gidx[g] - t0 : -1;
            const bool mine = i >= 0 && i < nw;
            const int ic = mine ? i : 0;
            const int32_t v = __shfl_sync(FULL, my_ver, ic);
            const int32_t l = __shfl_sync(FULL, my_vlen, ic);
            const int f = __shfl_sync(FULL, r_found ? 1 : 0, ic);
            const int rs = __shfl_sync(FULL, r_slot, ic), rsrc = __shfl_sync(FULL, r_src, ic);
            if (!mine) continue;
            const int64_t o = kvw::op_index(g, d.S, s);
            rd.ver[o] = v;
            rd.vlen[o] = static_cast<int32_t>(static_cast<uint32_t>(l) << 1) | f;
            const int32_t* row = rs < 0 ? nullptr : rsrc < 0 ? m.vals + rs * VW4p : m.opv + rsrc * VW4p;
            if (vec) {
                int4* dst = reinterpret_cast<int4*>(rd.val + o * VW4);
                for (int c = 0; c < VW4 / 4; ++c)
                    dst[c] = row == nullptr ? make_int4(0, 0, 0, 0)
                                            : reinterpret_cast<const int4*>(row)[c];
            } else {
                for (int c = 0; c < VW4; ++c) rd.val[o * VW4 + c] = row == nullptr ? 0 : row[c];
            }
        }
    }
    __syncwarp();  // the staged rows are read; now the written slots take their rows

    // ---- the slots the chunk wrote take their last SET's rows ----
    if (!__any_sync(FULL, srcA >= 0 || srcB >= 0)) return;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int p = lane + 32 * k, src = k ? srcB : srcA;
        const int src_c = src < 0 ? 0 : src;
        const int32_t sv = __shfl_sync(FULL, wver, src_c);
        const int32_t sk = __shfl_sync(FULL, rec.y, src_c);
        const int32_t sl = __shfl_sync(FULL, rec.z, src_c);
        if (src < 0) continue;
        for (int c = 0; c < K4p / 4; ++c)
            reinterpret_cast<int4*>(m.keys + p * K4p)[c] =
                reinterpret_cast<const int4*>(m.opk + src * K4p)[c];
        for (int c = 0; c < VW4p / 4; ++c)
            reinterpret_cast<int4*>(m.vals + p * VW4p)[c] =
                reinterpret_cast<const int4*>(m.opv + src * VW4p)[c];
        m.klen[p] = sk;
        m.vlen[p] = sl;
        m.ver[p] = sv;
    }
    __syncwarp();
}

// A chunk of nw waves on a table of any width: the masks live in shared
// memory (MW words a mask), and each wave moves its rows in place.
__device__ void chunk_wide(const Smem& m, const Dims& d, const Reads& rd, int64_t s, int t0,
                          int nw, int lane, int32_t& sver, bool& overflow) {
    const int P = d.P, K4p = d.K4p, VW4p = d.VW4p, VW4 = d.VW4, MW = d.MW;

    // ---- 2. candidates ----
    // lane a < nw: op a's tag, and bit b < a of eqrow where op b's key is op a's
    const int my_kl = lane < nw ? m.orec[lane].y : 0;
    const uint32_t my_tag = lane < nw ? key_tag(m.opk + lane * K4p, K4p, my_kl) : 0u;
    uint32_t eqrow = 0;
    for (int b = 0; b + 1 < nw; ++b) {
        const uint32_t tb = __shfl_sync(FULL, my_tag, b);
        bool c = lane < nw && b < lane && tb == my_tag;
        if (__any_sync(FULL, c)) {
            c = c && m.orec[b].y == my_kl && rows_equal(m.opk + lane * K4p, m.opk + b * K4p, K4p);
            eqrow |= c ? 1u << b : 0u;
        }
    }
    // cand[i]: the slots whose key is op i's (32 slots a ballot)
    uint32_t* cand32 = reinterpret_cast<uint32_t*>(m.cand);
    for (int k = 0; k < 2 * MW; ++k) {
        const int p = lane + 32 * k;
        const int32_t kl_p = p < P ? m.klen[p] : 0;
        const uint32_t tag_p = p < P ? key_tag(m.keys + p * K4p, K4p, kl_p) : 0u;
        for (int i = 0; i < nw; ++i) {
            const uint32_t ti = __shfl_sync(FULL, my_tag, i);
            bool c = p < P && tag_p == ti;
            unsigned bits = __ballot_sync(FULL, c);
            if (bits != 0) {
                c = c && kl_p == m.orec[i].y && rows_equal(m.keys + p * K4p, m.opk + i * K4p, K4p);
                bits = __ballot_sync(FULL, c);
            }
            if (lane == 0) cand32[i * 2 * MW + k] = bits;
        }
    }
    __syncwarp();

    // ---- 3. the waves: shared memory and registers only ----
    for (int i = 0; i < nw; ++i) {
        const int t = t0 + i;
        const int4 rec = m.orec[i];
        const uint64_t* ci = m.cand + i * MW;
        int match = -1, free_slot = -1;
        for (int j = 0; j < MW; ++j) {
            const uint64_t u = m.umask[j];
            const uint64_t hit = u & ci[j];
            if (match < 0 && hit != 0) match = 64 * j + __ffsll(static_cast<long long>(hit)) - 1;
            if (free_slot < 0 && ~u != 0)
                free_slot = 64 * j + __ffsll(static_cast<long long>(~u)) - 1;
            if (match >= 0 && free_slot >= 0) break;
        }
        const kvw::Step st = kvw::wave_step(rec.x, t < d.depth, rec.y, match, free_slot);
        if (rd.ver != nullptr) {  // every row g whose wave is t: the wave-entry state
            const int mm = st.get_hit ? match : 0;
            for (int g = 0; g < rd.G; ++g) {
                if (rd.gidx[g] != t) continue;
                const int64_t og = kvw::op_index(g, d.S, s);
                for (int j = lane; j < VW4; j += 32)
                    rd.val[og * VW4 + j] = st.get_hit ? m.vals[mm * VW4p + j] : 0;
                if (lane == 0) {
                    const int32_t vl = st.get_hit ? m.vlen[mm] : 0;
                    rd.ver[og] = st.get_hit ? m.ver[mm] : 0;
                    rd.vlen[og] = static_cast<int32_t>(static_cast<uint32_t>(vl) << 1) |
                                  (st.rfound ? 1 : 0);
                }
            }
        }
        if (st.del_hit) {
            if (lane == 0) m.umask[match >> 6] &= ~(uint64_t{1} << (match & 63));
            sver = kvw::bump(sver);
        }
        if (st.apply) {  // the slot takes the op's key and value rows, in place
            sver = kvw::bump(sver);
            const int p = st.slot;
            const int kc = K4p / 4, vc = VW4p / 4;
            for (int c = lane; c < kc + vc; c += 32) {
                if (c < kc) {
                    reinterpret_cast<int4*>(m.keys + p * K4p)[c] =
                        reinterpret_cast<const int4*>(m.opk + i * K4p)[c];
                } else {
                    reinterpret_cast<int4*>(m.vals + p * VW4p)[c - kc] =
                        reinterpret_cast<const int4*>(m.opv + i * VW4p)[c - kc];
                }
            }
            const uint64_t bit = uint64_t{1} << (p & 63);
            if (lane == 0) {
                m.klen[p] = rec.y;
                m.vlen[p] = rec.z;
                m.ver[p] = sver;
                m.umask[p >> 6] |= bit;
            }
            if (match < 0 && lane > i && lane < nw) {  // a fresh key in slot p
                uint64_t& w = m.cand[lane * MW + (p >> 6)];
                w = (eqrow >> i) & 1u ? (w | bit) : (w & ~bit);
            }
        }
        overflow = overflow || st.overflow;
        __syncwarp();
    }
}

constexpr int MAX_WARPS_PER_BLOCK = 8;

__device__ __forceinline__ Smem region_at(uint8_t* base, const Layout& L) {
    return Smem{reinterpret_cast<uint64_t*>(base + L.umask),
                reinterpret_cast<int32_t*>(base + L.keys),
                reinterpret_cast<int32_t*>(base + L.vals),
                reinterpret_cast<int32_t*>(base + L.klen),
                reinterpret_cast<int32_t*>(base + L.ver),
                reinterpret_cast<int32_t*>(base + L.vlen),
                base + L.used,
                base + L.alive,
                reinterpret_cast<int8_t*>(base + L.v1row),
                reinterpret_cast<int32_t*>(base + L.opk),
                reinterpret_cast<int32_t*>(base + L.opv),
                reinterpret_cast<int4*>(base + L.orec),
                reinterpret_cast<uint64_t*>(base + L.cand)};
}

// nw op rows of rw words into shared rows of ds words as cp.async pieces
// (16 bytes where the rows allow, else 4). The row form (idx null): wave
// w's row is row0 + w * S of src, as in the [W, S, rw] planes. The
// dictionary form: lane w holds wave w's row in my_row (-1: no row, the
// shared row is zeroed), passed to the lanes that copy it.
__device__ void async_op_rows(int32_t* dst, const int32_t* src, const uint8_t* idx, int64_t row0,
                              int64_t S, int64_t my_row, int nw, int rw, int ds, int lane) {
    const bool v16 = rw % 4 == 0 && aligned16(src);
    const int per_row = v16 ? rw / 4 : rw, n = nw * per_row;
    if (idx == nullptr) {
        for (int i = lane; i < n; i += 32) {
            const int w = i / per_row, c = i - w * per_row;
            const int32_t* row = src + (row0 + w * S) * rw;
            if (v16) async16(dst + w * ds + 4 * c, row + 4 * c);
            else async4(dst + w * ds + c, row + c);
        }
        return;
    }
    for (int i0 = 0; i0 < n; i0 += 32) {  // piece i of row i / per_row
        const int i = i0 + lane;
        const int w = min(i / per_row, nw - 1), c = i - (i / per_row) * per_row;
        const int64_t row = static_cast<int64_t>(shfl64(static_cast<uint64_t>(my_row), w));
        if (i >= n) continue;
        int32_t* to = dst + w * ds + (v16 ? 4 * c : c);
        if (row < 0) {
            if (v16) *reinterpret_cast<int4*>(to) = make_int4(0, 0, 0, 0);
            else *to = 0;
        } else if (v16) {
            async16(to, src + row * rw + 4 * c);
        } else {
            async4(to, src + row * rw + c);
        }
    }
}

// Issue the copies of one chunk of waves' op rows (all nw of them at
// once) into m.opk / m.opv as cp.async pieces, zero past the op widths;
// each wave's row is kvw::op_row's, in either form. Returns lane i's op
// record (kind, klen, vlen), loaded into registers; the caller commits
// the cp.async group, waits, and stores the records in m.orec.
__device__ int4 issue_ops(const Smem& m, const Ops& ops, const Dims& d, int64_t s, int t0,
                          int nw, int lane) {
    const int K4p = d.K4p, VW4p = d.VW4p;
    int4 rec = make_int4(0, 0, 0, 0);
    int64_t my_row = -1;
    if (lane < nw) {
        const int64_t o = kvw::op_index(t0 + lane, d.S, s);
        my_row = kvw::op_row(ops.idx, d.D, t0 + lane, d.S, s);
        const int32_t kl = my_row < 0 ? 0 : ops.klen[my_row];
        const int32_t vl = my_row < 0 || ops.vlen == nullptr ? 0 : ops.vlen[my_row];
        rec = make_int4(ops.kind != nullptr ? ops.kind[o] : kvw::implied_kind(d.kind_all, kl), kl,
                        vl, 0);
    }
    const int64_t row0 = kvw::op_index(t0, d.S, s);
    async_op_rows(m.opk, ops.kw, ops.idx, row0, d.S, my_row, nw, d.ku4, K4p, lane);
    async_op_rows(m.opv, ops.vw, ops.idx, row0, d.S, my_row, nw, d.vwu4, VW4p, lane);
    for (int i = lane; i < nw * (K4p - d.ku4); i += 32) {
        const int w = i / (K4p - d.ku4);
        m.opk[w * K4p + d.ku4 + (i - w * (K4p - d.ku4))] = 0;
    }
    for (int i = lane; i < nw * (VW4p - d.vwu4); i += 32) {
        const int w = i / (VW4p - d.vwu4);
        m.opv[w * VW4p + d.vwu4 + (i - w * (VW4p - d.vwu4))] = 0;
    }
    return rec;
}

// What a staged shard leaves in registers: lane i's op record of the
// first chunk, and the shard version.
struct Staged {
    int4 rec;
    int32_t sver;
};

// Issue every copy that brings shard s into shared memory, and wait for
// none: the table's planes as TMA bulk copies completing on the mbarrier
// (cp.async pieces where a plane is not 16-byte sized and aligned), the
// first chunk's op rows as cp.async pieces (one cp.async group with the
// table's pieces), the op scalars and the shard version as loads into
// registers.
__device__ Staged stage(const Smem& m, uint32_t bar, const Table& in, const Ops& ops,
                        const Dims& d, int64_t s, int lane) {
    const int P = d.P, K4 = d.K4, VW4 = d.VW4, K4p = d.K4p, VW4p = d.VW4p;
    const int32_t* g_keys = in.keyw + s * P * K4;
    const int32_t* g_vals = in.valw + s * P * VW4;
    const int32_t* g_klen = in.klen + s * P;
    const int32_t* g_ver = in.ver + s * P;
    const int32_t* g_vlen = in.vlen + s * P;
    const uint8_t* g_used = in.used + s * P;
    const bool b_keys = bulk_ok(g_keys, P, K4, K4p);
    const bool b_vals = bulk_ok(g_vals, P, VW4, VW4p);
    const bool b_lens = bulk_ok(g_klen, 1, P, P) && aligned16(g_ver) && aligned16(g_vlen);
    const bool b_used = P % 16 == 0 && aligned16(g_used);
    if (lane == 0) {
        const uint32_t tx = (b_keys ? 4u * P * K4 : 0u) + (b_vals ? 4u * P * VW4 : 0u) +
                            (b_lens ? 12u * P : 0u) + (b_used ? static_cast<uint32_t>(P) : 0u);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(tx)
                     : "memory");
        if (b_keys) bulk_load(m.keys, g_keys, 4u * P * K4, bar);
        if (b_vals) bulk_load(m.vals, g_vals, 4u * P * VW4, bar);
        if (b_lens) {
            bulk_load(m.klen, g_klen, 4u * P, bar);
            bulk_load(m.ver, g_ver, 4u * P, bar);
            bulk_load(m.vlen, g_vlen, 4u * P, bar);
        }
        if (b_used) bulk_load(m.used, g_used, static_cast<uint32_t>(P), bar);
    }
    if (!b_keys) async_rows(m.keys, g_keys, P, K4, K4p, lane);
    if (!b_vals) async_rows(m.vals, g_vals, P, VW4, VW4p, lane);
    if (!b_lens) {
        async_rows(m.klen, g_klen, 1, P, P, lane);
        async_rows(m.ver, g_ver, 1, P, P, lane);
        async_rows(m.vlen, g_vlen, 1, P, P, lane);
    }
    if (!b_used) {
        for (int p = lane; p < P; p += 32) m.used[p] = g_used[p];
    }
    Staged st;
    st.sver = in.sver[s];
    st.rec = d.W > 0 ? issue_ops(m, ops, d, s, 0, min(d.wc, d.W), lane) : make_int4(0, 0, 0, 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return st;
}

// The window on one staged shard: the waves with their read rows, then
// the fresh table, out of shared memory by TMA bulk stores (16-byte or
// 4-byte stores where a plane is not bulk-sized and aligned). Returns the
// shard's overflow and version-wrap flag bits (the same on every lane).
template <bool SMALL>
__device__ uint32_t window(const Smem& m, const Staged& staged, const OutTable& out,
                       const Ops& ops, const Reads& rd, const Dims& d, int64_t s, int lane) {
    const int P = d.P, K4 = d.K4, VW4 = d.VW4, K4p = d.K4p, VW4p = d.VW4p;
    int4 rec = staged.rec;
    int32_t sver = staged.sver;
    if (lane < min(d.wc, d.W)) m.orec[lane] = rec;
    __syncwarp();

    // the used slots as a bitmask; bits past P read as used, so never as free
    uint64_t U = 0;  // SMALL: in registers, uniform over the warp
    for (int k = 0; k < 2 * d.MW; ++k) {
        const int p = lane + 32 * k;
        const unsigned b = __ballot_sync(FULL, p >= P || m.used[p] != 0);
        if (SMALL) U |= static_cast<uint64_t>(b) << (32 * k);
        else if (lane == 0) reinterpret_cast<uint32_t*>(m.umask)[k] = b;
    }
    __syncwarp();

    bool overflow = false;
    for (int t0 = 0; t0 < d.W; t0 += d.wc) {
        const int nw = min(d.wc, d.W - t0);
        if (t0 > 0) {  // a later chunk's op rows, staged now
            __syncwarp();  // the last chunk is done with its op rows
            rec = issue_ops(m, ops, d, s, t0, nw, lane);
            asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
            if (lane < nw) m.orec[lane] = rec;
            __syncwarp();
        }
        if constexpr (SMALL) chunk_small(m, d, rd, s, t0, nw, rec, lane, U, sver, overflow);
        else chunk_wide(m, d, rd, s, t0, nw, lane, sver, overflow);
    }

    if (lane == 0) rd.overflow[s] = overflow;
    const uint32_t bits = kvw::shard_flags(true, overflow, sver);
    for (int p = lane; p < P; p += 32)
        m.used[p] = ((SMALL ? U : m.umask[p >> 6]) >> (p & 63)) & 1u;
    // the bulk stores read shared memory through the async proxy, after
    // the generic writes of every lane
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    int32_t* o_keys = out.keyw + s * P * K4;
    int32_t* o_vals = out.valw + s * P * VW4;
    int32_t* o_klen = out.klen + s * P;
    int32_t* o_ver = out.ver + s * P;
    int32_t* o_vlen = out.vlen + s * P;
    uint8_t* o_used = out.used + s * P;
    const bool bo_keys = bulk_ok(o_keys, P, K4, K4p);
    const bool bo_vals = bulk_ok(o_vals, P, VW4, VW4p);
    const bool bo_lens = bulk_ok(o_klen, 1, P, P) && aligned16(o_ver) && aligned16(o_vlen);
    const bool bo_used = P % 16 == 0 && aligned16(o_used);
    if (lane == 0) {
        if (bo_keys) bulk_store(o_keys, m.keys, 4u * P * K4);
        if (bo_vals) bulk_store(o_vals, m.vals, 4u * P * VW4);
        if (bo_lens) {
            bulk_store(o_klen, m.klen, 4u * P);
            bulk_store(o_ver, m.ver, 4u * P);
            bulk_store(o_vlen, m.vlen, 4u * P);
        }
        if (bo_used) bulk_store(o_used, m.used, static_cast<uint32_t>(P));
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        out.sver[s] = sver;
    }
    if (!bo_keys) store_rows(o_keys, m.keys, P, K4, K4p, lane);
    if (!bo_vals) store_rows(o_vals, m.vals, P, VW4, VW4p, lane);
    if (!bo_lens) {
        store_rows(o_klen, m.klen, 1, P, P, lane);
        store_rows(o_ver, m.ver, 1, P, P, lane);
        store_rows(o_vlen, m.vlen, 1, P, P, lane);
    }
    if (!bo_used) {
        for (int p = lane; p < P; p += 32) o_used[p] = m.used[p];
    }
    if (lane == 0) {
        // shared memory must outlive the bulk stores' reads of it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    return bits;
}

// Did every wave below depth of shard s decide V1? Lane i decides wave
// t0 + i of each chunk of 32 from the alive row (a0, a1: lanes r and
// r + 32 hold replica r's and r + 32's flag, loaded before the shard's
// copies were issued) and a V1 row, both put in shared memory; a ballot
// reduces each chunk.
__device__ bool decide_shard(const Smem& m, const Dims& d, const Decide& dc, int64_t s,
                             int lane, uint8_t a0, uint8_t a1, int32_t base) {
    if (lane < d.R) m.alive[lane] = a0;
    if (lane + 32 < d.R) m.alive[lane + 32] = a1;
    for (int r = lane; r < d.R; r += 32) m.v1row[r] = static_cast<int8_t>(mw::V1);
    __syncwarp();
    bool all_v1 = true;
    for (int t0 = 0; t0 < d.depth; t0 += 32) {
        const int t = t0 + lane;
        const bool v1 = t >= d.depth ||
                        mw::decide_v1_wave(m.v1row, m.alive, d.R, base,
                                           dc.shard0 + static_cast<uint32_t>(s),
                                           t, dc.quorum, dc.f1, dc.seed, dc.threshold,
                                           dc.max_phases) == mw::V1;
        all_v1 = __all_sync(FULL, v1) && all_v1;
    }
    return all_v1;
}

// One warp a shard. SMALL: tables of at most 64 slots (chunk_small);
// else chunk_wide. FOLD: the launch also decides the window and writes
// its flags. At most 128 registers a thread: a tighter cap spills in
// the wave loop, which costs more than the warps it would add.
template <bool SMALL, bool FOLD>
__global__ void __launch_bounds__(32 * MAX_WARPS_PER_BLOCK, 2)
kv_window_kernel(Table in, OutTable out, Ops ops, Reads rd, Dims d, Decide dc) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t s = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (s < d.S) {  // whole warps: no block-wide barrier inside
        const Layout L = layout(d);
        uint8_t* base = smem + warp * L.total;
        const uint32_t bar = sptr(base + L.bar);
        if (lane == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncwarp();  // the mbarrier is initialised before any lane waits on it
        const Smem m = region_at(base, L);
        // the decision's inputs load while the shard's copies are issued
        const uint8_t a0 = FOLD && lane < d.R ? dc.alive[s * d.R + lane] : 0;
        const uint8_t a1 = FOLD && lane + 32 < d.R ? dc.alive[s * d.R + lane + 32] : 0;
        const int32_t b = FOLD ? dc.base[s] : 0;
        const Staged staged = stage(m, bar, in, ops, d, s, lane);
        // the decision runs while the shard's copies are in flight
        const bool all_v1 = FOLD ? decide_shard(m, d, dc, s, lane, a0, a1, b) : true;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        // the one wait for the bulk copies; a lost transaction count would
        // spin forever, so fail the launch after about a second instead
        for (const long long t_start = clock64(); !bar_try_wait(bar, 0);) {
            if (clock64() - t_start > (1LL << 31)) __trap();
        }
        __syncwarp();
        const uint32_t bits = window<SMALL>(m, staged, out, ops, rd, d, s, lane) |
                              kvw::shard_flags(all_v1, false, 0);
        if (FOLD && lane == 0 && bits != 0) atomicOr(dc.scratch + 1, bits);
    }
    if (!FOLD) return;
    // the last block to finish writes the flags and clears the scratch
    __syncthreads();
    if (threadIdx.x == 0) {
        // the block's flag bits (ordered before this thread by the
        // barrier) before its count, as a grid-wide barrier orders them
        __threadfence();
        if (atomicAdd(dc.scratch, 1u) == gridDim.x - 1) {
            __threadfence();
            kvw::window_flags(atomicExch(dc.scratch + 1, 0u), dc.flags);
            atomicExch(dc.scratch, 0u);
        }
    }
}

constexpr int64_t MAX_SMEM = 227 * 1024;  // a block's shared memory on Hopper

// Warps a block for one instantiation at `per_warp` bytes of shared
// memory a warp: the count with the most warps resident on an SM, as the
// runtime reports it (registers, shared memory and its per-block
// reservation). 0 where one warp does not fit.
template <bool SMALL, bool FOLD>
int warps_per_block(int64_t per_warp) {
    auto kernel = kv_window_kernel<SMALL, FOLD>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(MAX_SMEM)) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess) {
        return 0;
    }
    int best = 0, best_resident = 0;
    for (int w = 1; w <= MAX_WARPS_PER_BLOCK && w * per_warp <= MAX_SMEM; ++w) {
        int nb = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, 32 * w,
                                                          static_cast<size_t>(w * per_warp)) !=
            cudaSuccess) {
            return 0;
        }
        // the most warps resident; the fold takes the largest block that
        // gets there, as each of its blocks ends with a fence and an atomic
        if (nb * w > best_resident || (FOLD && nb * w == best_resident)) {
            best = w;
            best_resident = nb * w;
        }
    }
    return best;
}

template <bool SMALL, bool FOLD>
int launch(Table in, OutTable out, Ops ops, Reads rd, Dims d, Decide dc, cudaStream_t stream) {
    // the warps a block for the last (device, bytes a warp) of this
    // instantiation
    static std::mutex mu;
    static int64_t memo_bytes = -1;
    static int memo_dev = -1, memo_warps = 0;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaGetLastError());
    const int64_t per_warp = layout(d).total;
    int warps;
    {
        std::lock_guard<std::mutex> lock(mu);
        if (memo_bytes != per_warp || memo_dev != dev) {
            memo_warps = warps_per_block<SMALL, FOLD>(per_warp);
            memo_bytes = per_warp, memo_dev = dev;
        }
        warps = memo_warps;
    }
    if (warps == 0) {
        cudaGetLastError();  // clear a refused attribute or query
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t blocks = (d.S + warps - 1) / warps;
    kv_window_kernel<SMALL, FOLD><<<static_cast<unsigned>(blocks), 32 * warps,
                                    static_cast<size_t>(per_warp * warps), stream>>>(
        in, out, ops, rd, d, dc);
    return static_cast<int>(cudaGetLastError());
}

// The arguments of both entries, unpacked and checked; returns 0 or a
// cudaError. The table's column order: used u8[S,P], keyw i32[S,P,K4],
// klen, ver i32[S,P], valw i32[S,P,VW4], vlen i32[S,P], sver i32[S].
int unpack(void* const* table, void* const* out, void* const* ops, void* const* reads,
           const long long* dims, Table& in, OutTable& o, Ops& op, Reads& rd, Dims& d) {
    d.S = dims[0];
    d.W = static_cast<int>(dims[1]);
    d.depth = static_cast<int>(dims[2]);
    d.P = static_cast<int>(dims[3]);
    d.K4 = static_cast<int>(dims[4]);
    d.VW4 = static_cast<int>(dims[5]);
    d.ku4 = static_cast<int>(dims[6]);
    d.vwu4 = static_cast<int>(dims[7]);
    d.D = static_cast<int>(dims[8]);
    d.kind_all = static_cast<int>(dims[9]);
    bool has_out = true;
    for (int i = 0; i < 7; ++i) has_out = has_out && out[i] != nullptr;
    if (!has_out || d.S < 0 || d.W < 0 || d.P < 1 || d.K4 < 1 || d.VW4 < 1 || d.ku4 < 0 ||
        d.ku4 > d.K4 || d.vwu4 < 0 || d.vwu4 > d.VW4 || d.depth < 0 || d.depth > d.W || d.D < 0 ||
        (d.kind_all != kvw::KIND_SET && d.kind_all != kvw::KIND_GET) || ops[1] == nullptr ||
        (ops[4] == nullptr && d.vwu4 != 0) || (ops[5] != nullptr && d.D < 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    d.K4p = (d.K4 + 3) / 4 * 4;
    d.VW4p = (d.VW4 + 3) / 4 * 4;
    d.MW = (d.P + 63) / 64;
    d.wc = d.W < 32 ? (d.W > 0 ? d.W : 1) : 32;
    d.R = 0;
    in = Table{static_cast<const uint8_t*>(table[0]), static_cast<const int32_t*>(table[1]),
               static_cast<const int32_t*>(table[2]), static_cast<const int32_t*>(table[3]),
               static_cast<const int32_t*>(table[4]), static_cast<const int32_t*>(table[5]),
               static_cast<const int32_t*>(table[6])};
    o = OutTable{static_cast<uint8_t*>(out[0]), static_cast<int32_t*>(out[1]),
                 static_cast<int32_t*>(out[2]), static_cast<int32_t*>(out[3]),
                 static_cast<int32_t*>(out[4]), static_cast<int32_t*>(out[5]),
                 static_cast<int32_t*>(out[6])};
    op = Ops{static_cast<const int8_t*>(ops[0]), static_cast<const int16_t*>(ops[1]),
             static_cast<const int16_t*>(ops[2]), static_cast<const int32_t*>(ops[3]),
             static_cast<const int32_t*>(ops[4]), static_cast<const uint8_t*>(ops[5])};
    rd = Reads{static_cast<uint8_t*>(reads[0]), static_cast<int32_t*>(reads[2]),
               static_cast<int32_t*>(reads[3]), static_cast<int32_t*>(reads[4]),
               static_cast<const int32_t*>(reads[5]), static_cast<int>(dims[10])};
    if (reads[1] != nullptr ||
        (rd.ver != nullptr && (rd.vlen == nullptr || rd.val == nullptr || rd.gidx == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return 0;
}

template <bool FOLD>
int run(Table in, OutTable o, Ops op, Reads rd, Dims d, Decide dc, cudaStream_t st) {
    while (d.wc > 1 && layout(d).total > MAX_SMEM) d.wc /= 2;
    return d.P <= 64 ? launch<true, FOLD>(in, o, op, rd, d, dc, st)
                     : launch<false, FOLD>(in, o, op, rd, d, dc, st);
}

}  // namespace

// table/out: 7 pointers each (see unpack); a window without an output
// table is kv_read.cu's (kvr_window). ops: kind i8[W,S] (null: every op is of kind_all:
// 1 a SET, 2 a read of every non-empty key), klen/vlen i16[W,S],
// kw i32[W,S,ku4], vw i32[W,S,vwu4], idx (null for this row form); or,
// with idx u8[W,S], the dictionary form: klen/vlen i16[S,D], kw
// i32[S,D,ku4], vw i32[S,D,vwu4]. vlen may be null (empty values), vw
// null with vwu4 0. reads: overflow u8[S], then null (kv_read.cu's found
// plane), the two planes of meta i32[2,G,S], gval i32[G,S,VW4] and gidx
// i32[G] (see Reads; the four null: no reads). dims: S, W, depth, P, K4,
// VW4, ku4, vwu4, D, kind_all, G. All contiguous. Launches on `stream`,
// returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue where one shard does not fit in a
// block's shared memory); does not synchronise.
extern "C" int kvw_window(void* const* table, void* const* out, void* const* ops,
                          void* const* reads, const long long* dims, void* stream) {
    Table in;
    OutTable o;
    Ops op;
    Reads rd;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, o, op, rd, d)) return err;
    if (d.S == 0) return 0;
    return run<false>(in, o, op, rd, d, Decide{}, static_cast<cudaStream_t>(stream));
}

// kvw_window, plus the window's decision in the same launch. decide: alive
// u8[S,R] (0/1), base i32[S], flags i32[3] (out), scratch u32[2] (zero
// before the launch; the launch leaves it zero). params: R (1..64),
// quorum, f1, max_phases, seed (32 bits), coin threshold, shard0 (the
// global index of the table's first shard: a shard block's offset).
extern "C" int kvw_decide_window(void* const* table, void* const* out, void* const* ops,
                                 void* const* reads, const long long* dims,
                                 void* const* decide, const long long* params, void* stream) {
    Table in;
    OutTable o;
    Ops op;
    Reads rd;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, o, op, rd, d)) return err;
    d.R = static_cast<int>(params[0]);
    Decide dc{static_cast<const uint8_t*>(decide[0]), static_cast<const int32_t*>(decide[1]),
              static_cast<int>(params[1]), static_cast<int>(params[2]),
              static_cast<int>(params[3]), static_cast<uint32_t>(params[4]),
              static_cast<uint32_t>(params[5]), static_cast<int32_t*>(decide[2]),
              static_cast<uint32_t*>(decide[3]), static_cast<uint32_t>(params[6])};
    if (d.R < 1 || d.R > mw::MAX_REPLICAS || dc.max_phases < 0 || dc.alive == nullptr ||
        dc.base == nullptr || dc.flags == nullptr || dc.scratch == nullptr || d.S == 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return run<true>(in, o, op, rd, d, dc, static_cast<cudaStream_t>(stream));
}
