// The device KV table's write window on dictionary-form ops, as one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the reference's XLA programs `_build_fused_dict` (the SET
// window, decide_apply) and the `D` branch of `_build_mixed` (the mixed
// window, mixed_apply) in rabia_tpu/apps/device_kv.py, for tables of at
// most 64 slots a shard (the lane's and the reference's default) and
// dictionaries of at most 32 rows a shard (the packers' max_dict). Other
// dictionary windows keep kv_window.cu's dictionary path, which stages
// one copy of a wave's row for every wave (the wrapper counts those
// launches as "dict wide"). The per-shard math is kv_dict.cuh; the per-op
// rules kv_window.cuh.
//
// Bound: bytes at the lane's shapes. A window reads the table once and
// writes a fresh copy (S=4096, P=64, 32 B keys, 64 B values: ~29 MB each
// way), reads the dictionary and the ranks (a few hundred KB) and writes
// the read rows it is asked for; ~18 us on an H100 SXM. The operations
// the function needs are few: a tag of each of D rows and P slots and a
// lookup of each, once a shard, then a handful of integer operations a
// wave a shard.
//
// What held the earlier dictionary path back (kv_window.cu, one warp a
// shard): it staged one copy of a row for every wave, hashed and compared
// it again for every wave and against every earlier wave, and ran the
// waves as a chain of warp shuffles, 32 waves a chunk, with every byte of
// the shard in shared memory (17-18 warps an SM). Its time grew by about
// 1 us a wave. Here a block takes 32 shards, with 16 work warps and one
// copy warp:
//   1. All threads copy the block's keys, key lengths, used flags and
//      versions, its dictionary keys and key lengths, the ranks and kinds
//      of up to 256 waves and the decision's inputs into shared memory
//      (cp.async, one wait): one trip to memory for the block.
//   2. The copy warp then moves the block's slice of the table to the
//      fresh table as it is, through a ring of four 16 KB buffers in
//      shared memory (TMA bulk loads and stores issued by one thread),
//      while the work warps run steps 3 and 4: the table's bytes, the most
//      of the window's, move while the latency-bound steps run. (Started
//      at launch instead, it slowed step 1 about as much as it gained.)
//   3. Classes, a work warp a shard, in shared memory: lane r puts row r's
//      tag into the warp's tag table; each row and each slot (two a lane)
//      looks its tag up there and compares words only where a tag agrees.
//      A row's class is the lowest row with its key; cand[c] holds the
//      slots with class c's key. No wave stages, hashes or compares a row.
//      The lane's 32-byte keys (K4 = 8) take an unrolled path.
//   4. Every wave's rank and kind become a 32-bit code (class, row, kind,
//      present), and lane g of warp 0 runs shard g's waves on masks
//      (kvd::wave: a few integer operations a wave, eight codes read into
//      registers at a time). A scalar chain costs the same on one lane as
//      on 32, so a lane a shard does 32 shards' waves in the time the
//      earlier kernel did one's. Reads leave a record (source and version)
//      a wave, from which the work warps write the read rows that gidx
//      names (mixed_apply's meta and gval: version, (length << 1) |
//      found, value).
//   5. After a block barrier (the copy complete) all threads write the
//      slots the window wrote over the copy, each from the dictionary row
//      of its last writer, and the used flags. Only those slots' bytes are
//      written twice.
// What earlier builds of this kernel taught (PERF.md): run one
// after another, the copy waited behind the latency-bound steps; keys
// loaded word by word from device memory cost a dependent load each;
// 64-bit integer division in index arithmetic and 64-bit atomicOr on
// shared memory (a compare-and-swap loop) cost more than the steps they
// served. So the index arithmetic here is 32-bit, the masks take 32-bit
// atomics, and the patch works a slot at a time.
//
// The decision is folded into the same launch as in kv_window.cu: the
// work warps decide the (wave < depth, shard) entries with
// mesh_window.cuh's math (mw::decide_v1_wave), except on shards whose live
// replicas decide V1 in phase 0 (kvd::all_v1_at_once), and the block ORs
// its shards' flag bits (kv_window.cuh) into a scratch word; the last
// block to finish, counted on a scratch counter after a fence, writes the
// three flags and clears both words, so the scratch reads zero between
// launches and CUDA-graph replays.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "kv_dict.cuh"
#include "mesh_window.cuh"

namespace {

constexpr int G = 32;            // shards a block: one lane each in the wave loop
constexpr int NWORK = 512;       // the work warps' threads
constexpr int NWARP = NWORK / 32;
constexpr int NT = NWORK + 32;   // threads a block: the work warps and the copy warp
constexpr int MAX_CHUNK = 256;   // waves staged at once
constexpr int HT = 128;          // a warp's tag table: entries, at least twice D + 1
constexpr int HT_BITS = 7;
constexpr int RING = 4;          // the copy warp's buffers
constexpr int64_t RING_BYTES = 16 * 1024;  // bytes a buffer: ~64 KB in flight an SM
constexpr int64_t MAX_SMEM = 227 * 1024;
constexpr int MAX_D = 32;        // the packers' max_dict; more rows go to kv_window.cu

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
    const int8_t* kind;   // [W, S]; null: every op is kvw::implied_kind(kind_all)
    const int16_t* dkl;   // [S, D]
    const int16_t* dvl;   // [S, D]; null: every value is empty
    const int32_t* dk;    // [S, D, ku4]
    const int32_t* dv;    // [S, D, vwu4]; null where vwu4 is 0
    const uint8_t* idx;   // [W, S]
};

struct Dims {
    int64_t S;
    int W, depth, P, K4, VW4, ku4, vwu4, D, kind_all;
    int R;   // replicas of the folded decision; 0 without one
    int cw;  // waves staged at once
};

struct Decide {
    const uint8_t* alive;  // u8[S, R]
    const int32_t* base;   // i32[S]
    int quorum, f1, max_phases;
    uint32_t seed, threshold;
    int32_t* flags;      // i32[3] out
    uint32_t* scratch;   // u32[2], zero between launches
    uint32_t shard0;     // the global index of shard 0 (the coin's shard is shard0 + s)
};

__host__ __device__ inline int64_t align16(int64_t x) { return (x + 15) / 16 * 16; }

// The stride of the per-shard row arrays [G][x]: odd, so that the threads
// that read one row of 32 shards side by side each find a bank of its own.
__host__ __device__ inline int class_stride(const Dims& d) { return (d.D + 1) | 1; }

// Byte offsets of a block's shared memory. Arrays [x][G] hold shard g's
// entry x at x * G + g (the wave loop's lanes read them side by side);
// arrays [G][x] hold a shard's entries together (a warp reads them side by
// side in step 3). Step 1's copy of the table's keys, lengths, used flags
// and versions and of the dictionary's keys, and step 3's tag tables,
// share their space with the waves' codes and records.
struct Layout {
    int64_t bars, ring, cand, wver, scls, wrow, cls, rkl, rtag, ufin, sv, base, bits, alive, v1row,
        sidx, skind, code, rcode, rver, skeys, sklen, sused, ssver, sdk, sdkl, htab, total;
};

__host__ __device__ inline Layout layout(const Dims& d, bool reads) {
    const int64_t R1 = class_stride(d), P = d.P, cw = d.cw;
    Layout L;
    L.bars = 0;                                  // u64[RING]: the ring's mbarriers
    L.ring = 128;                                // u8[RING][RING_BYTES]
    L.cand = L.ring + RING * RING_BYTES;         // u64[D+1][G] (R1 >= D + 1 rows)
    L.wver = L.cand + 8 * R1 * G;                // i32[P][G]
    L.scls = L.wver + align16(4 * P * G);        // u16[P][G]
    L.wrow = L.scls + align16(2 * P * G);        // u16[P][G]
    L.cls = L.wrow + align16(2 * P * G);         // u16[G][R1]
    L.rkl = L.cls + align16(2 * R1 * G);         // i32[G][R1]: row key lengths
    L.rtag = L.rkl + align16(4 * R1 * G);        // u32[G][R1]: row key tags
    L.ufin = L.rtag + align16(4 * R1 * G);       // u64[G]: used masks
    L.sv = L.ufin + 8 * G;                       // i32[G]: shard versions
    L.base = L.sv + 4 * G;                       // i32[G]: the decision's first slots
    L.bits = L.base + 4 * G;                     // u32[G]: flag bits (not-all-V1 while deciding)
    L.alive = L.bits + 4 * G;                    // u8[G][R]
    L.v1row = L.alive + align16(int64_t{G} * d.R);  // i8[R]
    L.sidx = L.v1row + align16(d.R);             // u8[cw][G]: ranks
    L.skind = L.sidx + align16(cw * G);          // i8[cw][G]: kinds
    const int64_t shared = L.skind + align16(cw * G);
    L.code = shared;                             // u32[cw][G]: the waves' codes (wave_code)
    L.rcode = L.code + 4 * cw * G;               // u32[cw][G] (reads only)
    L.rver = L.rcode + (reads ? 4 * cw * G : 0);  // i32[cw][G]
    const int64_t step4 = L.rver + (reads ? 4 * cw * G : 0);
    L.skeys = shared;                            // i32[G][P][K4]: step 1's copy of the keys
    L.sklen = L.skeys + align16(4 * G * P * d.K4);  // i32[G][P]
    L.sused = L.sklen + align16(4 * G * P);      // u8[G][P]
    L.ssver = L.sused + align16(G * P);          // i32[G]
    L.sdk = L.ssver + 4 * G;                     // i32[G][D][ku4]: the dictionary's keys
    L.sdkl = L.sdk + align16(4 * G * d.D * d.ku4);  // i16[G][D]
    L.htab = L.sdkl + align16(2 * G * d.D);      // u64[NWARP][HT]: the tag tables
    const int64_t step3 = L.htab + 8 * int64_t{NWARP} * HT;
    L.total = step3 > step4 ? step3 : step4;
    return L;
}

struct Smem {
    uint64_t* bars;
    uint8_t* ring;
    uint64_t* cand;
    int32_t* wver;
    uint16_t* scls;
    uint16_t* wrow;
    uint16_t* cls;
    int32_t* rkl;
    uint32_t* rtag;
    uint64_t* ufin;
    int32_t* sv;
    int32_t* base;
    uint32_t* bits;
    uint8_t* alive;
    int8_t* v1row;
    uint8_t* sidx;
    int8_t* skind;
    uint32_t* code;
    uint32_t* rcode;
    int32_t* rver;
    int32_t* skeys;
    int32_t* sklen;
    uint8_t* sused;
    int32_t* ssver;
    int32_t* sdk;
    int16_t* sdkl;
    uint64_t* htab;
};

__device__ __forceinline__ Smem region(uint8_t* b, const Layout& L) {
    return Smem{reinterpret_cast<uint64_t*>(b + L.bars), b + L.ring,
                reinterpret_cast<uint64_t*>(b + L.cand), reinterpret_cast<int32_t*>(b + L.wver),
                reinterpret_cast<uint16_t*>(b + L.scls), reinterpret_cast<uint16_t*>(b + L.wrow),
                reinterpret_cast<uint16_t*>(b + L.cls),  reinterpret_cast<int32_t*>(b + L.rkl),
                reinterpret_cast<uint32_t*>(b + L.rtag), reinterpret_cast<uint64_t*>(b + L.ufin),
                reinterpret_cast<int32_t*>(b + L.sv),    reinterpret_cast<int32_t*>(b + L.base),
                reinterpret_cast<uint32_t*>(b + L.bits), b + L.alive,
                reinterpret_cast<int8_t*>(b + L.v1row),  b + L.sidx,
                reinterpret_cast<int8_t*>(b + L.skind),  reinterpret_cast<uint32_t*>(b + L.code),
                reinterpret_cast<uint32_t*>(b + L.rcode), reinterpret_cast<int32_t*>(b + L.rver),
                reinterpret_cast<int32_t*>(b + L.skeys), reinterpret_cast<int32_t*>(b + L.sklen),
                b + L.sused,                             reinterpret_cast<int32_t*>(b + L.ssver),
                reinterpret_cast<int32_t*>(b + L.sdk),   reinterpret_cast<int16_t*>(b + L.sdkl),
                reinterpret_cast<uint64_t*>(b + L.htab)};
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t n) {
    return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// Ask for `bytes` at `p` to be brought into L2 (a hint: skipped where the
// run is not 16-byte sized and aligned).
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes) {
    if (bytes <= 0 || bytes % 16 != 0 || !aligned(p, 16)) return;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
                 "r"(static_cast<uint32_t>(bytes))
                 : "memory");
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The work warps' barrier (named barrier 1; __syncthreads is barrier 0).
__device__ __forceinline__ void bar_work() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NWORK) : "memory");
}

// Words 4c..4c+3 of a row of wu words at `row` (null: no words), zero
// past wu; one 16-byte load where the row allows (vec).
__device__ __forceinline__ int4 piece4(const int32_t* row, int c, int wu, bool vec) {
    if (row == nullptr || 4 * c >= wu) return make_int4(0, 0, 0, 0);
    if (vec) return reinterpret_cast<const int4*>(row)[c];
    const int j = 4 * c;
    return make_int4(row[j], j + 1 < wu ? row[j + 1] : 0, j + 2 < wu ? row[j + 2] : 0,
                     j + 3 < wu ? row[j + 3] : 0);
}

// Start copying `rows` rows of `bytes` bytes (src rows `stride` bytes
// apart; dst rows `dstride`) into shared memory over threads t of n:
// cp.async pieces of 16 bytes where every row is 16-byte sized and
// aligned, 4 where it is 4-byte, else plain byte copies. The caller
// commits, waits and syncs once for every run.
__device__ void stage_in(void* dst, int64_t dstride, const void* src, int64_t stride, int rows,
                         int64_t bytes, int t, int n) {
    uint8_t* to = static_cast<uint8_t*>(dst);
    const uint8_t* from = static_cast<const uint8_t*>(src);
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                        static_cast<uintptr_t>(stride) | static_cast<uintptr_t>(dstride) |
                        static_cast<uintptr_t>(bytes);
    const int piece = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
    const int per = static_cast<int>(bytes / piece), total = per * rows;  // a block's few KB
    for (int i = t; i < total; i += n) {
        const int r = rows == 1 ? 0 : i / per, o = (i - r * per) * piece;
        uint8_t* dp = to + r * dstride + o;
        const uint8_t* sp = from + r * stride + o;
        if (piece == 16) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sptr(dp)), "l"(sp)
                         : "memory");
        } else if (piece == 4) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sptr(dp)), "l"(sp)
                         : "memory");
        } else {
            *dp = *sp;
        }
    }
}

__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The ranks (and kinds) of waves [t0, t0 + nw) of the block's shards into
// sidx / skind ([tl][G]).
__device__ void stage_waves(const Smem& m, const Ops& ops, const Dims& d, int64_t s0, int nS,
                            int t0, int nw, int t, int n) {
    stage_in(m.sidx, G, ops.idx + t0 * d.S + s0, d.S, nw, nS, t, n);
    if (ops.kind != nullptr) stage_in(m.skind, G, ops.kind + t0 * d.S + s0, d.S, nw, nS, t, n);
}

// ---- step 2: the copy warp's ring (TMA bulk copies, one thread) ----

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

// One run of bytes to copy device to device.
struct Run {
    const uint8_t* src;
    uint8_t* dst;
    int64_t bytes;
};

__device__ __forceinline__ bool bulk_ok(const Run& r) {
    return aligned(r.src, 16) && aligned(r.dst, 16) && r.bytes % 16 == 0;
}

// Position (run, offset) of the next chunk over the runs that move by TMA;
// false when none is left.
template <int N>
__device__ __forceinline__ bool next_chunk(const Run (&runs)[N], int& i, int64_t& o,
                                           int64_t& bytes) {
    while (i < N && (o >= runs[i].bytes || !bulk_ok(runs[i]))) {
        ++i;
        o = 0;
    }
    if (i >= N) return false;
    bytes = runs[i].bytes - o < RING_BYTES ? runs[i].bytes - o : RING_BYTES;
    return true;
}

// The runs that are 16-byte sized and aligned, through the ring: chunk k
// loads into buffer k % RING (completing on that buffer's mbarrier) and
// leaves by a bulk store; a buffer is loaded again once the store has
// read it. Returns after every store has completed and is ordered before
// the generic writes that follow the block barrier.
template <int N>
__device__ void ring_copy(const Smem& m, const Run (&runs)[N]) {
    for (int b = 0; b < RING; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sptr(m.bars + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int li = 0, si = 0;
    int64_t lo = 0, so = 0, lb = 0, sb = 0;
    int issued = 0, stored = 0;
    auto load = [&]() -> bool {
        if (!next_chunk(runs, li, lo, lb)) return false;
        const int b = issued % RING;
        const uint32_t bar = sptr(m.bars + b);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(static_cast<uint32_t>(lb))
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(sptr(m.ring + b * RING_BYTES)),
            "l"(runs[li].src + lo), "r"(static_cast<uint32_t>(lb)), "r"(bar)
            : "memory");
        lo += lb;
        ++issued;
        return true;
    };
    while (issued < RING && load()) {
    }
    while (stored < issued) {
        const int b = stored % RING;
        for (const long long t_start = clock64(); !bar_try_wait(sptr(m.bars + b), (stored / RING) & 1);) {
            if (clock64() - t_start > (1LL << 31)) __trap();  // a lost transfer: fail the launch
        }
        next_chunk(runs, si, so, sb);
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                         runs[si].dst + so),
                     "r"(sptr(m.ring + b * RING_BYTES)), "r"(static_cast<uint32_t>(sb))
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        so += sb;
        ++stored;
        // the buffer is free once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load();
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The runs that are not, by the copy warp's lanes.
template <int N>
__device__ void plain_copy(const Run (&runs)[N], int lane) {
    for (int k = 0; k < N; ++k) {
        if (bulk_ok(runs[k])) continue;
        const Run& r = runs[k];
        if (aligned(r.src, 4) && aligned(r.dst, 4) && r.bytes % 4 == 0) {
            for (int64_t i = lane; i < r.bytes / 4; i += 32)
                reinterpret_cast<int32_t*>(r.dst)[i] = reinterpret_cast<const int32_t*>(r.src)[i];
        } else {
            for (int64_t i = lane; i < r.bytes; i += 32) r.dst[i] = r.src[i];
        }
    }
}

// A wave of shard g as the loop takes it: its row's class (bits 0-9), the
// row (10-19), its kind clamped to 0..4 (20-22: kvw::wave_step reads a
// kind only as none, SET, GET, DEL or a read), present (23), and whether
// its key is non-empty (24: wave_step reads the length only so).
__device__ __forceinline__ uint32_t wave_code(int cls, int row, int kind, bool present, int32_t kl) {
    const uint32_t k = kind < 0 ? 0u : kind > kvw::KIND_EXISTS ? 4u : static_cast<uint32_t>(kind);
    return static_cast<uint32_t>(cls) | static_cast<uint32_t>(row) << 10 | k << 20 |
           (present ? 1u << 23 : 0u) | (kl > 0 ? 1u << 24 : 0u);
}

// A tag's first entry in a tag table: its top bits (a tag's low bits
// depend only on the low bits of the key's words).
__device__ __forceinline__ int home(uint32_t tag) { return static_cast<int>(tag >> (32 - HT_BITS)); }

// 3. Shard g's classes and candidates (kvd::classes, by tags), its used
// mask and version, one work warp, on the block's copy in shared memory.
// Lane r takes row r: its tag and length, and an entry (tag, r) in the
// warp's tag table (open addressing). Then each row, and each of the two
// slots a lane holds (l and l + 32), looks its tag up there: the lowest
// row with the tag whose length and words agree is its class. So every
// lookup costs about one probe and one compare of words, whatever D is.
// K4C: the key words a slot, known when compiled (8, the lane's), or 0.
template <int K4C>
__device__ void classes_warp(const Smem& m, const Dims& d, int g, int lane, uint64_t* ht) {
    const int D = d.D, K4 = K4C ? K4C : d.K4, ku4 = d.ku4, P = d.P, R1 = class_stride(d);
    const int32_t* sk = m.skeys + static_cast<int64_t>(g) * P * K4;  // slot p at sk + p * K4
    const int32_t* dk = m.sdk + static_cast<int64_t>(g) * D * ku4;    // row r at dk + r * ku4
    int32_t* rkl = m.rkl + g * R1;
    uint32_t* rtag = m.rtag + g * R1;
    uint16_t* cls = m.cls + g * R1;
    auto row = [&](int r) -> const int32_t* { return r < D ? dk + r * ku4 : nullptr; };
    auto row_wu = [&](int r) { return r < D ? ku4 : 0; };
    for (int i = lane; i < HT; i += 32) ht[i] = 0;
    __syncwarp();
    for (int r = lane; r <= D; r += 32) {
        const int32_t kl = r < D ? m.sdkl[g * D + r] : 0;
        const uint32_t tag = kvw::key_tag(kl, row(r), row_wu(r), K4);
        rkl[r] = kl;
        rtag[r] = tag;
        m.cand[r * G + g] = 0;
        const unsigned long long e = static_cast<unsigned long long>(tag) << 32 | (r + 1u);
        for (int h = home(tag);; h = (h + 1) & (HT - 1))
            if (atomicCAS(reinterpret_cast<unsigned long long*>(ht + h), 0ull, e) == 0ull) break;
    }
    const bool hasA = lane < P, hasB = lane + 32 < P;
    const int32_t klA = hasA ? m.sklen[g * P + lane] : 0;
    const int32_t klB = hasB ? m.sklen[g * P + lane + 32] : 0;
    const uint32_t tagA = hasA ? kvw::key_tag(klA, sk + lane * K4, K4, K4) : 0u;
    const uint32_t tagB = hasB ? kvw::key_tag(klB, sk + (lane + 32) * K4, K4, K4) : 0u;
    const unsigned lo = __ballot_sync(0xFFFFFFFFu, !hasA || m.sused[g * P + lane] != 0);
    const unsigned hi = __ballot_sync(0xFFFFFFFFu, !hasB || m.sused[g * P + lane + 32] != 0);
    __syncwarp();
    // the lowest row holding the key (kl, w[0..wu)), or NONE
    auto lowest = [&](uint32_t tag, int32_t kl, const int32_t* w, int wu) -> uint16_t {
        int best = kvd::NONE;
        for (int h = home(tag);; h = (h + 1) & (HT - 1)) {
            const uint64_t e = ht[h];
            if (e == 0) break;
            const int r = static_cast<int>(static_cast<uint32_t>(e)) - 1;
            if (static_cast<uint32_t>(e >> 32) == tag && r < best && rkl[r] == kl &&
                kvd::same_key(kl, w, wu, kl, row(r), row_wu(r), K4))
                best = r;
        }
        return static_cast<uint16_t>(best);
    };
    for (int r = lane; r <= D; r += 32) cls[r] = lowest(rtag[r], rkl[r], row(r), row_wu(r));
    const uint16_t scA = hasA ? lowest(tagA, klA, sk + lane * K4, K4) : kvd::NONE;
    const uint16_t scB = hasB ? lowest(tagB, klB, sk + (lane + 32) * K4, K4) : kvd::NONE;
    // slot l is bit l of its class's mask: bit l % 32 of 32-bit half l / 32
    // (a 64-bit atomicOr on shared memory is a compare-and-swap loop)
    if (hasA) {
        m.scls[lane * G + g] = scA;
        m.wrow[lane * G + g] = kvd::NONE;
        if (scA != kvd::NONE)
            atomicOr(reinterpret_cast<unsigned*>(m.cand + scA * G + g), 1u << lane);
    }
    if (hasB) {
        m.scls[(lane + 32) * G + g] = scB;
        m.wrow[(lane + 32) * G + g] = kvd::NONE;
        if (scB != kvd::NONE)
            atomicOr(reinterpret_cast<unsigned*>(m.cand + scB * G + g) + 1, 1u << lane);
    }
    if (lane == 0) {  // the used slots; bits past P read as used
        m.ufin[g] = (static_cast<uint64_t>(hi) << 32) | lo;
        m.sv[g] = m.ssver[g];
    }
    __syncwarp();  // the tag table is free for the warp's next shard
}

// 4b. The read rows of the waves [t0, t0 + nw), from their records, over
// the work warps' threads.
__device__ void stream_reads(const Smem& m, const Table& in, const Ops& ops, const kvd::ReadOut& rd,
                             const Dims& d, int64_t s0, int nS, int t0, int nw, int tid) {
    const int P = d.P, D = d.D, VW4 = d.VW4, vwu4 = d.vwu4;
    // the record of (row o, shard g), or -1 where o's wave is not in the chunk
    auto rec_at = [&](int o, int g) -> int {
        const int tl = rd.gidx[o] - t0;
        return tl >= 0 && tl < nw ? tl * G + g : -1;
    };
    const bool vec = VW4 % 4 == 0 && aligned(rd.val, 16) && aligned(in.valw, 16);
    const bool dvec = vwu4 % 4 == 0 && aligned(ops.dv, 16);
    for (int i = tid; i < rd.G * nS; i += NWORK) {  // a read row a thread
        const int o = i / nS, g = i - o * nS;
        const int k = rec_at(o, g);
        if (k < 0) continue;
        const int64_t s = s0 + g;
        const uint32_t code = m.rcode[k];
        const kvd::Source src = kvd::source_of(code);
        const int64_t q = s * P + src.slot;
        const int32_t v = src.slot >= 0 ? in.ver[q] : m.rver[k];
        const int32_t l = src.slot >= 0 ? in.vlen[q]
                          : src.row >= 0 ? kvd::row_vlen(ops.dvl, s, D, src.row) : 0;
        const int64_t orow = kvw::op_index(o, d.S, s);
        kvd::put_scalars(rd, orow, (code & kvd::FOUND) != 0, v, l);
        const int32_t* from = src.slot >= 0 ? in.valw + q * VW4
                              : src.row >= 0 && src.row < D ? ops.dv + (s * D + src.row) * vwu4
                                                            : nullptr;
        const int wu = src.slot >= 0 ? VW4 : vwu4;
        const bool fvec = src.slot >= 0 ? vec : dvec;
        if (vec) {
            for (int c = 0; c < VW4 / 4; ++c)
                reinterpret_cast<int4*>(rd.val + orow * VW4)[c] = piece4(from, c, wu, fvec);
        } else {
            for (int j = 0; j < VW4; ++j) rd.val[orow * VW4 + j] = kvw::op_word(from, j, from ? wu : 0);
        }
    }
}

// 4a. Shard g's waves of a chunk on lane g, from their codes (eight read
// into registers at a time); READS: keep each wave's read record.
template <bool READS>
__device__ void run_waves(const Smem& m, int g, int nw, uint64_t& used, int32_t& sver,
                          bool& over) {
    for (int tb = 0; tb < nw; tb += 8) {
        uint32_t cv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) cv[u] = tb + u < nw ? m.code[(tb + u) * G + g] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            if (tb + u >= nw) break;
            const uint32_t c = cv[u];
            const kvd::Rec rec = kvd::wave<READS>(
                static_cast<int>((c >> 20) & 7u), (c >> 23) & 1u,
                static_cast<int32_t>((c >> 24) & 1u), static_cast<int>((c >> 10) & 1023u),
                static_cast<int>(c & 1023u), used, sver, over, m.cand + g, m.scls + g, m.wrow + g,
                m.wver + g, G);
            if (READS) {
                m.rcode[(tb + u) * G + g] = rec.code;
                m.rver[(tb + u) * G + g] = rec.ver;
            }
        }
    }
}

// 5. The slots the window wrote, over the copy: each from the dictionary
// row of its last writer; and every used flag. All threads, a slot each.
__device__ void patch_written(const Smem& m, const Ops& ops, const OutTable& out, const Dims& d,
                              int64_t s0, int nS, int tid) {
    const int P = d.P, D = d.D, K4 = d.K4, VW4 = d.VW4, ku4 = d.ku4, vwu4 = d.vwu4;
    // 16-byte stores where the table's rows allow, whatever the op widths
    // (a narrow row reads as pieces zero past its width)
    const bool kvec = K4 % 4 == 0 && aligned(out.keyw, 16);
    const bool vvec = VW4 % 4 == 0 && aligned(out.valw, 16);
    const bool kin = ku4 % 4 == 0 && aligned(ops.dk, 16), vin = vwu4 % 4 == 0 && aligned(ops.dv, 16);
    for (int i = tid; i < nS * P; i += NT) {
        const int g = i / P, p = i - g * P;
        const int64_t s = s0 + g, q = s0 * P + i;
        const int w = m.wrow[p * G + g];
        out.used[q] = (m.ufin[g] >> p) & 1u;
        if (w == kvd::NONE) continue;
        const int32_t* kr = kvd::row_key(ops.dk, s, D, ku4, w);
        const int32_t* vr = w < D ? ops.dv + (s * D + w) * vwu4 : nullptr;
        if (kvec) {
            for (int c = 0; c < K4 / 4; ++c)
                reinterpret_cast<int4*>(out.keyw + q * K4)[c] = piece4(kr, c, ku4, kin);
        } else {
            for (int j = 0; j < K4; ++j) out.keyw[q * K4 + j] = kvw::op_word(kr, j, kr ? ku4 : 0);
        }
        if (vvec) {
            for (int c = 0; c < VW4 / 4; ++c)
                reinterpret_cast<int4*>(out.valw + q * VW4)[c] = piece4(vr, c, vwu4, vin);
        } else {
            for (int j = 0; j < VW4; ++j) out.valw[q * VW4 + j] = kvw::op_word(vr, j, vr ? vwu4 : 0);
        }
        out.klen[q] = kvd::row_klen(ops.dkl, s, D, w);
        out.ver[q] = m.wver[p * G + g];
        out.vlen[q] = kvd::row_vlen(ops.dvl, s, D, w);
    }
}

template <bool FOLD>
__global__ void __launch_bounds__(NT, 1)
kv_dict_kernel(Table in, OutTable out, Ops ops, kvd::ReadOut rd, uint8_t* overflow, Dims d,
               Decide dc) {
    extern __shared__ __align__(128) uint8_t smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * G;
    const int nS = static_cast<int>(d.S - s0 < G ? d.S - s0 : G);
    const bool reads = rd.ver != nullptr;
    const Layout L = layout(d, reads);
    const Smem m = region(smem, L);
    const int P = d.P, D = d.D;
    const int64_t n = static_cast<int64_t>(nS) * P;

    // 1. the block's inputs into shared memory, all threads, one wait; the
    // dictionary's values and value lengths (step 5 reads the written
    // slots' rows) into L2 meanwhile
    if (tid == 0) {
        prefetch_l2(ops.dv + s0 * D * d.vwu4, 4 * int64_t{nS} * D * d.vwu4);
        if (ops.dvl != nullptr) prefetch_l2(ops.dvl + s0 * D, 2 * int64_t{nS} * D);
    }
    stage_in(m.skeys, 0, in.keyw + s0 * P * d.K4, 0, 1, 4 * n * d.K4, tid, NT);
    stage_in(m.sdk, 0, ops.dk + s0 * D * d.ku4, 0, 1, 4 * int64_t{nS} * D * d.ku4, tid, NT);
    stage_in(m.sklen, 0, in.klen + s0 * P, 0, 1, 4 * n, tid, NT);
    stage_in(m.sused, 0, in.used + s0 * P, 0, 1, n, tid, NT);
    stage_in(m.ssver, 0, in.sver + s0, 0, 1, 4 * int64_t{nS}, tid, NT);
    stage_in(m.sdkl, 0, ops.dkl + s0 * D, 0, 1, 2 * int64_t{nS} * D, tid, NT);
    stage_waves(m, ops, d, s0, nS, 0, d.W < d.cw ? d.W : d.cw, tid, NT);
    if (FOLD) {
        stage_in(m.alive, 0, dc.alive + s0 * d.R, 0, 1, int64_t{nS} * d.R, tid, NT);
        stage_in(m.base, 0, dc.base + s0, 0, 1, 4 * int64_t{nS}, tid, NT);
        for (int r = tid; r < d.R; r += NT) m.v1row[r] = static_cast<int8_t>(mw::V1);
    }
    if (tid < G) m.bits[tid] = 0;
    stage_wait();
    __syncthreads();

    if (warp == NWARP) {  // 2. the copy warp: the table's slice, as it is
        const Run runs[5] = {
            {reinterpret_cast<const uint8_t*>(in.valw + s0 * P * d.VW4),
             reinterpret_cast<uint8_t*>(out.valw + s0 * P * d.VW4), 4 * n * d.VW4},
            {reinterpret_cast<const uint8_t*>(in.keyw + s0 * P * d.K4),
             reinterpret_cast<uint8_t*>(out.keyw + s0 * P * d.K4), 4 * n * d.K4},
            {reinterpret_cast<const uint8_t*>(in.klen + s0 * P),
             reinterpret_cast<uint8_t*>(out.klen + s0 * P), 4 * n},
            {reinterpret_cast<const uint8_t*>(in.ver + s0 * P),
             reinterpret_cast<uint8_t*>(out.ver + s0 * P), 4 * n},
            {reinterpret_cast<const uint8_t*>(in.vlen + s0 * P),
             reinterpret_cast<uint8_t*>(out.vlen + s0 * P), 4 * n},
        };
        if (lane == 0) ring_copy(m, runs);
        plain_copy(runs, lane);
    } else {  // 3, 4. the work warps
        // 3. classes, a warp a shard
        for (int g = warp; g < nS; g += NWARP) {
            if (d.K4 == 8) classes_warp<8>(m, d, g, lane, m.htab + warp * HT);
            else classes_warp<0>(m, d, g, lane, m.htab + warp * HT);
        }
        if (FOLD) {  // every (wave < depth, shard): did it decide V1?
            for (int i = tid; i < d.depth * nS; i += NWORK) {
                const int t = i / nS, g = i - t * nS;
                const uint8_t* a = m.alive + g * d.R;
                int n_alive = 0;
                for (int r = 0; r < d.R; ++r) n_alive += a[r] != 0;
                if (!kvd::all_v1_at_once(n_alive, dc.quorum, dc.f1, dc.max_phases) &&
                    mw::decide_v1_wave(m.v1row, a, d.R, m.base[g],
                                       dc.shard0 + static_cast<uint32_t>(s0 + g),
                                       t, dc.quorum, dc.f1, dc.seed, dc.threshold,
                                       dc.max_phases) != mw::V1)
                    m.bits[g] = kvw::FLAG_NOT_ALL_V1;
            }
        }
        bar_work();
        uint64_t used = 0;
        int32_t sver = 0;
        bool over = false;
        const bool looper = warp == 0 && lane < nS;
        if (looper) {
            used = m.ufin[lane];
            sver = m.sv[lane];
        }
        for (int t0 = 0; t0 < d.W; t0 += d.cw) {
            const int nw = d.W - t0 < d.cw ? d.W - t0 : d.cw;
            if (t0 > 0) {  // a later chunk's ranks and kinds
                stage_waves(m, ops, d, s0, nS, t0, nw, tid, NWORK);
                stage_wait();
                bar_work();
            }
            for (int i = tid; i < nw * nS; i += NWORK) {  // each wave's code
                const int tl = i / nS, g = i - tl * nS;
                const int r = m.sidx[tl * G + g] < D ? m.sidx[tl * G + g] : D;
                const int32_t kl = m.rkl[g * class_stride(d) + r];
                const int k = ops.kind != nullptr ? m.skind[tl * G + g]
                                                  : kvw::implied_kind(d.kind_all, kl);
                m.code[tl * G + g] =
                    wave_code(m.cls[g * class_stride(d) + r], r, k, t0 + tl < d.depth, kl);
            }
            bar_work();
            if (looper) {  // 4a. lane g runs shard g's waves
                if (reads) run_waves<true>(m, lane, nw, used, sver, over);
                else run_waves<false>(m, lane, nw, used, sver, over);
            }
            bar_work();
            if (reads) stream_reads(m, in, ops, rd, d, s0, nS, t0, nw, tid);
        }
        if (looper) {
            const int64_t s = s0 + lane;
            m.ufin[lane] = used;
            overflow[s] = over;
            out.sver[s] = sver;
            m.bits[lane] |= kvw::shard_flags(true, over, sver);
        }
    }
    __syncthreads();

    // 5. the written slots over the copy, and the used flags
    patch_written(m, ops, out, d, s0, nS, tid);

    // the flags: the block's bits, then the last block writes them
    if (!FOLD) return;
    if (tid == 0) {
        uint32_t bits = 0;
        for (int g = 0; g < nS; ++g) bits |= m.bits[g];
        if (bits != 0) atomicOr(dc.scratch + 1, bits);
        __threadfence();
        if (atomicAdd(dc.scratch, 1u) == gridDim.x - 1) {
            __threadfence();
            kvw::window_flags(atomicExch(dc.scratch + 1, 0u), dc.flags);
            atomicExch(dc.scratch, 0u);
        }
    }
}

template <bool FOLD>
int launch(Table in, OutTable out, Ops ops, kvd::ReadOut rd, uint8_t* overflow, Dims d,
           Decide dc, cudaStream_t stream) {
    const bool reads = rd.ver != nullptr;
    d.cw = d.W < MAX_CHUNK ? (d.W > 0 ? d.W : 1) : MAX_CHUNK;
    while (d.cw > 1 && layout(d, reads).total > MAX_SMEM) d.cw /= 2;
    const int64_t bytes = layout(d, reads).total;
    if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = kv_dict_kernel<FOLD>;
    // the shared-memory limit, set once a device for this instantiation
    static std::mutex mu;
    static uint64_t set_on = 0;  // bit i: set on device i (i < 64)
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaGetLastError());
    {
        std::lock_guard<std::mutex> lock(mu);
        const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
        if (!(set_on & bit)) {
            if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(MAX_SMEM)) != cudaSuccess) {
                return static_cast<int>(cudaGetLastError());
            }
            set_on |= bit;
        }
    }
    const int64_t blocks = (d.S + G - 1) / G;
    kv_dict_kernel<FOLD><<<static_cast<unsigned>(blocks), NT, static_cast<size_t>(bytes),
                           stream>>>(in, out, ops, rd, overflow, d, dc);
    return static_cast<int>(cudaGetLastError());
}

// The arguments of both entries, unpacked and checked; 0 or a cudaError.
int unpack(void* const* table, void* const* outp, void* const* opsp, void* const* reads,
           const long long* dims, Table& in, OutTable& o, Ops& op, kvd::ReadOut& rd,
           uint8_t*& overflow, Dims& d) {
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
    d.R = 0;
    d.cw = 1;
    bool has_out = true;
    for (int i = 0; i < 7; ++i) has_out = has_out && outp[i] != nullptr && table[i] != nullptr;
    rd = kvd::ReadOut{static_cast<int32_t*>(reads[2]), static_cast<int32_t*>(reads[3]),
                      static_cast<int32_t*>(reads[4]), static_cast<const int32_t*>(reads[5]),
                      static_cast<int>(dims[10])};
    overflow = static_cast<uint8_t*>(reads[0]);
    const bool reads_ok = reads[1] == nullptr &&
                          (rd.ver == nullptr || (rd.vlen != nullptr && rd.val != nullptr &&
                                                 rd.gidx != nullptr && rd.G >= 0));
    if (!has_out || overflow == nullptr || !reads_ok || d.S < 0 || d.W < 0 || d.P < 1 ||
        d.P > 64 || d.K4 < 1 || d.VW4 < 1 || d.ku4 < 0 || d.ku4 > d.K4 || d.vwu4 < 0 ||
        d.vwu4 > d.VW4 || d.depth < 0 || d.depth > d.W || d.D < 0 || d.D > MAX_D ||
        (d.kind_all != kvw::KIND_SET && d.kind_all != kvw::KIND_GET) || opsp[1] == nullptr ||
        opsp[3] == nullptr || opsp[5] == nullptr || (opsp[4] == nullptr && d.vwu4 != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    in = Table{static_cast<const uint8_t*>(table[0]), static_cast<const int32_t*>(table[1]),
               static_cast<const int32_t*>(table[2]), static_cast<const int32_t*>(table[3]),
               static_cast<const int32_t*>(table[4]), static_cast<const int32_t*>(table[5]),
               static_cast<const int32_t*>(table[6])};
    o = OutTable{static_cast<uint8_t*>(outp[0]), static_cast<int32_t*>(outp[1]),
                 static_cast<int32_t*>(outp[2]), static_cast<int32_t*>(outp[3]),
                 static_cast<int32_t*>(outp[4]), static_cast<int32_t*>(outp[5]),
                 static_cast<int32_t*>(outp[6])};
    op = Ops{static_cast<const int8_t*>(opsp[0]), static_cast<const int16_t*>(opsp[1]),
             static_cast<const int16_t*>(opsp[2]), static_cast<const int32_t*>(opsp[3]),
             static_cast<const int32_t*>(opsp[4]), static_cast<const uint8_t*>(opsp[5])};
    return 0;
}

}  // namespace

// The same arguments as kv_window.cu's kvw_window, for dictionary-form ops
// (idx u8[W,S] required) and tables of at most 64 slots: table/out 7
// pointers each (used u8[S,P], keyw i32[S,P,K4], klen, ver i32[S,P], valw
// i32[S,P,VW4], vlen i32[S,P], sver i32[S]); ops: kind i8[W,S] or null,
// dkl i16[S,D], dvl i16[S,D] or null, dk i32[S,D,ku4], dv i32[S,D,vwu4]
// or null with vwu4 0, idx; reads: overflow u8[S], then null (kv_read.cu's
// found plane), the two planes of meta i32[2,G,S], gval i32[G,S,VW4] and
// gidx i32[G] (see kvd::ReadOut; the four null: no reads); dims: S, W,
// depth, P, K4, VW4, ku4, vwu4, D, kind_all, G. All contiguous. Launches
// on `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int kvd_window(void* const* table, void* const* out, void* const* ops,
                          void* const* reads, const long long* dims, void* stream) {
    Table in;
    OutTable o;
    Ops op;
    kvd::ReadOut rd;
    uint8_t* overflow;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, o, op, rd, overflow, d)) return err;
    if (d.S == 0) return 0;
    return launch<false>(in, o, op, rd, overflow, d, Decide{}, static_cast<cudaStream_t>(stream));
}

// kvd_window, plus the window's decision in the same launch: decide and
// params as kv_window.cu's kvw_decide_window.
extern "C" int kvd_decide_window(void* const* table, void* const* out, void* const* ops,
                                 void* const* reads, const long long* dims,
                                 void* const* decide, const long long* params, void* stream) {
    Table in;
    OutTable o;
    Ops op;
    kvd::ReadOut rd;
    uint8_t* overflow;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, o, op, rd, overflow, d)) return err;
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
    return launch<true>(in, o, op, rd, overflow, d, dc, static_cast<cudaStream_t>(stream));
}
