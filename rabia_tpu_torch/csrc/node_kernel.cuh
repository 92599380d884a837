// Per-shard math of one node's weak-MVC kernel (NodeKernel's
// start_slots, node_step and node_cycle), shared by the CUDA kernel
// (node_kernel.cu) and a plain host build (g++) that the CPU tests check
// against the reference's NodeKernel.
//
// One node sees S shards; shard s holds a slot, a phase, a stage
// (R1_WAIT / R2_WAIT), its own round-1 and round-2 votes, the decision,
// done and active flags, and two ledgers of R votes (led1, led2: the
// votes of each sender for the current (slot, phase)). A step, as
// NodeKernel._node_step_math computes it:
//  1. the inboxes fill the ABSENT ledger entries;
//  2. an enabled shard (active, not done) in R1_WAIT with a quorum of
//     round-1 votes casts V1 / V0 on a quorum of V1 / V0, else V?, enters
//     R2_WAIT and writes its vote into its own cell of led2;
//  3. an enabled shard that was in R2_WAIT BEFORE the step (so a shard
//     never casts and advances in one step) with a quorum of round-2
//     votes decides at f+1 equal non-? votes, else takes a non-? vote,
//     else the common coin of (seed, shard, slot, phase), and advances a
//     phase: its own round-1 vote is that value, led1 holds only it,
//     led2 and its round-2 vote go ABSENT;
//  4. an enabled shard that did not decide adopts decision_in where it
//     is not ABSENT; deciding or adopting sets done.
// The outbox of a step: cast_r2, the round-2 vote as it stood before an
// advance reset it (r2_vals), advanced, the new round-1 vote, the new
// phase, newly_decided and the decision.
//
// Ledger values and votes are protocol codes (V0=0, V1=1, V?=2,
// ABSENT=3); stages 0 and 1; flags 0 and 1. Slot and phase are int32 in
// the tensors and wrap as two's complement: here they are uint32.
//
// Two forms of a ledger row with one interface: MaskRow keeps R <= 64
// votes as two bit planes in registers (bit r of lo / hi is bit 0 / 1 of
// sender r's code, so ABSENT is lo & hi); ByteRow works on the row in
// memory, for any R.
#pragma once

#include <stdint.h>

#include "mesh_window.cuh"

#if defined(__CUDACC__)
#define NK_HD __host__ __device__ __forceinline__
#else
#define NK_HD inline
#endif

namespace nk {

constexpr int V0 = 0, V1 = 1, VQUESTION = 2, ABSENT = 3;
constexpr int R1_WAIT = 0, R2_WAIT = 1;
constexpr int MASK_REPLICAS = 64;  // MaskRow: one bit a sender in a uint64_t

struct Tally {
    int c0, c1, cq;
};

NK_HD int popc64(uint64_t x) { return mw::popc64(x); }

// R <= 64 votes as two bit planes.
struct MaskRow {
    uint64_t lo, hi, all;  // all: the R senders' bits

    NK_HD void load(const int8_t* row, int R) {
        all = R >= 64 ? ~uint64_t{0} : (uint64_t{1} << R) - 1;
        lo = hi = 0;
        for (int r = 0; r < R; ++r) {
            const uint64_t bit = uint64_t{1} << r;
            const int v = row[r];
            lo |= (v & 1) ? bit : 0;
            hi |= (v & 2) ? bit : 0;
        }
    }
    NK_HD void store(int8_t* row, int R) const {
        for (int r = 0; r < R; ++r) {
            row[r] = static_cast<int8_t>(((lo >> r) & 1) | (((hi >> r) & 1) << 1));
        }
    }
    // ABSENT entries take the inbox's present votes.
    NK_HD void merge(const int8_t* in, int R) {
        MaskRow x;
        x.load(in, R);
        const uint64_t take = lo & hi & ~(x.lo & x.hi);
        lo = (lo & ~take) | (x.lo & take);
        hi = (hi & ~take) | (x.hi & take);
    }
    NK_HD Tally tally() const {
        return {popc64(~lo & ~hi & all), popc64(lo & ~hi), popc64(~lo & hi & all)};
    }
    NK_HD void set(int r, int v, int R) {
        if (r < 0 || r >= R) return;
        const uint64_t bit = uint64_t{1} << r;
        lo = (v & 1) ? lo | bit : lo & ~bit;
        hi = (v & 2) ? hi | bit : hi & ~bit;
    }
    NK_HD void clear() { lo = hi = all; }
};

// A row of any R votes, read and written in place at `row`.
struct ByteRow {
    int8_t* row;

    NK_HD void merge(const int8_t* in, int R) {
        for (int r = 0; r < R; ++r) {
            if (row[r] == ABSENT && in[r] != ABSENT) row[r] = in[r];
        }
    }
    NK_HD Tally tally(int R) const {
        Tally t{0, 0, 0};
        for (int r = 0; r < R; ++r) {
            t.c0 += row[r] == V0;
            t.c1 += row[r] == V1;
            t.cq += row[r] == VQUESTION;
        }
        return t;
    }
    NK_HD void set(int r, int v, int R) {
        if (r >= 0 && r < R) row[r] = static_cast<int8_t>(v);
    }
    NK_HD void clear(int R) {
        for (int r = 0; r < R; ++r) row[r] = ABSENT;
    }
};

NK_HD Tally tally_of(const MaskRow& m, int) { return m.tally(); }
NK_HD Tally tally_of(const ByteRow& b, int R) { return b.tally(R); }
NK_HD void clear_row(MaskRow& m, int) { m.clear(); }
NK_HD void clear_row(ByteRow& b, int R) { b.clear(R); }

// One shard's scalar state (the ledgers are rows beside it).
struct Shard {
    uint32_t slot, phase;
    int stage, my_r1, my_r2, decided;
    bool done, active;
};

// What one step emits for a shard.
struct Out {
    bool cast_r2, advanced, newly_decided;
    int r2_val, new_r1, decided;
    uint32_t new_phase;
};

struct Params {
    int R, me, quorum, f1;
    uint32_t seed, threshold;
};

// start_slots on a masked shard: slot `slot_index`, phase 0, R1_WAIT,
// the initial vote as its round-1 vote and its own led1 cell.
template <class Row>
NK_HD void start(Shard& x, Row& l1, Row& l2, int32_t slot_index, int init, const Params& p) {
    x.slot = static_cast<uint32_t>(slot_index);
    x.phase = 0;
    x.stage = R1_WAIT;
    x.my_r1 = init;
    x.my_r2 = ABSENT;
    clear_row(l1, p.R);
    l1.set(p.me, init, p.R);
    clear_row(l2, p.R);
    x.decided = ABSENT;
    x.done = false;
    x.active = true;
}

// One node_step of shard `shard`; ib1 / ib2 null for ABSENT inboxes.
template <class Row>
NK_HD Out step(Shard& x, Row& l1, Row& l2, const int8_t* ib1, const int8_t* ib2, int dec_in,
               uint32_t shard, const Params& p) {
    if (ib1 != nullptr) l1.merge(ib1, p.R);
    if (ib2 != nullptr) l2.merge(ib2, p.R);
    const bool enabled = x.active && !x.done;
    const int stage0 = x.stage;

    const Tally t1 = tally_of(l1, p.R);
    Out o;
    o.cast_r2 = enabled && stage0 == R1_WAIT && t1.c0 + t1.c1 + t1.cq >= p.quorum;
    if (o.cast_r2) {
        x.my_r2 = t1.c1 >= p.quorum ? V1 : (t1.c0 >= p.quorum ? V0 : VQUESTION);
        x.stage = R2_WAIT;
        l2.set(p.me, x.my_r2, p.R);
    }

    const Tally t2 = tally_of(l2, p.R);
    o.advanced = enabled && stage0 == R2_WAIT && t2.c0 + t2.c1 + t2.cq >= p.quorum;
    const bool decide1 = t2.c1 >= p.f1, decide0 = t2.c0 >= p.f1;
    o.newly_decided = o.advanced && (decide1 || decide0);
    const bool adopt = enabled && !o.newly_decided && dec_in != ABSENT;
    if (o.newly_decided) {
        x.decided = decide1 ? V1 : V0;
    } else if (adopt) {
        x.decided = dec_in;
    }
    x.done = x.done || o.newly_decided || adopt;

    o.r2_val = x.my_r2;
    if (o.advanced) {
        int next;
        if (decide1) {
            next = V1;
        } else if (decide0) {
            next = V0;
        } else if (t2.c1 > 0) {
            next = V1;
        } else if (t2.c0 > 0) {
            next = V0;
        } else {
            next = mw::coin(mw::coin_prefix(p.seed, shard, x.slot), x.phase, p.threshold);
        }
        x.phase += 1u;
        x.my_r1 = next;
        x.stage = R1_WAIT;
        x.my_r2 = ABSENT;
        clear_row(l1, p.R);
        l1.set(p.me, next, p.R);
        clear_row(l2, p.R);
    }
    o.new_r1 = x.my_r1;
    o.new_phase = x.phase;
    o.decided = x.decided;
    return o;
}

// The state tensors of a NodeState (field order of the reference's
// NodeState), each [S] or [S, R] for the ledgers, contiguous.
struct Ptrs {
    int32_t* slot;
    int32_t* phase;
    int8_t* stage;
    int8_t* my_r1;
    int8_t* my_r2;
    int8_t* led1;
    int8_t* led2;
    int8_t* decided;
    uint8_t* done;
    uint8_t* active;
};

// The outbox planes of a NodeOutbox, each [K, S], contiguous.
struct OutPtrs {
    uint8_t* cast_r2;
    int8_t* r2_vals;
    uint8_t* advanced;
    int8_t* new_r1;
    int32_t* new_phase;
    uint8_t* newly_decided;
    int8_t* decided_vals;
};

// The tick's inputs: the open planes (mask null: no start) and the
// inboxes of the first step ([S, R], [S, R], [S]).
struct Inputs {
    const uint8_t* mask;
    const int32_t* slot_index;
    const int8_t* init;
    const int8_t* ib1;
    const int8_t* ib2;
    const int8_t* dec;
};

NK_HD Shard load_shard(const Ptrs& p, int64_t s) {
    Shard x;
    x.slot = static_cast<uint32_t>(p.slot[s]);
    x.phase = static_cast<uint32_t>(p.phase[s]);
    x.stage = p.stage[s];
    x.my_r1 = p.my_r1[s];
    x.my_r2 = p.my_r2[s];
    x.decided = p.decided[s];
    x.done = p.done[s] != 0;
    x.active = p.active[s] != 0;
    return x;
}

NK_HD void store_shard(const Ptrs& p, int64_t s, const Shard& x) {
    p.slot[s] = static_cast<int32_t>(x.slot);
    p.phase[s] = static_cast<int32_t>(x.phase);
    p.stage[s] = static_cast<int8_t>(x.stage);
    p.my_r1[s] = static_cast<int8_t>(x.my_r1);
    p.my_r2[s] = static_cast<int8_t>(x.my_r2);
    p.decided[s] = static_cast<int8_t>(x.decided);
    p.done[s] = x.done ? 1 : 0;
    p.active[s] = x.active ? 1 : 0;
}

NK_HD void store_out(const OutPtrs& ob, int64_t i, const Out& o) {
    ob.cast_r2[i] = o.cast_r2 ? 1 : 0;
    ob.r2_vals[i] = static_cast<int8_t>(o.r2_val);
    ob.advanced[i] = o.advanced ? 1 : 0;
    ob.new_r1[i] = static_cast<int8_t>(o.new_r1);
    ob.new_phase[i] = static_cast<int32_t>(o.new_phase);
    ob.newly_decided[i] = o.newly_decided ? 1 : 0;
    ob.decided_vals[i] = static_cast<int8_t>(o.decided);
}

// node_cycle for shard s: start where the mask says, then K chained
// steps (the inboxes feed the first; ABSENT pads the later ones), the
// state from `in` to `out` (which may be `in`). The tick's inputs are
// read at index i and step k's outbox written at [k * ob_stride + i]:
// i = s and ob_stride = S on the tick's own planes, or a block's tile
// (node_kernel.cu: i = s - s0, ob_stride the tile's width). MASK: the
// ledgers as MaskRow (R <= 64), else ByteRow on the out rows. Returns the
// shard's new scalar state (also stored to `out`).
template <bool MASK>
NK_HD Shard cycle_shard_at(const Ptrs& in, const Ptrs& out, const OutPtrs& ob, int64_t ob_stride,
                           const Inputs& ip, int64_t i, int K, int64_t s, const Params& p) {
    const int R = p.R;
    Shard x = load_shard(in, s);
    const int8_t* ib1 = ip.ib1 != nullptr ? ip.ib1 + i * R : nullptr;
    const int8_t* ib2 = ip.ib2 != nullptr ? ip.ib2 + i * R : nullptr;
    const int dec = ip.dec != nullptr ? ip.dec[i] : ABSENT;
    const bool open = ip.mask != nullptr && ip.mask[i] != 0;
    const uint32_t shard = static_cast<uint32_t>(s);
    if constexpr (MASK) {
        MaskRow l1, l2;
        l1.load(in.led1 + s * R, R);
        l2.load(in.led2 + s * R, R);
        if (open) start(x, l1, l2, ip.slot_index[i], ip.init[i], p);
        for (int k = 0; k < K; ++k) {
            const bool first = k == 0;
            store_out(ob, k * ob_stride + i, step(x, l1, l2, first ? ib1 : nullptr,
                                                  first ? ib2 : nullptr, first ? dec : ABSENT,
                                                  shard, p));
        }
        l1.store(out.led1 + s * R, R);
        l2.store(out.led2 + s * R, R);
    } else {
        ByteRow l1{out.led1 + s * R}, l2{out.led2 + s * R};
        for (int r = 0; r < R && out.led1 != in.led1; ++r) l1.row[r] = in.led1[s * R + r];
        for (int r = 0; r < R && out.led2 != in.led2; ++r) l2.row[r] = in.led2[s * R + r];
        if (open) start(x, l1, l2, ip.slot_index[i], ip.init[i], p);
        for (int k = 0; k < K; ++k) {
            const bool first = k == 0;
            store_out(ob, k * ob_stride + i, step(x, l1, l2, first ? ib1 : nullptr,
                                                  first ? ib2 : nullptr, first ? dec : ABSENT,
                                                  shard, p));
        }
    }
    store_shard(out, s, x);
    return x;
}

// cycle_shard_at on the tick's own planes: inputs at s, outbox at k * S + s.
template <bool MASK>
NK_HD void cycle_shard(const Ptrs& in, const Ptrs& out, const OutPtrs& ob, const Inputs& ip,
                       int64_t S, int K, int64_t s, const Params& p) {
    cycle_shard_at<MASK>(in, out, ob, S, ip, s, K, s, p);
}

// ---- a block's tile (node_kernel.cu) --------------------------------------
//
// The kernel reads the tick's planes from pinned host memory and writes
// the host image there, over the link, where a per-thread byte access is
// a transaction of its own. So a block of T shards works on a tile in
// shared memory, in three phases with a barrier between them:
//  1. stage_in: the block's runs of the six planes (T rows of each) move
//     into the tile as 16-byte loads, each thread issuing a batch of its
//     loads before it stores any;
//  2. cycle_tile: thread i runs shard s0 + i (cycle_shard_at on the tile)
//     and leaves its outbox rows and mirrored fields in the tile;
//  3. put_out: the tile's outbox rows go to the device outbox (when
//     given) and with the mirrored fields to the host image, a warp a
//     run, as 16-byte stores where source and destination agree modulo
//     16 bytes, else byte by byte.
// Each function takes the thread (tid of nthreads) explicitly, so a host
// build runs a block as a loop over its threads, phase by phase.

#if defined(__CUDACC__)
using Chunk = uint4;
#else
struct alignas(16) Chunk {
    uint32_t x, y, z, w;
};
#endif

constexpr int IN_RUNS = 6;    // mask, slot_index, init, ib1, ib2, dec
constexpr int MIRROR = 8;     // the state fields the host mirrors: all but the ledgers
constexpr int OUT_PLANES = 7;  // NodeOutbox's planes
constexpr int HELD = 4;       // 16-byte loads a thread holds before it stores them

NK_HD uintptr_t addr_of(const void* p) { return reinterpret_cast<uintptr_t>(p); }
// A run's first byte from its 16-byte boundary.
NK_HD int landing(const void* p) { return static_cast<int>(addr_of(p) & 15); }
// The aligned 16-byte chunks that cover n bytes at p (a chunk that holds
// one byte of an allocation lies in its page, so reading all of it is safe).
NK_HD int chunks_of(const void* p, int64_t n) {
    return n > 0 ? static_cast<int>((landing(p) + n + 15) / 16) : 0;
}

// Bytes a shard has in input run r (the Inputs' order).
NK_HD int in_width(int r, int R) { return r == 1 ? 4 : (r == 3 || r == 4) ? R : 1; }
NK_HD const uint8_t* in_plane(const Inputs& g, int r) {
    switch (r) {
        case 0: return g.mask;
        case 1: return reinterpret_cast<const uint8_t*>(g.slot_index);
        case 2: return reinterpret_cast<const uint8_t*>(g.init);
        case 3: return reinterpret_cast<const uint8_t*>(g.ib1);
        case 4: return reinterpret_cast<const uint8_t*>(g.ib2);
        default: return reinterpret_cast<const uint8_t*>(g.dec);
    }
}
// Outbox plane f (NodeOutbox's order): its bytes and width.
NK_HD uint8_t* out_plane(const OutPtrs& o, int f) {
    switch (f) {
        case 0: return o.cast_r2;
        case 1: return reinterpret_cast<uint8_t*>(o.r2_vals);
        case 2: return o.advanced;
        case 3: return reinterpret_cast<uint8_t*>(o.new_r1);
        case 4: return reinterpret_cast<uint8_t*>(o.new_phase);
        case 5: return o.newly_decided;
        default: return reinterpret_cast<uint8_t*>(o.decided_vals);
    }
}
NK_HD int out_width(int f) { return f == 4 ? 4 : 1; }
// Mirrored field f: slot, phase, stage, my_r1, my_r2, decided, done, active.
NK_HD uint8_t* mirror_field(const Ptrs& p, int f) {
    switch (f) {
        case 0: return reinterpret_cast<uint8_t*>(p.slot);
        case 1: return reinterpret_cast<uint8_t*>(p.phase);
        case 2: return reinterpret_cast<uint8_t*>(p.stage);
        case 3: return reinterpret_cast<uint8_t*>(p.my_r1);
        case 4: return reinterpret_cast<uint8_t*>(p.my_r2);
        case 5: return reinterpret_cast<uint8_t*>(p.decided);
        case 6: return p.done;
        default: return p.active;
    }
}
NK_HD int mirror_width(int f) { return f < 2 ? 4 : 1; }

// A tile of T shards (T a multiple of 16): six input regions of T * width
// + 16 bytes (a run lands at its landing), the outbox planes [K][T] and
// the mirrored fields [T], each at a 16-byte boundary.
struct Tile {
    uint8_t* in[IN_RUNS];
    OutPtrs ob;
    Ptrs st;  // the mirrored fields; the ledgers null
};

NK_HD int64_t tile_bytes(int T, int R, int K) {
    int64_t n = 0;
    for (int r = 0; r < IN_RUNS; ++r) n += (static_cast<int64_t>(T) * in_width(r, R) + 31) / 16 * 16;
    for (int f = 0; f < OUT_PLANES; ++f) n += static_cast<int64_t>(K) * T * out_width(f);
    for (int f = 0; f < MIRROR; ++f) n += static_cast<int64_t>(T) * mirror_width(f);
    return n;
}

NK_HD Tile carve(uint8_t* smem, int T, int R, int K) {
    Tile t;
    uint8_t* at = smem;
    for (int r = 0; r < IN_RUNS; ++r) {
        t.in[r] = at;
        at += (static_cast<int64_t>(T) * in_width(r, R) + 31) / 16 * 16;
    }
    uint8_t* ob[OUT_PLANES];
    for (int f = 0; f < OUT_PLANES; ++f) {
        ob[f] = at;
        at += static_cast<int64_t>(K) * T * out_width(f);
    }
    t.ob.cast_r2 = ob[0];
    t.ob.r2_vals = reinterpret_cast<int8_t*>(ob[1]);
    t.ob.advanced = ob[2];
    t.ob.new_r1 = reinterpret_cast<int8_t*>(ob[3]);
    t.ob.new_phase = reinterpret_cast<int32_t*>(ob[4]);
    t.ob.newly_decided = ob[5];
    t.ob.decided_vals = reinterpret_cast<int8_t*>(ob[6]);
    uint8_t* st[MIRROR];
    for (int f = 0; f < MIRROR; ++f) {
        st[f] = at;
        at += static_cast<int64_t>(T) * mirror_width(f);
    }
    t.st.slot = reinterpret_cast<int32_t*>(st[0]);
    t.st.phase = reinterpret_cast<int32_t*>(st[1]);
    t.st.stage = reinterpret_cast<int8_t*>(st[2]);
    t.st.my_r1 = reinterpret_cast<int8_t*>(st[3]);
    t.st.my_r2 = reinterpret_cast<int8_t*>(st[4]);
    t.st.decided = reinterpret_cast<int8_t*>(st[5]);
    t.st.done = st[6];
    t.st.active = st[7];
    t.st.led1 = t.st.led2 = nullptr;
    return t;
}

// Where the block's first shard s0 has its bytes in input run r (null
// when the tick has no such plane).
NK_HD const uint8_t* run_src(const Inputs& g, int r, int64_t s0, int R) {
    const uint8_t* p = in_plane(g, r);
    return p == nullptr ? nullptr : p + s0 * in_width(r, R);
}

// The tile's inputs as cycle_shard_at reads them (index s - s0).
NK_HD Inputs tile_inputs(const Tile& t, const Inputs& g, int64_t s0, int R) {
    const uint8_t* at[IN_RUNS];
    for (int r = 0; r < IN_RUNS; ++r) {
        const uint8_t* src = run_src(g, r, s0, R);
        at[r] = src == nullptr ? nullptr : t.in[r] + landing(src);
    }
    return {at[0], reinterpret_cast<const int32_t*>(at[1]), reinterpret_cast<const int8_t*>(at[2]),
            reinterpret_cast<const int8_t*>(at[3]), reinterpret_cast<const int8_t*>(at[4]),
            reinterpret_cast<const int8_t*>(at[5])};
}

// Phase 1: thread tid's 16-byte loads of the n shards' runs from s0
// into the tile; a batch of HELD loads is issued before any is stored.
NK_HD void stage_in(const Tile& t, const Inputs& g, int64_t s0, int n, int R, int tid,
                    int nthreads) {
    const uint8_t* src[IN_RUNS];
    int first[IN_RUNS + 1];
    first[0] = 0;
    for (int r = 0; r < IN_RUNS; ++r) {
        src[r] = run_src(g, r, s0, R);
        first[r + 1] = first[r] + (src[r] == nullptr ? 0 : chunks_of(src[r], int64_t{n} * in_width(r, R)));
    }
    const int total = first[IN_RUNS];
    for (int c0 = tid; c0 < total; c0 += HELD * nthreads) {
        Chunk v[HELD];
        int run[HELD];
#pragma unroll
        for (int j = 0; j < HELD; ++j) {
            const int c = c0 + j * nthreads;
            run[j] = 0;
            while (run[j] + 1 < IN_RUNS && c >= first[run[j] + 1]) ++run[j];
            if (c < total) {
                const uintptr_t base = addr_of(src[run[j]]) & ~uintptr_t{15};
                v[j] = reinterpret_cast<const Chunk*>(base)[c - first[run[j]]];
            }
        }
#pragma unroll
        for (int j = 0; j < HELD; ++j) {
            const int c = c0 + j * nthreads;
            if (c < total) reinterpret_cast<Chunk*>(t.in[run[j]])[c - first[run[j]]] = v[j];
        }
    }
}

// Phase 2: shard s0 + i of the tile, its outbox rows and mirrored fields
// left in the tile.
template <bool MASK>
NK_HD void cycle_tile(const Ptrs& in, const Ptrs& out, const Tile& t, const Inputs& tin, int T,
                      int K, int64_t s0, int i, const Params& p) {
    store_shard(t.st, i, cycle_shard_at<MASK>(in, out, t.ob, T, tin, i, K, s0 + i, p));
}

// n bytes from src to dst by `width` lanes: 16-byte stores between the
// unaligned head and tail when src and dst agree modulo 16, else bytes.
NK_HD void put_run(uint8_t* dst, const uint8_t* src, int n, int lane, int width) {
    if (((addr_of(dst) ^ addr_of(src)) & 15) != 0) {
        for (int j = lane; j < n; j += width) dst[j] = src[j];
        return;
    }
    const int lead = (16 - landing(dst)) & 15;
    const int head = lead < n ? lead : n;
    const int body = (n - head) / 16;
    for (int j = lane; j < head; j += width) dst[j] = src[j];
    Chunk* d = reinterpret_cast<Chunk*>(dst + head);
    const Chunk* s = reinterpret_cast<const Chunk*>(src + head);
    for (int c = lane; c < body; c += width) d[c] = s[c];
    for (int j = head + 16 * body + lane; j < n; j += width) dst[j] = src[j];
}

// Phase 3: the n shards' outputs from the tile, a warp a run: the outbox
// rows to `ob` (the device's outbox; skipped when null) and to `iob`, and
// the mirrored fields to `img` (the host image; skipped when null).
NK_HD void put_out(const Tile& t, const OutPtrs& ob, const Ptrs& img, const OutPtrs& iob,
                   int64_t S, int64_t s0, int n, int T, int K, int tid, int nthreads) {
    const int rows = OUT_PLANES * K;
    const int runs = 2 * rows + MIRROR;
    const int warps = (nthreads + 31) / 32;
    const int lanes = nthreads - tid / 32 * 32 < 32 ? nthreads - tid / 32 * 32 : 32;
    for (int r = tid / 32; r < runs; r += warps) {
        uint8_t* dst;
        const uint8_t* src;
        int w;
        if (r < 2 * rows) {
            const int f = (r % rows) / K, k = r % K;
            w = out_width(f);
            uint8_t* plane = out_plane(r < rows ? ob : iob, f);
            dst = plane == nullptr ? nullptr : plane + (k * S + s0) * w;
            src = out_plane(t.ob, f) + static_cast<int64_t>(k) * T * w;
        } else {
            const int f = r - 2 * rows;
            w = mirror_width(f);
            uint8_t* field = mirror_field(img, f);
            dst = field == nullptr ? nullptr : field + s0 * w;
            src = mirror_field(t.st, f);
        }
        if (dst != nullptr) put_run(dst, src, n * w, tid % 32, lanes);
    }
}

}  // namespace nk
