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
// state from `in` to `out` (which may be `in`) and step k's outbox at
// [k * S + s]. MASK: the ledgers as MaskRow (R <= 64), else ByteRow on
// the out rows.
template <bool MASK>
NK_HD void cycle_shard(const Ptrs& in, const Ptrs& out, const OutPtrs& ob, const Inputs& ip,
                       int64_t S, int K, int64_t s, const Params& p) {
    const int R = p.R;
    Shard x = load_shard(in, s);
    const int8_t* ib1 = ip.ib1 != nullptr ? ip.ib1 + s * R : nullptr;
    const int8_t* ib2 = ip.ib2 != nullptr ? ip.ib2 + s * R : nullptr;
    const int dec = ip.dec != nullptr ? ip.dec[s] : ABSENT;
    const bool open = ip.mask != nullptr && ip.mask[s] != 0;
    const uint32_t shard = static_cast<uint32_t>(s);
    if constexpr (MASK) {
        MaskRow l1, l2;
        l1.load(in.led1 + s * R, R);
        l2.load(in.led2 + s * R, R);
        if (open) start(x, l1, l2, ip.slot_index[s], ip.init[s], p);
        for (int k = 0; k < K; ++k) {
            const bool first = k == 0;
            store_out(ob, k * S + s, step(x, l1, l2, first ? ib1 : nullptr,
                                          first ? ib2 : nullptr, first ? dec : ABSENT, shard, p));
        }
        l1.store(out.led1 + s * R, R);
        l2.store(out.led2 + s * R, R);
    } else {
        ByteRow l1{out.led1 + s * R}, l2{out.led2 + s * R};
        for (int r = 0; r < R && out.led1 != in.led1; ++r) l1.row[r] = in.led1[s * R + r];
        for (int r = 0; r < R && out.led2 != in.led2; ++r) l2.row[r] = in.led2[s * R + r];
        if (open) start(x, l1, l2, ip.slot_index[s], ip.init[s], p);
        for (int k = 0; k < K; ++k) {
            const bool first = k == 0;
            store_out(ob, k * S + s, step(x, l1, l2, first ? ib1 : nullptr,
                                          first ? ib2 : nullptr, first ? dec : ABSENT, shard, p));
        }
    }
    store_shard(out, s, x);
}

}  // namespace nk
