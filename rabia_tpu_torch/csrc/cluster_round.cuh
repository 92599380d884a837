// Per-shard math of the scanned weak-MVC protocol (ClusterKernel's
// round_step, chained over rounds and slots), shared by the CUDA kernels
// (cluster_round.cu) and a plain host build (g++) that the CPU tests
// check against the reference's round_step and slot_pipeline: the round
// that cr_rounds runs, and at the bottom the rule that slot_pipeline's
// full-delivery rounds of a fresh slot collapse to.
//
// One shard's R replicas live in registers: per-replica phases as int32,
// everything else as bitmasks over replicas (bit r = replica r). A vote
// code (V0=0, V1=1, V?=2, ABSENT=3) is kept as two planes, lo = bit 0 and
// hi = bit 1 of the code, so ABSENT is lo & hi. The ledgers are such
// planes per receiver over its senders (led[receiver] bit sender), as the
// tensors' [shard, receiver, sender] layout is. Values of the state
// tensors are protocol values: vote codes 0..3, stages 0 (R1_WAIT) and 1
// (R2_WAIT), booleans 0 and 1.
//
// One round, as ClusterKernel.round_step computes it for every shard:
//  1. delivery: sender i reaches receiver j when deliver[i][j], both are
//     alive, i != j and j has not decided; it offers its current-phase
//     votes when their phases agree (its round-2 vote only in R2_WAIT),
//     its previous-phase votes when it is one phase ahead; an offer fills
//     an ABSENT ledger entry;
//  2. transitions of the live, undecided replicas of an active shard, on
//     the stages from before the step: in R1_WAIT with a quorum of
//     round-1 votes, cast V1 / V0 on a quorum of V1 / V0, else V?; in
//     R2_WAIT with a quorum of round-2 votes, decide at f+1 equal non-?
//     votes, else adopt a non-? vote, else take the common coin of (seed,
//     shard, slot, phase), and advance a phase; the shard's decision is
//     the largest of the round's new decisions, its decided phase the
//     least phase of any decider;
//  3. propagation: an undecided live replica of an active, decided shard
//     that a decided live sender reaches under raw deliver learns it.
#pragma once

#include <stdint.h>
#include <string.h>

#include "fused_window.cuh"
#include "mesh_window.cuh"

#if defined(__CUDACC__)
#define CR_HD __host__ __device__ __forceinline__
#define CR_PRAGMA(x) _Pragma(#x)
#else
#define CR_HD inline
#define CR_PRAGMA(x)
#endif
// Loops over replicas unroll fully in the <= 8-replica build, where the
// per-replica arrays then sit in registers, and not at all in the
// 64-replica build.
#define CR_UNROLL CR_PRAGMA(unroll(RM <= 8 ? RM : 1))

namespace cr {

constexpr int V0 = 0, V1 = 1, VQUESTION = 2, ABSENT = 3;
constexpr int R2_WAIT = 1;
constexpr int MAX_REPLICAS = 64;
constexpr int32_t INT32_MAX_ = 0x7FFFFFFF;

CR_HD int popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}
CR_HD int popc(uint64_t x) { return mw::popc64(x); }

// The mask of replicas 0..R-1.
template <typename M>
CR_HD M all_of(int R) {
    return R >= static_cast<int>(8 * sizeof(M)) ? ~M(0) : (M(1) << R) - 1;
}

// Write code c of replica r into the planes (lo, hi).
template <typename M>
CR_HD void set_code(M& lo, M& hi, int r, int c) {
    const M bit = M(1) << r;
    lo = (lo & ~bit) | ((c & 1) ? bit : M(0));
    hi = (hi & ~bit) | ((c & 2) ? bit : M(0));
}

template <typename M>
CR_HD int get_code(M lo, M hi, int r) {
    return static_cast<int>((lo >> r) & 1) | (static_cast<int>((hi >> r) & 1) << 1);
}

// The fields of a ClusterState, in its order: slot i32[S], phase
// i32[S,R], stage, my_r1, my_r2, prev_r1, prev_r2 i8[S,R], led1, led2
// i8[S,R,R], decided i8[S], decided_phase i32[S], done u8[S,R], active
// u8[S].
struct Ptrs {
    int32_t* slot;
    int32_t* phase;
    int8_t* stage;
    int8_t* my_r1;
    int8_t* my_r2;
    int8_t* prev_r1;
    int8_t* prev_r2;
    int8_t* led1;
    int8_t* led2;
    int8_t* decided;
    int32_t* dphase;
    uint8_t* done;
    uint8_t* active;
};

// One shard's state. M holds one bit a replica; RM >= R bounds the arrays.
template <typename M, int RM>
struct Shard {
    int32_t slot;
    int32_t phase[RM];
    M st2;                     // replicas in R2_WAIT
    M r1lo, r1hi, r2lo, r2hi;  // my_r1, my_r2
    M p1lo, p1hi, p2lo, p2hi;  // prev_r1, prev_r2
    M l1lo[RM], l1hi[RM];      // led1[receiver], over senders
    M l2lo[RM], l2hi[RM];      // led2[receiver]
    int8_t decided;
    int32_t dphase;
    M done;
    bool active;
};

template <typename M, int RM>
CR_HD void load(Shard<M, RM>& x, const Ptrs& p, int64_t s, int R) {
    x.slot = p.slot[s];
    x.st2 = x.r1lo = x.r1hi = x.r2lo = x.r2hi = x.p1lo = x.p1hi = x.p2lo = x.p2hi = x.done = 0;
    CR_UNROLL
    for (int r = 0; r < RM; ++r) {
        if (r < R) {
            const int64_t k = s * R + r;
            x.phase[r] = p.phase[k];
            x.st2 |= p.stage[k] == R2_WAIT ? M(1) << r : M(0);
            set_code(x.r1lo, x.r1hi, r, p.my_r1[k]);
            set_code(x.r2lo, x.r2hi, r, p.my_r2[k]);
            set_code(x.p1lo, x.p1hi, r, p.prev_r1[k]);
            set_code(x.p2lo, x.p2hi, r, p.prev_r2[k]);
            x.done |= p.done[k] ? M(1) << r : M(0);
            M a = 0, b = 0, c = 0, d = 0;
            for (int i = 0; i < R; ++i) {
                set_code(a, b, i, p.led1[k * R + i]);
                set_code(c, d, i, p.led2[k * R + i]);
            }
            x.l1lo[r] = a, x.l1hi[r] = b, x.l2lo[r] = c, x.l2hi[r] = d;
        }
    }
    x.decided = p.decided[s];
    x.dphase = p.dphase[s];
    x.active = p.active[s] != 0;
}

template <typename M, int RM>
CR_HD void store(const Shard<M, RM>& x, const Ptrs& p, int64_t s, int R) {
    p.slot[s] = x.slot;
    CR_UNROLL
    for (int r = 0; r < RM; ++r) {
        if (r < R) {
            const int64_t k = s * R + r;
            p.phase[k] = x.phase[r];
            p.stage[k] = static_cast<int8_t>((x.st2 >> r) & 1);
            p.my_r1[k] = static_cast<int8_t>(get_code(x.r1lo, x.r1hi, r));
            p.my_r2[k] = static_cast<int8_t>(get_code(x.r2lo, x.r2hi, r));
            p.prev_r1[k] = static_cast<int8_t>(get_code(x.p1lo, x.p1hi, r));
            p.prev_r2[k] = static_cast<int8_t>(get_code(x.p2lo, x.p2hi, r));
            p.done[k] = static_cast<uint8_t>((x.done >> r) & 1);
            for (int i = 0; i < R; ++i) {
                p.led1[k * R + i] = static_cast<int8_t>(get_code(x.l1lo[r], x.l1hi[r], i));
                p.led2[k * R + i] = static_cast<int8_t>(get_code(x.l2lo[r], x.l2hi[r], i));
            }
        }
    }
    p.decided[s] = x.decided;
    p.dphase[s] = x.dphase;
    p.active[s] = x.active ? 1 : 0;
}

// The state start_slot gives an active shard at `slot` with initial
// round-1 votes votes[0..R).
template <typename M, int RM>
CR_HD void fresh(Shard<M, RM>& x, const int8_t* votes, int R, int32_t slot) {
    const M all = all_of<M>(R);
    x.slot = slot;
    x.st2 = x.r1lo = x.r1hi = x.done = 0;
    x.r2lo = x.r2hi = x.p1lo = x.p1hi = x.p2lo = x.p2hi = all;
    CR_UNROLL
    for (int r = 0; r < RM; ++r) {
        if (r < R) {
            set_code(x.r1lo, x.r1hi, r, votes[r]);
            x.phase[r] = 0;
            M lo = all, hi = all;
            set_code(lo, hi, r, votes[r]);
            x.l1lo[r] = lo, x.l1hi[r] = hi;
            x.l2lo[r] = x.l2hi[r] = all;
        }
    }
    x.decided = ABSENT;
    x.dphase = -1;
    x.active = true;
}

// din[j]: the senders that deliver[sender][j] reaches, from a
// bool[R][R] (sender-major) mask, or every replica when mask is null.
template <typename M, int RM>
CR_HD void senders_of(M (&din)[RM], const uint8_t* mask, int R) {
    const M all = all_of<M>(R);
    CR_UNROLL
    for (int j = 0; j < RM; ++j) din[j] = mask ? M(0) : all;
    if (!mask) return;
    for (int i = 0; i < R; ++i) {
        CR_UNROLL
        for (int j = 0; j < RM; ++j) {
            if (j < R) din[j] |= mask[i * R + j] ? M(1) << i : M(0);
        }
    }
}

// One synchronous round of one shard (see the top of this file). alive:
// the live replicas; prefix: mw::coin_prefix(seed, shard, slot).
template <typename M, int RM>
CR_HD void round(Shard<M, RM>& x, int R, M alive, const M (&din)[RM], int quorum, int f1,
                 uint32_t prefix, uint32_t threshold) {
    const M all = all_of<M>(R);

    // 1. delivery, on the pre-step phases, stages and votes
    const M has_r1 = ~(x.r1lo & x.r1hi) & all;
    const M has_p1 = ~(x.p1lo & x.p1hi) & all;
    const M has_r2 = x.st2 & ~(x.r2lo & x.r2hi) & all;
    const M has_p2 = ~(x.p2lo & x.p2hi) & all;
    const M open = alive & ~x.done;
    CR_UNROLL
    for (int j = 0; j < RM; ++j) {
        if (j >= R) continue;
        const M bj = M(1) << j;
        if (!(open & bj)) continue;
        const M link = din[j] & alive & ~bj;
        const uint32_t pj = static_cast<uint32_t>(x.phase[j]);
        M same = 0, ahead = 0;
        CR_UNROLL
        for (int i = 0; i < RM; ++i) {
            if (i < R) {
                const uint32_t pi = static_cast<uint32_t>(x.phase[i]);
                same |= pi == pj ? M(1) << i : M(0);
                ahead |= pi == pj + 1u ? M(1) << i : M(0);
            }
        }
        const M n1 = link & ((same & has_r1) | (ahead & has_p1)) & x.l1lo[j] & x.l1hi[j];
        const M n2 = link & ((same & has_r2) | (ahead & has_p2)) & x.l2lo[j] & x.l2hi[j];
        x.l1lo[j] = (x.l1lo[j] & ~n1) | (((same & x.r1lo) | (~same & x.p1lo)) & n1);
        x.l1hi[j] = (x.l1hi[j] & ~n1) | (((same & x.r1hi) | (~same & x.p1hi)) & n1);
        x.l2lo[j] = (x.l2lo[j] & ~n2) | (((same & x.r2lo) | (~same & x.p2lo)) & n2);
        x.l2hi[j] = (x.l2hi[j] & ~n2) | (((same & x.r2hi) | (~same & x.p2hi)) & n2);
    }

    // 2. transitions of enabled replicas, on the pre-step stages
    const M enabled = (x.active ? all : M(0)) & alive & ~x.done;
    const M r2_pre = x.st2;
    M newly = 0;
    int shard_dec = -1;
    int32_t round_min = INT32_MAX_;
    CR_UNROLL
    for (int j = 0; j < RM; ++j) {
        if (j >= R) continue;
        const M bj = M(1) << j;
        if (!(enabled & bj)) continue;
        if (!(r2_pre & bj)) {  // R1_WAIT: cast the round-2 vote on a quorum
            const M lo = x.l1lo[j], hi = x.l1hi[j];
            if (popc(~(lo & hi) & all) < quorum) continue;
            const int c1 = popc(lo & ~hi), c0 = popc(~(lo | hi) & all);
            const int r2 = c1 >= quorum ? V1 : (c0 >= quorum ? V0 : VQUESTION);
            set_code(x.r2lo, x.r2hi, j, r2);
            set_code(x.l2lo[j], x.l2hi[j], j, r2);
            x.st2 |= bj;
        } else {  // R2_WAIT: decide / adopt / coin, and advance
            const M lo = x.l2lo[j], hi = x.l2hi[j];
            if (popc(~(lo & hi) & all) < quorum) continue;
            const int d1 = popc(lo & ~hi), d0 = popc(~(lo | hi) & all);
            const bool dec1 = d1 >= f1, dec0 = d0 >= f1;
            const int next = dec1 ? V1
                           : dec0 ? V0
                           : d1 > 0 ? V1
                           : d0 > 0 ? V0
                           : mw::coin(prefix, static_cast<uint32_t>(x.phase[j]), threshold);
            if (dec1 || dec0) {
                newly |= bj;
                shard_dec = shard_dec > (dec1 ? V1 : V0) ? shard_dec : (dec1 ? V1 : V0);
                round_min = round_min < x.phase[j] ? round_min : x.phase[j];
            }
            x.phase[j] = static_cast<int32_t>(static_cast<uint32_t>(x.phase[j]) + 1u);
            x.p1lo = (x.p1lo & ~bj) | (x.r1lo & bj);
            x.p1hi = (x.p1hi & ~bj) | (x.r1hi & bj);
            x.p2lo = (x.p2lo & ~bj) | (x.r2lo & bj);
            x.p2hi = (x.p2hi & ~bj) | (x.r2hi & bj);
            set_code(x.r1lo, x.r1hi, j, next);
            set_code(x.r2lo, x.r2hi, j, ABSENT);
            x.st2 &= ~bj;
            M l1lo = all, l1hi = all;
            set_code(l1lo, l1hi, j, next);
            x.l1lo[j] = l1lo, x.l1hi[j] = l1hi;
            x.l2lo[j] = x.l2hi[j] = all;
        }
    }
    if (x.decided == ABSENT && shard_dec >= 0) x.decided = static_cast<int8_t>(shard_dec);
    const int32_t existing = x.dphase < 0 ? INT32_MAX_ : x.dphase;
    const int32_t merged = existing < round_min ? existing : round_min;
    x.dphase = merged == INT32_MAX_ ? -1 : merged;
    const M done = x.done | newly;

    // 3. decision propagation over raw deliver, from decided live senders
    M adopt = 0;
    if (x.active && x.decided != ABSENT) {
        const M src = done & alive;
        CR_UNROLL
        for (int j = 0; j < RM; ++j) {
            if (j < R && (alive & ~done & (M(1) << j)) && (din[j] & src)) adopt |= M(1) << j;
        }
    }
    x.done = done | adopt;
}

// The live replicas of shard s from alive u8[S, R].
template <typename M>
CR_HD M alive_of(const uint8_t* alive, int64_t s, int R) {
    M a = 0;
    for (int r = 0; r < R; ++r) a |= alive[s * R + r] ? M(1) << r : M(0);
    return a;
}

// n rounds of shard s: state from `in`, into `out` (which may be `in`).
// Round k reads its mask at masks + k * mask_stride (bool[S, R, R],
// [shard, sender, receiver]); null masks: full delivery. Shard s is global
// shard shard0 + s, the coin's shard coordinate (shard0 > 0 for a block of
// a mesh's shard axis).
template <typename M, int RM>
CR_HD void rounds_shard(const Ptrs& in, const Ptrs& out, const uint8_t* alive,
                        const uint8_t* masks, int64_t mask_stride, int n, int64_t s, int R,
                        int quorum, int f1, uint32_t seed, uint32_t threshold,
                        uint32_t shard0 = 0) {
    Shard<M, RM> x;
    load(x, in, s, R);
    const M a = alive_of<M>(alive, s, R);
    const uint32_t prefix = mw::coin_prefix(seed, shard0 + static_cast<uint32_t>(s),
                                            static_cast<uint32_t>(x.slot));
    M din[RM];
    for (int k = 0; k < n; ++k) {
        senders_of(din, masks ? masks + k * mask_stride + s * R * R : nullptr, R);
        round(x, R, a, din, quorum, f1, prefix, threshold);
    }
    store(x, out, s, R);
}

// ---- the round by receivers: one lane a receiver (cr_rounds, R <= 8) ----
//
// round() runs a shard's receivers one after another on one thread. Each
// of its steps is a receiver's own: delivery fills receiver j's ledgers,
// the transition moves receiver j's stage, votes and phase, propagation
// marks receiver j done. What crosses receivers is four exchanges:
//   (a) before delivery, every receiver reads every sender's phase, stage
//       and offered votes (the View, taken on the pre-step state);
//   (b) after the transitions, the shard's decision: the largest value
//       any receiver decided this round, the least phase it did so at;
//   (c) the shard's done set after the transitions, which propagation
//       reads;
//   (d) whether any live receiver is still undecided: a shard with none
//       is a fixed point (no delivery, no transition, no propagation
//       reaches a done or dead receiver), so later rounds may be skipped.
// Lane j of a shard's segment holds receiver j's fields (RLane, codes as
// ints, ledgers as planes over senders) and the shard's own (Scalars),
// the same in every lane. The kernel runs the lanes in parallel with the
// exchanges as ballots and shuffles; round_lanes below runs them in turn
// with the exchanges as loops, and the CPU tests hold it against round()
// and the reference's round_step.

constexpr int LANE_RM = 8;  // replicas a segment holds

struct RLane {
    int32_t phase;
    int r1, r2, p1, p2;  // my_r1, my_r2, prev_r1, prev_r2 codes
    bool st2;            // in R2_WAIT
    bool done;
    uint32_t l1lo, l1hi, l2lo, l2hi;  // led1, led2 of this receiver, bit = sender
};

struct Scalars {
    int32_t slot;
    int8_t decided;
    int32_t dphase;
    bool active;
};

// (a) every sender's offered votes as planes over senders, and who is in
// R2_WAIT (bits of replicas past R read as zero).
struct View {
    uint32_t r1lo, r1hi, r2lo, r2hi, p1lo, p1hi, p2lo, p2hi, st2;
};

// Receiver j's field of shard s (j < R), in ClusterState's layout.
CR_HD void load_lane(RLane& x, const Ptrs& p, int64_t s, int j, int R) {
    const int64_t k = s * R + j;
    x.phase = p.phase[k];
    x.st2 = p.stage[k] == R2_WAIT;
    x.r1 = p.my_r1[k] & 3;
    x.r2 = p.my_r2[k] & 3;
    x.p1 = p.prev_r1[k] & 3;
    x.p2 = p.prev_r2[k] & 3;
    x.done = p.done[k] != 0;
    x.l1lo = x.l1hi = x.l2lo = x.l2hi = 0;
    for (int i = 0; i < R; ++i) {
        set_code(x.l1lo, x.l1hi, i, p.led1[k * R + i]);
        set_code(x.l2lo, x.l2hi, i, p.led2[k * R + i]);
    }
}

CR_HD void store_lane(const RLane& x, const Ptrs& p, int64_t s, int j, int R) {
    const int64_t k = s * R + j;
    p.phase[k] = x.phase;
    p.stage[k] = static_cast<int8_t>(x.st2 ? 1 : 0);
    p.my_r1[k] = static_cast<int8_t>(x.r1);
    p.my_r2[k] = static_cast<int8_t>(x.r2);
    p.prev_r1[k] = static_cast<int8_t>(x.p1);
    p.prev_r2[k] = static_cast<int8_t>(x.p2);
    p.done[k] = static_cast<uint8_t>(x.done ? 1 : 0);
    for (int i = 0; i < R; ++i) {
        p.led1[k * R + i] = static_cast<int8_t>(get_code(x.l1lo, x.l1hi, i));
        p.led2[k * R + i] = static_cast<int8_t>(get_code(x.l2lo, x.l2hi, i));
    }
}

CR_HD void load_scalars(Scalars& c, const Ptrs& p, int64_t s) {
    c.slot = p.slot[s];
    c.decided = p.decided[s];
    c.dphase = p.dphase[s];
    c.active = p.active[s] != 0;
}

CR_HD void store_scalars(const Scalars& c, const Ptrs& p, int64_t s) {
    p.slot[s] = c.slot;
    p.decided[s] = c.decided;
    p.dphase[s] = c.dphase;
    p.active[s] = c.active ? 1 : 0;
}

// Receiver j's senders from one bool[R][R] (sender-major) mask: bit i
// where deliver[i][j]; every replica where mask is null.
CR_HD uint32_t din_of(const uint8_t* mask, int R, int j) {
    if (!mask) return all_of<uint32_t>(R);
    uint32_t d = 0;
    for (int i = 0; i < R; ++i) d |= mask[i * R + j] ? 1u << i : 0u;
    return d;
}

// (a) The senders whose phase is receiver j's (same) and one past it
// (ahead), from every sender's phase ph[0..R).
CR_HD void phase_masks(const int32_t (&ph)[LANE_RM], int R, int32_t pj, uint32_t& same,
                       uint32_t& ahead) {
    same = ahead = 0;
    CR_PRAGMA(unroll)
    for (int i = 0; i < LANE_RM; ++i) {
        if (i < R) {
            const uint32_t pi = static_cast<uint32_t>(ph[i]);
            same |= pi == static_cast<uint32_t>(pj) ? 1u << i : 0u;
            ahead |= pi == static_cast<uint32_t>(pj) + 1u ? 1u << i : 0u;
        }
    }
}

// 1. Delivery into receiver j's ledgers: link is the senders that reach
// it (deliver, alive, not itself), 0 where j is dead or done.
CR_HD void deliver_lane(RLane& x, const View& v, uint32_t all, uint32_t same, uint32_t ahead,
                        uint32_t link) {
    const uint32_t has_r1 = ~(v.r1lo & v.r1hi) & all;
    const uint32_t has_p1 = ~(v.p1lo & v.p1hi) & all;
    const uint32_t has_r2 = v.st2 & ~(v.r2lo & v.r2hi) & all;
    const uint32_t has_p2 = ~(v.p2lo & v.p2hi) & all;
    const uint32_t n1 = link & ((same & has_r1) | (ahead & has_p1)) & x.l1lo & x.l1hi;
    const uint32_t n2 = link & ((same & has_r2) | (ahead & has_p2)) & x.l2lo & x.l2hi;
    x.l1lo = (x.l1lo & ~n1) | (((same & v.r1lo) | (~same & v.p1lo)) & n1);
    x.l1hi = (x.l1hi & ~n1) | (((same & v.r1hi) | (~same & v.p1hi)) & n1);
    x.l2lo = (x.l2lo & ~n2) | (((same & v.r2lo) | (~same & v.p2lo)) & n2);
    x.l2hi = (x.l2hi & ~n2) | (((same & v.r2hi) | (~same & v.p2hi)) & n2);
}

// 2. Receiver j's transition when enabled (active shard, alive, not
// done), on its pre-step stage. Returns the value it decided (V0, V1) and
// sets *at to the phase it decided at, or returns -1.
CR_HD int step_lane(RLane& x, int j, uint32_t all, bool enabled, int quorum, int f1,
                    uint32_t prefix, uint32_t threshold, int32_t& at) {
    at = INT32_MAX_;
    if (!enabled) return -1;
    if (!x.st2) {  // R1_WAIT: cast the round-2 vote on a quorum
        if (popc(~(x.l1lo & x.l1hi) & all) < quorum) return -1;
        const int c1 = popc(x.l1lo & ~x.l1hi), c0 = popc(~(x.l1lo | x.l1hi) & all);
        x.r2 = c1 >= quorum ? V1 : (c0 >= quorum ? V0 : VQUESTION);
        set_code(x.l2lo, x.l2hi, j, x.r2);
        x.st2 = true;
        return -1;
    }
    // R2_WAIT: decide / adopt / coin, and advance
    if (popc(~(x.l2lo & x.l2hi) & all) < quorum) return -1;
    const int d1 = popc(x.l2lo & ~x.l2hi), d0 = popc(~(x.l2lo | x.l2hi) & all);
    const bool dec1 = d1 >= f1, dec0 = d0 >= f1;
    const int next = dec1 ? V1
                   : dec0 ? V0
                   : d1 > 0 ? V1
                   : d0 > 0 ? V0
                   : mw::coin(prefix, static_cast<uint32_t>(x.phase), threshold);
    int decided = -1;
    if (dec1 || dec0) {
        decided = dec1 ? V1 : V0;
        at = x.phase;
        x.done = true;
    }
    x.phase = static_cast<int32_t>(static_cast<uint32_t>(x.phase) + 1u);
    x.p1 = x.r1;
    x.p2 = x.r2;
    x.r1 = next;
    x.r2 = ABSENT;
    x.st2 = false;
    x.l1lo = x.l1hi = all;
    set_code(x.l1lo, x.l1hi, j, next);
    x.l2lo = x.l2hi = all;
    return decided;
}

// (b) The shard's decision after the round, from the largest value
// decided in it (-1: none) and the least phase it was decided at.
CR_HD void merge_decision(Scalars& c, int shard_dec, int32_t round_min) {
    if (c.decided == ABSENT && shard_dec >= 0) c.decided = static_cast<int8_t>(shard_dec);
    const int32_t existing = c.dphase < 0 ? INT32_MAX_ : c.dphase;
    const int32_t merged = existing < round_min ? existing : round_min;
    c.dphase = merged == INT32_MAX_ ? -1 : merged;
}

// 3. Does live, undecided receiver j learn the shard's decision? From a
// decided live sender that reaches it under raw deliver (din: its
// senders; done: the shard's done set after the transitions).
CR_HD bool adopts(const Scalars& c, bool live_j, const RLane& x, uint32_t din, uint32_t done,
                  uint32_t alive) {
    return c.active && c.decided != ABSENT && live_j && !x.done && (din & done & alive) != 0;
}

// One round of one shard, receiver by receiver (the kernel's lanes, in
// turn): x[0..R) the receivers, din[j] receiver j's senders, alive the
// live replicas, prefix mw::coin_prefix(seed, shard, slot).
CR_HD void round_lanes(RLane (&x)[LANE_RM], Scalars& c, int R, uint32_t alive,
                       const uint32_t (&din)[LANE_RM], int quorum, int f1, uint32_t prefix,
                       uint32_t threshold) {
    const uint32_t all = all_of<uint32_t>(R);
    View v{};  // (a)
    int32_t ph[LANE_RM] = {};
    for (int i = 0; i < R; ++i) {
        set_code(v.r1lo, v.r1hi, i, x[i].r1);
        set_code(v.r2lo, v.r2hi, i, x[i].r2);
        set_code(v.p1lo, v.p1hi, i, x[i].p1);
        set_code(v.p2lo, v.p2hi, i, x[i].p2);
        v.st2 |= x[i].st2 ? 1u << i : 0u;
        ph[i] = x[i].phase;
    }
    bool open[LANE_RM] = {};
    for (int j = 0; j < R; ++j) {
        open[j] = ((alive >> j) & 1u) && !x[j].done;
        uint32_t same, ahead;
        phase_masks(ph, R, x[j].phase, same, ahead);
        deliver_lane(x[j], v, all, same, ahead, open[j] ? din[j] & alive & ~(1u << j) : 0u);
    }
    int shard_dec = -1;  // (b)
    int32_t round_min = INT32_MAX_;
    for (int j = 0; j < R; ++j) {
        int32_t at;
        const int d = step_lane(x[j], j, all, c.active && open[j], quorum, f1, prefix, threshold,
                                at);
        shard_dec = d > shard_dec ? d : shard_dec;
        round_min = at < round_min ? at : round_min;
    }
    merge_decision(c, shard_dec, round_min);
    uint32_t done = 0;  // (c)
    for (int j = 0; j < R; ++j) done |= x[j].done ? 1u << j : 0u;
    for (int j = 0; j < R; ++j) {
        if (adopts(c, (alive >> j) & 1u, x[j], din[j], done, alive)) x[j].done = true;
    }
}

// (d) No live receiver is undecided: later rounds change nothing.
CR_HD bool settled(const RLane (&x)[LANE_RM], int R, uint32_t alive) {
    for (int j = 0; j < R; ++j) {
        if (((alive >> j) & 1u) && !x[j].done) return false;
    }
    return true;
}

// n rounds of shard s by receivers (R <= 8), as rounds_shard: the host
// build's definition of what the kernel's lanes compute, skipping the
// rounds after the shard settles as the kernel does.
CR_HD void rounds_shard_lanes(const Ptrs& in, const Ptrs& out, const uint8_t* alive,
                              const uint8_t* masks, int64_t mask_stride, int n, int64_t s, int R,
                              int quorum, int f1, uint32_t seed, uint32_t threshold,
                              uint32_t shard0 = 0) {
    RLane x[LANE_RM] = {};
    Scalars c;
    load_scalars(c, in, s);
    for (int j = 0; j < R; ++j) load_lane(x[j], in, s, j, R);
    const uint32_t a = alive_of<uint32_t>(alive, s, R);
    const uint32_t prefix = mw::coin_prefix(seed, shard0 + static_cast<uint32_t>(s),
                                            static_cast<uint32_t>(c.slot));
    uint32_t din[LANE_RM] = {};
    for (int k = 0; k < n && !settled(x, R, a); ++k) {
        const uint8_t* m = masks ? masks + k * mask_stride + s * R * R : nullptr;
        for (int j = 0; j < R; ++j) din[j] = din_of(m, R, j);
        round_lanes(x, c, R, a, din, quorum, f1, prefix, threshold);
    }
    store_scalars(c, out, s);
    for (int j = 0; j < R; ++j) store_lane(x[j], out, s, j, R);
}

// ---- slot_pipeline: the rounds of a fresh slot under full delivery ----
//
// slot_pipeline and slot_pipeline_wide start every (slot, shard) afresh
// (start_slot) and run `rounds` rounds with every link up. Then the
// rounds above collapse to a rule on three counts over the replicas that
// are alive: c0, c1 and cq, the votes V0, V1 and V?, and tot = c0 + c1 +
// cq (an ABSENT vote, or any code outside 0..2, counts in none of them,
// as in round_step's tally). With Q the quorum and f1 = f + 1 <= Q (Q =
// R/2 + 1, f1 = (R-1)/2 + 1), following round_step
// (rabia_tpu/kernel/phase_driver.py:234-385) one round at a time:
//
//  round 1. Delivery: every alive replica's vote that is not ABSENT
//     reaches every other alive replica (same phase 0, link up, nobody
//     done), so every alive replica's round-1 ledger holds the same tot
//     votes: its own, if present, and the others'. Dead replicas neither
//     send nor step. Transitions: in R1_WAIT with tot >= Q, every alive
//     replica casts the same round-2 vote r2 = V1 if c1 >= Q, else V0 if
//     c0 >= Q, else V?; with tot < Q none casts, and since nothing new
//     is ever offered, no later round changes anything: (ABSENT, -1).
//  round 2. Delivery: every alive replica now offers r2 (R2_WAIT, same
//     phase), so each round-2 ledger holds n = #alive >= tot >= Q equal
//     votes. Transitions: all advance; with r2 = V1 (or V0) the count n
//     >= Q >= f1 decides it at phase 0: (V1, 0) or (V0, 0), every alive
//     replica at once, so propagation finds no one left and later rounds
//     change nothing. With r2 = V? there is no non-? vote to adopt, so
//     every alive replica takes the common coin of (seed, shard, slot,
//     phase 0), the slot after int32 wrap, and moves to phase 1 with it
//     as its round-1 vote: (ABSENT, -1) so far.
//  round 3. Delivery fills every round-1 ledger with the n coin votes;
//     n >= Q of one value casts that value in round 2 of phase 1.
//  round 4. Delivery fills the round-2 ledgers with n equal coin votes,
//     which decide it: (coin, 1). Rounds 5 and on change nothing.
//
// So, with fewer than 2 rounds or tot < Q: (ABSENT, -1); else c1 >= Q:
// (V1, 0); else c0 >= Q: (V0, 0); else with 4 rounds or more: (coin, 1);
// else (ABSENT, -1). The CPU tests hold this against fresh + round above
// on every vote vector and alive mask for R = 1..5 and rounds 0..6.
//
// full_delivery is the rule for one (slot, shard); the kernel's byte-wise
// path (R > 8) runs it. decide_chunk is the same rule on 16 shards at
// once, four lanes a 32-bit word, on fused_window.cuh's transposition and
// tally (a byte counts at most R <= 8 votes); the kernel's vector path (R
// <= 8) runs it.

struct Decision {
    int8_t decided;
    int32_t phase;
};

// votes[0..R): the slot's initial round-1 votes; alive[0..R): nonzero
// where the replica is alive; prefix: mw::coin_prefix(seed, shard, slot).
CR_HD Decision full_delivery(const int8_t* votes, const uint8_t* alive, int R, int quorum,
                             int rounds, uint32_t prefix, uint32_t threshold) {
    int c0 = 0, c1 = 0, cq = 0;
    for (int r = 0; r < R; ++r) {
        if (!alive[r]) continue;
        c0 += votes[r] == V0;
        c1 += votes[r] == V1;
        cq += votes[r] == VQUESTION;
    }
    if (rounds < 2 || c0 + c1 + cq < quorum) return {ABSENT, -1};
    if (c1 >= quorum) return {V1, 0};
    if (c0 >= quorum) return {V0, 0};
    if (rounds >= 4) return {static_cast<int8_t>(mw::coin(prefix, 0u, threshold)), 1};
    return {ABSENT, -1};
}

// The rule on four lanes: per-byte counts in, decision codes out, with
// 0x01 in `coin` for each lane that takes the coin (its code left V0 for
// cast_coins to fill). q <= 128, and every count below 0x80.
CR_HD uint32_t decide_word(uint32_t c0, uint32_t c1, uint32_t cq, uint32_t q, int rounds,
                           uint32_t& coin) {
    const uint32_t ok = rounds >= 2 ? rw::ge_bytes(c0 + c1 + cq, q) : 0u;
    const uint32_t g1 = rw::ge_bytes(c1, q) & ok;
    const uint32_t g0 = rw::ge_bytes(c0, q) & ok & ~g1;
    coin = rounds >= 4 ? ok & ~(g1 | g0) : 0u;
    return g1 | ((rw::ONES ^ (g1 | g0 | coin)) * static_cast<uint32_t>(ABSENT));
}

// The coin lanes of word d, for shards shard0..shard0+3 at `slot`.
CR_HD uint32_t cast_coins(uint32_t d, uint32_t coin, uint32_t seed, uint32_t shard0,
                          uint32_t slot, uint32_t threshold) {
    for (int i = 0; i < 4; ++i) {
        if ((coin >> (8 * i)) & 1u) {
            const uint32_t prefix = mw::coin_prefix(seed, shard0 + i, slot);
            d |= static_cast<uint32_t>(mw::coin(prefix, 0u, threshold)) << (8 * i);
        }
    }
    return d;
}

// The decided phase of lane i: 1 for a coin lane, -1 for ABSENT, else 0.
CR_HD int32_t phase_of(uint32_t d, uint32_t coin, int i) {
    return static_cast<int32_t>((coin >> (8 * i)) & 1u) + rw::phase_of(d, i);
}

// The phases of n <= 16 lanes, one at a time.
CR_HD void store_phase_lanes(int32_t* p, int n, const uint32_t d[4], const uint32_t coin[4]) {
    for (int i = 0; i < n; ++i) p[i] = phase_of(d[i / 4], coin[i / 4], i % 4);
}

// 16 shards shard0.. of one slot row: v the 4*R words of their votes and
// at the transposed alive words (fused_window.cuh); d and coin out, a
// word a group of four shards.
template <int R>
CR_HD void decide_chunk(const uint32_t* v, const uint32_t (&at)[4][R], uint32_t q, int rounds,
                        uint32_t seed, uint32_t threshold, uint32_t shard0, uint32_t slot,
                        uint32_t d[4], uint32_t coin[4]) {
    RW_UNROLL
    for (int k = 0; k < 4; ++k) {
        uint32_t c0 = 0, c1 = 0, cq = 0;
        RW_UNROLL
        for (int r = 0; r < R; ++r) {
            const uint32_t w = rw::lane_word<R>(v, k, r);
            rw::tally_word(w, at[k][r], c0, c1);
            cq += rw::eq_bytes(w, VQUESTION * rw::ONES) & at[k][r];
        }
        d[k] = decide_word(c0, c1, cq, q, rounds, coin[k]);
        if (coin[k]) d[k] = cast_coins(d[k], coin[k], seed, shard0 + 4 * k, slot, threshold);
    }
}

// One chunk of n <= 16 shards through the byte-wise loads: `votes` at
// (t, shard0, r=0) of [T, S, R], `alive` at (shard0, r=0) of [S, R].
template <int R>
CR_HD void pipeline_chunk_bytes(const int8_t* votes, const uint8_t* alive, int n, uint32_t q,
                                int rounds, uint32_t seed, uint32_t threshold, uint32_t shard0,
                                uint32_t slot, int8_t* dec, int32_t* ph) {
    uint32_t v[4 * R], a[4 * R], at[4][R], d[4], coin[4];
    rw::load_bytes(reinterpret_cast<const uint8_t*>(votes), n * R, v, 4 * R, rw::CODE_ABSENT);
    rw::load_bytes(alive, n * R, a, 4 * R, 0);
    rw::transpose_alive<R>(a, at);
    decide_chunk<R>(v, at, q, rounds, seed, threshold, shard0, slot, d, coin);
    rw::store_dec_lanes(dec, n, d);
    store_phase_lanes(ph, n, d, coin);
}

// ---- start_slot: open a slot on the masked shards ----
//
// ClusterKernel.start_slot, from the state `in` to `out` (which may be
// `in`): a masked shard opens a slot, its slot number bumped by one where
// it was active (uint32 arithmetic: int32 wrapping past 2^31-1); every
// replica at phase 0 in R1_WAIT with its initial vote votes[s, r] as its
// round-1 vote and as the only entry of its own led1 row; round-2 and
// previous votes, led2 and the decision ABSENT, decided_phase -1, none
// done, active. An unmasked shard keeps its state.
//
// The kernel (cr_start_slot) works over each field's plane as flat
// bytes, not one shard a thread. A thread takes 16 bytes of one [S, R]
// or [S, R, R] plane (a 16-byte vector where the plane's bytes in and out
// are 16-byte aligned and the vector is whole; element by element
// otherwise, the same math), or the [S] fields of 16 shards: slot and
// active are read and written by one thread, so the slot's bump sees the
// active flag from before the call even in place. A vector's first
// element finds its shard (and in led1 its row and column) by a 32-bit
// multiply-shift (Div), the next ones by counting. ss::thread is one
// thread of the launch; ss::launches plans the launches (shard blocks of
// a mesh's device in one table, MAX_BLOCKS a launch); the g++ build of
// the tests walks the same grid on the host.
namespace ss {

constexpr int THREADS = 256;     // threads a CTA
constexpr int MAX_BLOCKS = 16;   // table entries (shard blocks) a launch
constexpr int N_FIELDS = 13;
constexpr int N_PLANES = 9;      // the [S, R] and [S, R, R] fields
// bytes a plane of an entry may hold (< 2^31: 32-bit offsets); a host
// build may set a smaller one to exercise the cut of large blocks
#ifndef CR_SS_MAX_PLANE
#define CR_SS_MAX_PLANE 0x7FFFFFFFu
#endif
constexpr uint32_t MAX_PLANE = CR_SS_MAX_PLANE;

// ClusterState's fields, in order
enum Field { SLOT, PHASE, STAGE, MY_R1, MY_R2, PREV_R1, PREV_R2, LED1, LED2, DECIDED, DPHASE,
             DONE, ACTIVE };
// what a masked shard's element becomes: a constant, its vote, or its
// vote on the ledger's diagonal (ABSENT elsewhere)
enum Op { CONST, VOTE, DIAG };

// x / d for x < 2^31: (x * mul) >> shift with mul = ceil(2^(31+l) / d),
// l = ceil(log2 d). mul < 2^32 and mul * d - 2^(31+l) < d <= 2^l, so the
// error stays below 1/d and the quotient is exact.
struct Div {
    uint32_t mul, shift;
};

CR_HD uint32_t divide(uint32_t x, Div d) {
    return static_cast<uint32_t>((static_cast<uint64_t>(x) * d.mul) >> d.shift);
}

inline Div div_by(uint32_t d) {
    uint32_t l = 0;
    while ((uint64_t(1) << l) < d) ++l;
    return Div{static_cast<uint32_t>(((uint64_t(1) << (31 + l)) + d - 1) / d), 31 + l};
}

// The [S, R] and [S, R, R] fields: element bytes, elements a shard
// (1: R, 2: R*R), and what a masked shard's element becomes.
struct Plane {
    int field, esize, per, op, value;
};

CR_HD Plane plane(int p) {
    switch (p) {
        case 0: return {PHASE, 4, 1, CONST, 0};
        case 1: return {STAGE, 1, 1, CONST, 0};  // R1_WAIT
        case 2: return {MY_R1, 1, 1, VOTE, 0};
        case 3: return {MY_R2, 1, 1, CONST, ABSENT};
        case 4: return {PREV_R1, 1, 1, CONST, ABSENT};
        case 5: return {PREV_R2, 1, 1, CONST, ABSENT};
        case 6: return {LED1, 1, 2, DIAG, ABSENT};
        case 7: return {LED2, 1, 2, CONST, ABSENT};
        default: return {DONE, 1, 1, CONST, 0};
    }
}

// One table entry: a shard block's 13 fields in and out (ClusterState's
// order and dtypes, contiguous), its mask u8[S] and votes i8[S, R].
struct Block {
    const void* in[N_FIELDS];
    void* out[N_FIELDS];
    const uint8_t* mask;
    const int8_t* votes;
    uint32_t S;
};

// A launch: grid (cta[N_PLANES + 1], nblk) of THREADS threads. Job 0
// (CTAs [cta[0], cta[1])) takes the [S] fields 16 shards a thread, job
// p + 1 plane p 16 bytes a thread, each laid out for the largest entry.
struct Args {
    int R, nblk;
    Div by_r, by_rr;
    uint32_t cta[N_PLANES + 2];
    Block blk[MAX_BLOCKS];
};

CR_HD bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

CR_HD void load16(const void* p, uint32_t (&w)[4]) {
#if defined(__CUDA_ARCH__)
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
#else
    memcpy(w, p, 16);
#endif
}

CR_HD void store16(void* p, const uint32_t (&w)[4]) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
#else
    memcpy(p, w, 16);
#endif
}

// Element i of 16 bytes held as four little-endian words.
template <int E>
CR_HD uint32_t get(const uint32_t (&w)[4], int i) {
    return E == 4 ? w[i] : (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

template <int E>
CR_HD void put(uint32_t (&w)[4], int i, uint32_t x) {
    if (E == 4) {
        w[i] = x;
    } else {
        const int sh = 8 * (i & 3);
        w[i >> 2] = (w[i >> 2] & ~(0xFFu << sh)) | ((x & 0xFFu) << sh);
    }
}

// One shard's [S] fields: slot, decided, decided_phase, active.
CR_HD void shard_fields(bool m, uint32_t& slot, uint32_t& decided, uint32_t& dphase,
                        uint32_t& active) {
    const bool was = active != 0;
    slot += (m && was) ? 1u : 0u;
    if (m) {
        decided = ABSENT;
        dphase = 0xFFFFFFFFu;  // -1
    }
    active = (was || m) ? 1u : 0u;
}

// Job 0: the [S] fields of shards 16c .. 16c + 15 of entry k.
CR_HD void shards16(const Block& k, uint32_t c) {
    const uint32_t s0 = 16 * c;
    if (s0 >= k.S) return;
    const auto* mask = k.mask + s0;
    const auto* slot_in = static_cast<const int32_t*>(k.in[SLOT]) + s0;
    const auto* dph_in = static_cast<const int32_t*>(k.in[DPHASE]) + s0;
    const auto* dec_in = static_cast<const uint8_t*>(k.in[DECIDED]) + s0;
    const auto* act_in = static_cast<const uint8_t*>(k.in[ACTIVE]) + s0;
    auto* slot_out = static_cast<int32_t*>(k.out[SLOT]) + s0;
    auto* dph_out = static_cast<int32_t*>(k.out[DPHASE]) + s0;
    auto* dec_out = static_cast<uint8_t*>(k.out[DECIDED]) + s0;
    auto* act_out = static_cast<uint8_t*>(k.out[ACTIVE]) + s0;
    const bool vec = s0 + 16 <= k.S && aligned16(mask) && aligned16(slot_in) &&
                     aligned16(dph_in) && aligned16(dec_in) && aligned16(act_in) &&
                     aligned16(slot_out) && aligned16(dph_out) && aligned16(dec_out) &&
                     aligned16(act_out);
    if (!vec) {
        const uint32_t n = k.S - s0 < 16 ? k.S - s0 : 16;
        for (uint32_t i = 0; i < n; ++i) {
            uint32_t slot = static_cast<uint32_t>(slot_in[i]), dec = dec_in[i];
            uint32_t dph = static_cast<uint32_t>(dph_in[i]), act = act_in[i];
            shard_fields(mask[i] != 0, slot, dec, dph, act);
            slot_out[i] = static_cast<int32_t>(slot);
            dph_out[i] = static_cast<int32_t>(dph);
            dec_out[i] = static_cast<uint8_t>(dec);
            act_out[i] = static_cast<uint8_t>(act);
        }
        return;
    }
    uint32_t m[4], dec[4], act[4], slot[4][4], dph[4][4];
    load16(mask, m);
    load16(dec_in, dec);
    load16(act_in, act);
    CR_PRAGMA(unroll)
    for (int q = 0; q < 4; ++q) {
        load16(slot_in + 4 * q, slot[q]);
        load16(dph_in + 4 * q, dph[q]);
    }
    CR_PRAGMA(unroll)
    for (int i = 0; i < 16; ++i) {
        uint32_t d = get<1>(dec, i), a = get<1>(act, i);
        shard_fields(get<1>(m, i) != 0, slot[i >> 2][i & 3], d, dph[i >> 2][i & 3], a);
        put<1>(dec, i, d);
        put<1>(act, i, a);
    }
    CR_PRAGMA(unroll)
    for (int q = 0; q < 4; ++q) {
        store16(slot_out + 4 * q, slot[q]);
        store16(dph_out + 4 * q, dph[q]);
    }
    store16(dec_out, dec);
    store16(act_out, act);
}

// Plane p's 16 bytes at byte offset o of entry k, elements of E bytes.
template <int E>
CR_HD void plane16(const Args& a, const Block& k, const Plane& pl, uint32_t o) {
    const int R = a.R;
    const uint32_t D = pl.per == 1 ? R : R * R;
    const uint32_t nbytes = k.S * D * E;
    if (o >= nbytes) return;
    const auto* in = static_cast<const uint8_t*>(k.in[pl.field]) + o;
    auto* out = static_cast<uint8_t*>(k.out[pl.field]) + o;
    const int n = static_cast<int>((nbytes - o < 16 ? nbytes - o : 16) / E);
    const bool vec = n * E == 16 && aligned16(in) && aligned16(out);
    uint32_t w[4] = {0, 0, 0, 0};
    if (vec) {
        load16(in, w);
    } else {
        for (int i = 0; i < n; ++i) {
            uint32_t x;
            if (E == 4) {
                int32_t v;
                memcpy(&v, in + 4 * i, 4);
                x = static_cast<uint32_t>(v);
            } else {
                x = in[i];
            }
            put<E>(w, i, x);
        }
    }
    // element e's shard s, its index k within the shard, and in a ledger
    // its row r and column j
    const uint32_t e = o / E;
    uint32_t s = divide(e, pl.per == 1 ? a.by_r : a.by_rr);
    uint32_t kk = e - s * D, r = 0, j = 0;
    if (pl.per == 2) {
        r = divide(kk, a.by_r);
        j = kk - r * R;
    }
    CR_PRAGMA(unroll)
    for (int i = 0; i < 16 / E; ++i) {
        if (i < n) {
            if (k.mask[s] != 0) {
                uint32_t x = static_cast<uint32_t>(pl.value);
                if (pl.op == VOTE) x = static_cast<uint8_t>(k.votes[e + i]);
                if (pl.op == DIAG && j == r) x = static_cast<uint8_t>(k.votes[s * R + r]);
                put<E>(w, i, x);
            }
            if (++j == static_cast<uint32_t>(R)) j = 0, ++r;
            if (++kk == D) kk = 0, ++s, r = 0, j = 0;
        }
    }
    if (vec) {
        store16(out, w);
    } else {
        for (int i = 0; i < n; ++i) {
            if (E == 4) {
                const int32_t v = static_cast<int32_t>(get<E>(w, i));
                memcpy(out + 4 * i, &v, 4);
            } else {
                out[i] = static_cast<uint8_t>(get<E>(w, i));
            }
        }
    }
}

// Thread t of CTA (cta, b): entry b's job that the CTA falls in.
CR_HD void thread(const Args& a, uint32_t cta, uint32_t b, uint32_t t) {
    const Block& k = a.blk[b];
    if (cta < a.cta[1]) {
        shards16(k, cta * THREADS + t);
        return;
    }
    int p = 0;
    while (cta >= a.cta[p + 2]) ++p;
    const Plane pl = plane(p);
    const uint32_t o = 16 * ((cta - a.cta[p + 1]) * THREADS + t);
    if (pl.esize == 4) {
        plane16<4>(a, k, pl, o);
    } else {
        plane16<1>(a, k, pl, o);
    }
}

// Largest R the table takes: a shard's R*R ledger bytes must fit an
// entry's plane.
constexpr int MAX_R = 46340;

// The launches over nblk shard blocks of S shards each (in and out: 13
// field pointers a block, in ClusterState's order; masks and votes: one
// a block). A block too large for 32-bit plane offsets is cut into
// entries of fewer shards; the entries go MAX_BLOCKS a launch. Calls
// fn(args, grid_x) once a launch (grid (grid_x, args.nblk) of THREADS);
// returns the launches, or -1 on a bad shape.
template <typename Fn>
int launches(int nblk, void* const* in, void* const* out, const void* const* masks,
             const void* const* votes, int64_t S, int R, Fn&& fn) {
    if (nblk < 0 || S < 0 || R < 1 || R > MAX_R) return -1;
    if (nblk == 0 || S == 0) return 0;
    const uint64_t per_shard = static_cast<uint64_t>(R) * R > 4ull * R ? uint64_t(R) * R : 4ull * R;
    int64_t chunk = static_cast<int64_t>(MAX_PLANE / per_shard);
    if (chunk >= 16) chunk -= chunk % 16;
    const int64_t cut = S < chunk ? S : chunk;
    Args a{};
    a.R = R;
    a.by_r = div_by(static_cast<uint32_t>(R));
    a.by_rr = div_by(static_cast<uint32_t>(R) * R);
    const uint32_t span = 16 * THREADS;  // bytes a CTA
    a.cta[0] = 0;
    a.cta[1] = static_cast<uint32_t>((cut + span - 1) / span);
    for (int p = 0; p < N_PLANES; ++p) {
        const Plane pl = plane(p);
        const uint64_t bytes = uint64_t(cut) * (pl.per == 1 ? R : uint64_t(R) * R) * pl.esize;
        a.cta[p + 2] = a.cta[p + 1] + static_cast<uint32_t>((bytes + span - 1) / span);
    }
    static const int esize[N_FIELDS] = {4, 4, 1, 1, 1, 1, 1, 1, 1, 1, 4, 1, 1};
    static const int per[N_FIELDS] = {0, 1, 1, 1, 1, 1, 1, 2, 2, 0, 0, 1, 0};
    int n = 0;
    for (int b = 0; b < nblk; ++b) {
        for (int64_t s0 = 0; s0 < S; s0 += cut) {
            Block& k = a.blk[a.nblk++];
            k.S = static_cast<uint32_t>(S - s0 < cut ? S - s0 : cut);
            for (int f = 0; f < N_FIELDS; ++f) {
                const int64_t off = s0 * (per[f] == 0 ? 1 : per[f] == 1 ? R : int64_t(R) * R) *
                                    esize[f];
                k.in[f] = static_cast<const uint8_t*>(in[b * N_FIELDS + f]) + off;
                k.out[f] = static_cast<uint8_t*>(out[b * N_FIELDS + f]) + off;
            }
            k.mask = static_cast<const uint8_t*>(masks[b]) + s0;
            k.votes = static_cast<const int8_t*>(votes[b]) + s0 * R;
            if (a.nblk == MAX_BLOCKS) {
                fn(static_cast<const Args&>(a), a.cta[N_PLANES + 1]);
                ++n;
                a.nblk = 0;
            }
        }
    }
    if (a.nblk > 0) {
        fn(static_cast<const Args&>(a), a.cta[N_PLANES + 1]);
        ++n;
    }
    return n;
}

}  // namespace ss

}  // namespace cr
