// Per-shard math of the scanned weak-MVC protocol (ClusterKernel's
// round_step, chained over rounds and slots), shared by the CUDA kernels
// (cluster_round.cu) and a plain host build (g++) that the CPU tests
// check against the reference's round_step and slot_pipeline.
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
// [shard, sender, receiver]); null masks: full delivery.
template <typename M, int RM>
CR_HD void rounds_shard(const Ptrs& in, const Ptrs& out, const uint8_t* alive,
                        const uint8_t* masks, int64_t mask_stride, int n, int64_t s, int R,
                        int quorum, int f1, uint32_t seed, uint32_t threshold) {
    Shard<M, RM> x;
    load(x, in, s, R);
    const M a = alive_of<M>(alive, s, R);
    const uint32_t prefix =
        mw::coin_prefix(seed, static_cast<uint32_t>(s), static_cast<uint32_t>(x.slot));
    M din[RM];
    for (int k = 0; k < n; ++k) {
        senders_of(din, masks ? masks + k * mask_stride + s * R * R : nullptr, R);
        round(x, R, a, din, quorum, f1, prefix, threshold);
    }
    store(x, out, s, R);
}

// Slot t of shard s in slot_pipeline: a fresh slot `base + t` (int32
// wrapped) from votes i8[T, S, R], `rounds` full-delivery rounds; writes
// decided[t * S + s] and dphase[t * S + s].
template <typename M, int RM>
CR_HD void pipeline_entry(const int8_t* votes, const uint8_t* alive, int8_t* decided,
                          int32_t* dphase, int64_t t, int64_t s, int64_t S, int R, int32_t base,
                          int rounds, int quorum, int f1, uint32_t seed, uint32_t threshold) {
    const int64_t i = t * S + s;
    const auto slot = static_cast<int32_t>(mw::slot_of(base, static_cast<int>(t)));
    Shard<M, RM> x;
    fresh(x, votes + i * R, R, slot);
    const M a = alive_of<M>(alive, s, R);
    const uint32_t prefix =
        mw::coin_prefix(seed, static_cast<uint32_t>(s), static_cast<uint32_t>(slot));
    M din[RM];
    senders_of(din, static_cast<const uint8_t*>(nullptr), R);
    for (int k = 0; k < rounds; ++k) round(x, R, a, din, quorum, f1, prefix, threshold);
    decided[i] = x.decided;
    dphase[i] = x.dphase;
}

}  // namespace cr
