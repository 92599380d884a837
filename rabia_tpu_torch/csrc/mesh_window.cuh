// Per-(slot, shard) math of the lockstep replica-parallel weak MVC
// window, shared by the CUDA kernel (mesh_window.cu) and a plain host
// build (g++) that the CPU tests check against the reference's
// MeshPhaseKernel.slot_window.
//
// One (window entry t, shard s) runs max_phases lockstep phases over its
// R replicas. A phase: live = alive & undecided; the R1 tally counts the
// live replicas' V0 and V1 votes; every replica's R2 vote is V1 at a
// quorum of V1, V0 at a quorum of V0, else ?; the R2 tally counts the
// live replicas' R2 votes; a live replica decides at f+1 equal R2 votes,
// else adopts a non-? R2 vote, else takes the common coin of (seed,
// shard, slot, its phase). The result is the decision, or ABSENT.
//
// Why one coin per phase is exact: the R2 vote is the same for every
// replica, so a phase decides either every live replica or none. The
// live set therefore stays the alive set until it decides as a whole,
// and every live replica's phase counter equals the phase index. So the
// replica state collapses to bitmasks (V0 votes, V1 votes, the alive
// set), the tallies are population counts, and the common coin is
// evaluated once per phase.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MW_HD __host__ __device__ __forceinline__
#else
#define MW_HD inline
#endif

namespace mw {

constexpr int V0 = 0, V1 = 1, VQUESTION = 2, ABSENT = 3;
constexpr int MAX_REPLICAS = 64;  // one bit per replica in a uint64_t
constexpr uint32_t GOLD = 0x9E3779B9u;  // 2^32 / golden ratio, the hash_combine offset

MW_HD int popc64(uint64_t x) {
#if defined(__CUDA_ARCH__)
    return __popcll(x);
#else
    return __builtin_popcountll(x);
#endif
}

// lowbias32 avalanche, in uint32 arithmetic (wraps as the reference's does).
MW_HD uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x21F0AAADu;
    h ^= h >> 15;
    h *= 0x735A2D97u;
    h ^= h >> 15;
    return h;
}

// The part of the common coin's hash chain fixed by (seed, shard, slot).
MW_HD uint32_t coin_prefix(uint32_t seed, uint32_t shard, uint32_t slot) {
    uint32_t h = mix32(seed ^ GOLD);
    h = mix32(h ^ (shard + GOLD));
    return mix32(h ^ (slot + GOLD));
}

// The common coin at `phase`: V1 below the uint32 threshold, else V0.
MW_HD int coin(uint32_t prefix, uint32_t phase, uint32_t threshold) {
    return mix32(prefix ^ (phase + GOLD)) < threshold ? V1 : V0;
}

// Slot number of window entry t on a shard whose window starts at
// `base`: base + t in uint32, which is int32 addition wrapped, as torch
// and JAX compute it.
MW_HD uint32_t slot_of(int32_t base, int t) {
    return static_cast<uint32_t>(base) + static_cast<uint32_t>(t);
}

struct Masks {
    uint64_t v0, v1, alive;
};

// Replica r's bit is set in v0 / v1 where its initial vote is V0 / V1,
// and in alive where alive_row[r] != 0. R <= MAX_REPLICAS.
MW_HD Masks row_masks(const int8_t* votes_row, const uint8_t* alive_row, int R) {
    Masks m{0, 0, 0};
    for (int r = 0; r < R; ++r) {
        const uint64_t bit = uint64_t{1} << r;
        m.v0 |= votes_row[r] == V0 ? bit : 0;
        m.v1 |= votes_row[r] == V1 ? bit : 0;
        m.alive |= alive_row[r] ? bit : 0;
    }
    return m;
}

// The window entry's decision after at most max_phases phases (see the
// top of this file); stops at the first deciding phase.
MW_HD int decide(Masks m, int quorum, int f1, uint32_t prefix, uint32_t threshold,
                 int max_phases) {
    const uint64_t live = m.alive;
    const int n = popc64(live);
    uint64_t v0 = m.v0 & live, v1 = m.v1 & live;
    for (int phase = 0; phase < max_phases && n > 0; ++phase) {
        const int c0 = popc64(v0), c1 = popc64(v1);
        const int r2 = c1 >= quorum ? V1 : (c0 >= quorum ? V0 : VQUESTION);
        const int d1 = r2 == V1 ? n : 0;
        const int d0 = r2 == V0 ? n : 0;
        if (d1 >= f1) return V1;
        if (d0 >= f1) return V0;
        const int next = d1 > 0 ? V1 : (d0 > 0 ? V0 : coin(prefix, static_cast<uint32_t>(phase),
                                                             threshold));
        v1 = next == V1 ? live : 0;
        v0 = next == V0 ? live : 0;
    }
    return ABSENT;
}

// Wave t of shard `shard` in the device KV lane's window
// (DeviceKVTable): every replica votes V1 for the waves that carry ops,
// so such a wave decides from `v1_row`, R bytes of V1, like any window
// entry. (The empty waves after them carry V0 votes; nothing reads their
// decisions.)
MW_HD int decide_v1_wave(const int8_t* v1_row, const uint8_t* alive_row, int R, int32_t base,
                         uint32_t shard, int t, int quorum, int f1, uint32_t seed,
                         uint32_t threshold, int max_phases) {
    const Masks m = row_masks(v1_row, alive_row, R);
    const uint32_t prefix = coin_prefix(seed, shard, slot_of(base, t));
    return decide(m, quorum, f1, prefix, threshold, max_phases);
}

// The replica bitmasks of a row whose R = B * Rb replicas lie in B
// blocks of Rb, as an all_gather over the replica axis leaves them:
// block b's Rb vote bytes at votes_row + b * vstride and its alive bytes
// at alive_row + b * astride hold replicas b * Rb .. b * Rb + Rb - 1.
// B = 1 is row_masks. B * Rb <= MAX_REPLICAS.
MW_HD Masks blocked_masks(const int8_t* votes_row, int64_t vstride, const uint8_t* alive_row,
                          int64_t astride, int B, int Rb) {
    Masks m{0, 0, 0};
    for (int b = 0; b < B; ++b) {
        const Masks p = row_masks(votes_row + b * vstride, alive_row + b * astride, Rb);
        m.v0 |= p.v0 << (b * Rb);
        m.v1 |= p.v1 << (b * Rb);
        m.alive |= p.alive << (b * Rb);
    }
    return m;
}

// Window entry (t, s) of a shard block whose replicas lie in B blocks:
// votes i8[B, T, S, Rb] (block stride vstride bytes), alive u8[B, S, Rb]
// (block stride astride), base i32[S]; the block's first shard is global
// shard shard0, which keys the common coin.
MW_HD int8_t decide_entry_blocks(const int8_t* votes, int64_t vstride, const uint8_t* alive,
                                 int64_t astride, const int32_t* base, int B, int64_t S, int Rb,
                                 int t, int64_t s, uint32_t shard0, int quorum, int f1,
                                 uint32_t seed, uint32_t threshold, int max_phases) {
    const Masks m = blocked_masks(votes + (t * S + s) * Rb, vstride, alive + s * Rb, astride, B, Rb);
    const uint32_t prefix = coin_prefix(seed, shard0 + static_cast<uint32_t>(s), slot_of(base[s], t));
    return static_cast<int8_t>(decide(m, quorum, f1, prefix, threshold, max_phases));
}

// Window entry (t, s) of votes i8[T, S, R], alive u8[S, R], base i32[S]:
// one replica block, shards numbered from 0.
MW_HD int8_t decide_entry(const int8_t* votes, const uint8_t* alive, const int32_t* base,
                          int64_t S, int R, int t, int64_t s, int quorum, int f1,
                          uint32_t seed, uint32_t threshold, int max_phases) {
    return decide_entry_blocks(votes, 0, alive, 0, base, 1, S, R, t, s, 0u, quorum, f1, seed,
                               threshold, max_phases);
}

}  // namespace mw
