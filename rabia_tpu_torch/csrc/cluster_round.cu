// The scanned weak-MVC protocol as CUDA kernels for Hopper (sm_90a).
//
// Replaces the reference's ClusterKernel.round_step
// (rabia_tpu/kernel/phase_driver.py), one XLA program a round, and the
// lax.scan loops over it: run_rounds (n rounds under lossy delivery) and
// slot_pipeline / slot_pipeline_wide (every slot, rounds_per_slot rounds
// of full delivery each). The per-shard math is cluster_round.cuh; its
// common coin is mesh_window.cuh's.
//
// Bound: integer operations for the slot pipeline, latency for the
// rounds. A slot of a shard moves R vote bytes in and 5 bytes out
// (decision and phase), 335 MB at S=4096 R=5 T=8192, 0.10 ms at the
// H100 SXM's 3.35 TB/s; its rounds take a few hundred integer operations
// each (R^2 phase compares, plane updates, popcounts, a hash for a
// coin), which is more. The rounds entry runs n dependent rounds of one
// thread a shard: 4096 threads at S=4096, so its time is the chain's
// latency, not a rate.
//
// Design: one thread per shard (cr_rounds) or per (slot, shard)
// (cr_slot_pipeline); the shard's state sits in registers as bitmasks
// over replicas (cluster_round.cuh) for the whole chain of rounds, so
// each launch reads and writes the state once. Slots are independent
// (start_slot resets every field), so the pipeline needs no carry from
// one slot to the next. R <= 8 runs on 32-bit masks with the replica
// loops unrolled; R <= 64 on 64-bit masks with the arrays in local
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_round.cuh"

namespace {

constexpr int ROUNDS_BLOCK = 64;  // 4096 shards: 64 blocks, one thread a shard
constexpr int PIPE_BLOCK = 256;

struct Params {
    int64_t S, T, mask_stride;
    int R, n, quorum, f1;
    int32_t base;
    uint32_t seed, threshold;
};

template <typename M, int RM>
__global__ void __launch_bounds__(ROUNDS_BLOCK)
rounds_kernel(cr::Ptrs in, cr::Ptrs out, const uint8_t* __restrict__ alive,
              const uint8_t* __restrict__ masks, Params p) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (s >= p.S) return;
    cr::rounds_shard<M, RM>(in, out, alive, masks, p.mask_stride, p.n, s, p.R, p.quorum, p.f1,
                            p.seed, p.threshold);
}

template <typename M, int RM>
__global__ void __launch_bounds__(PIPE_BLOCK)
pipeline_kernel(const int8_t* __restrict__ votes, const uint8_t* __restrict__ alive,
                int8_t* __restrict__ decided, int32_t* __restrict__ dphase, Params p) {
    const int64_t total = p.T * p.S;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int64_t t = i / p.S;
        cr::pipeline_entry<M, RM>(votes, alive, decided, dphase, t, i - t * p.S, p.S, p.R, p.base,
                                  p.n, p.quorum, p.f1, p.seed, p.threshold);
    }
}

cr::Ptrs ptrs(void* const* f) {
    cr::Ptrs p;
    p.slot = static_cast<int32_t*>(f[0]);
    p.phase = static_cast<int32_t*>(f[1]);
    p.stage = static_cast<int8_t*>(f[2]);
    p.my_r1 = static_cast<int8_t*>(f[3]);
    p.my_r2 = static_cast<int8_t*>(f[4]);
    p.prev_r1 = static_cast<int8_t*>(f[5]);
    p.prev_r2 = static_cast<int8_t*>(f[6]);
    p.led1 = static_cast<int8_t*>(f[7]);
    p.led2 = static_cast<int8_t*>(f[8]);
    p.decided = static_cast<int8_t*>(f[9]);
    p.dphase = static_cast<int32_t*>(f[10]);
    p.done = static_cast<uint8_t*>(f[11]);
    p.active = static_cast<uint8_t*>(f[12]);
    return p;
}

bool bad_shape(long long S, int R, int quorum, int f1) {
    return S < 0 || R < 1 || R > cr::MAX_REPLICAS || quorum < 1 || f1 < 1;
}

}  // namespace

// n rounds over the 13 state fields `in` (ClusterState's order and
// dtypes, all contiguous), written to `out` (which may be `in`: every
// shard reads its own state before it writes it). alive u8[S, R]; masks
// u8[n, S, R, R] ([round, shard, sender, receiver], 0 or 1) with round
// stride mask_stride elements (0: one mask for every round), or null for
// full delivery. 1 <= R <= 64; quorum and f1 from R; seed is the coin
// seed masked to 32 bits; threshold = coin_threshold(coin_p1). Launches
// on `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int cr_rounds(void* const* in, void* const* out, const void* alive, const void* masks,
                         long long mask_stride, int n, long long S, int R, int quorum, int f1,
                         unsigned int seed, unsigned int threshold, void* stream) {
    if (bad_shape(S, R, quorum, f1) || n < 0 || mask_stride < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (S == 0) return 0;
    Params p{};
    p.S = S;
    p.R = R;
    p.n = n;
    p.mask_stride = mask_stride;
    p.quorum = quorum;
    p.f1 = f1;
    p.seed = seed;
    p.threshold = threshold;
    const auto blocks = static_cast<unsigned>((S + ROUNDS_BLOCK - 1) / ROUNDS_BLOCK);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* a = static_cast<const uint8_t*>(alive);
    const auto* m = static_cast<const uint8_t*>(masks);
    if (R <= 8) {
        rounds_kernel<uint32_t, 8><<<blocks, ROUNDS_BLOCK, 0, st>>>(ptrs(in), ptrs(out), a, m, p);
    } else {
        rounds_kernel<uint64_t, 64><<<blocks, ROUNDS_BLOCK, 0, st>>>(ptrs(in), ptrs(out), a, m, p);
    }
    return static_cast<int>(cudaGetLastError());
}

// slot_pipeline: votes i8[T, S, R], alive u8[S, R] in; decided i8[T, S]
// and decided_phase i32[T, S] out; slot t is base + t (int32 wrapped),
// with `rounds` full-delivery rounds. Other arguments as cr_rounds'.
extern "C" int cr_slot_pipeline(const void* votes, const void* alive, void* decided, void* dphase,
                                long long T, long long S, int R, int base, int rounds, int quorum,
                                int f1, unsigned int seed, unsigned int threshold, void* stream) {
    if (bad_shape(S, R, quorum, f1) || T < 0 || T > INT32_MAX || rounds < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (T == 0 || S == 0) return 0;
    Params p{};
    p.S = S;
    p.T = T;
    p.R = R;
    p.n = rounds;
    p.base = base;
    p.quorum = quorum;
    p.f1 = f1;
    p.seed = seed;
    p.threshold = threshold;
    int64_t blocks = (T * S + PIPE_BLOCK - 1) / PIPE_BLOCK;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* v = static_cast<const int8_t*>(votes);
    const auto* a = static_cast<const uint8_t*>(alive);
    auto* d = static_cast<int8_t*>(decided);
    auto* ph = static_cast<int32_t*>(dphase);
    if (R <= 8) {
        pipeline_kernel<uint32_t, 8><<<static_cast<unsigned>(blocks), PIPE_BLOCK, 0, st>>>(
            v, a, d, ph, p);
    } else {
        pipeline_kernel<uint64_t, 64><<<static_cast<unsigned>(blocks), PIPE_BLOCK, 0, st>>>(
            v, a, d, ph, p);
    }
    return static_cast<int>(cudaGetLastError());
}
