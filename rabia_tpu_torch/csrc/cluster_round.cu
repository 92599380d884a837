// The scanned weak-MVC protocol as CUDA kernels for Hopper (sm_90a).
//
// Replaces the reference's ClusterKernel.round_step
// (rabia_tpu/kernel/phase_driver.py:234), one XLA program a round, and
// the lax.scan loops over it: run_rounds (:386, n rounds under lossy
// delivery) and slot_pipeline / slot_pipeline_wide (:420 and :466, every
// slot, rounds_per_slot rounds of full delivery each). The per-shard
// math is cluster_round.cuh; its common coin is mesh_window.cuh's.
//
// cr_rounds (run_rounds, round_step). Bound: latency. It runs n
// dependent rounds of one thread a shard, 4096 threads at S=4096, so its
// time is the chain's latency, not a rate. Design: the shard's state
// sits in registers as bitmasks over replicas (cluster_round.cuh) for
// the whole chain, so each launch reads and writes the state once. R <= 8
// runs on 32-bit masks with the replica loops unrolled; R <= 64 on 64-bit
// masks with the arrays in local memory.
//
// cr_slot_pipeline (slot_pipeline, slot_pipeline_wide). Bound: bytes.
// Under full delivery a fresh slot's rounds collapse to a rule on three
// counts (cluster_round.cuh, full_delivery, derived there against
// round_step for every rounds_per_slot), so the function must read R
// vote bytes a (slot, shard) and R alive bytes a shard, and write one
// decision byte and a 4-byte phase: at S=4096 R=5 T=8192, 335.5 MB, 0.100
// ms at the H100 SXM's 3.35 TB/s. The rule is a few integer operations a
// replica, below that. Design, for R <= 8: fused_window.cu's [T, S, R]
// kernel with the rule in place of its closed form. One thread a chunk
// of 16 shards walks slot rows with a stride; a warp's chunks are 32*16*R
// contiguous bytes, loaded through shared memory as R instructions of 512
// contiguous bytes (fused_window.cuh's loader), transposed in registers
// into four lanes a 32-bit word and tallied there (fused_window.cuh's
// tally, plus a third count for V?). Decisions leave as one 16-byte
// vector a lane, phases through a swizzled buffer as 4 stores of 512
// contiguous bytes. The coin is hashed only for the lanes that reach it
// (4 rounds or more, neither value at a quorum). A chunk cut by the end
// of a row, or not 16-byte aligned (rows are S*R bytes), loads and stores
// bytewise: the same math. For 9 <= R <= 64 (no four-lane counters: a
// count may pass a byte's 7 bits) a byte-wise kernel runs full_delivery
// once a (slot, shard), neighbouring threads on neighbouring R-byte runs.
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

// The rule's phase plane of four lanes.
__device__ __forceinline__ int4 phase_vec(uint32_t d, uint32_t coin) {
    return make_int4(cr::phase_of(d, coin, 0), cr::phase_of(d, coin, 1),
                     cr::phase_of(d, coin, 2), cr::phase_of(d, coin, 3));
}

// slot_pipeline for R <= 8: one thread a chunk of 16 shards, walking rows.
template <int R>
__global__ void __launch_bounds__(256)
pipeline_tsr_kernel(const int8_t* __restrict__ votes, const uint8_t* __restrict__ alive,
                    int8_t* __restrict__ dec, int32_t* __restrict__ ph, Params p) {
    // a warp's vote vectors of one row, or its phase vectors
    constexpr int BUF = 32 * R > 128 ? 32 * R : 128;
    __shared__ uint4 bufs[256 / 32 * BUF];
    const int64_t S = p.S;
    const int64_t chunks = (S + rw::LANES - 1) / rw::LANES;
    const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= chunks) return;
    const int lane = threadIdx.x & 31;
    uint4* buf = bufs + ((threadIdx.y * blockDim.x + threadIdx.x) >> 5) * BUF;
    const bool warp_whole = (c - lane + 32) * rw::LANES <= S;  // uniform over the warp
    const int64_t s0 = c * rw::LANES;
    const int n = static_cast<int>(S - s0 < rw::LANES ? S - s0 : rw::LANES);
    const auto q = static_cast<uint32_t>(p.quorum);
    uint32_t a[4 * R], at[4][R];
    rw::load_chunk<R>(alive + s0 * R, n, a, 0);
    rw::transpose_alive<R>(a, at);
    const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
    for (int64_t t = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; t < p.T;
         t += stride) {
        const int64_t off = t * S + s0, warp_off = off - lane * rw::LANES;
        uint32_t v[4 * R], d[4], coin[4];
        const int8_t* pv = votes + warp_off * R;
        if (warp_whole && rw::aligned16(pv)) {
            rw::load_warp_row<R>(reinterpret_cast<const uint4*>(pv), buf, lane, v);
        } else {
            rw::load_chunk<R>(reinterpret_cast<const uint8_t*>(votes + off * R), n, v,
                              rw::CODE_ABSENT);
        }
        cr::decide_chunk<R>(v, at, q, p.n, p.seed, p.threshold, static_cast<uint32_t>(s0),
                            mw::slot_of(p.base, static_cast<int>(t)), d, coin);

        int8_t* dp = dec + off;
        if (n == rw::LANES && rw::aligned16(dp)) {
            *reinterpret_cast<uint4*>(dp) = make_uint4(d[0], d[1], d[2], d[3]);
        } else {
            rw::store_dec_lanes(dp, n, d);
        }
        if (warp_whole && rw::aligned16(ph + warp_off)) {
            const int4 pv4[4] = {phase_vec(d[0], coin[0]), phase_vec(d[1], coin[1]),
                                 phase_vec(d[2], coin[2]), phase_vec(d[3], coin[3])};
            rw::store_warp_phases(reinterpret_cast<int4*>(ph + warp_off),
                                  reinterpret_cast<int4*>(buf), lane, pv4);
        } else {
            cr::store_phase_lanes(ph + off, n, d, coin);
        }
    }
}

// slot_pipeline for any R <= 64: one thread a (slot, shard).
__global__ void __launch_bounds__(PIPE_BLOCK)
pipeline_bytes_kernel(const int8_t* __restrict__ votes, const uint8_t* __restrict__ alive,
                      int8_t* __restrict__ dec, int32_t* __restrict__ ph, Params p) {
    const int64_t total = p.T * p.S;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int64_t t = i / p.S, s = i - t * p.S;
        const uint32_t prefix = mw::coin_prefix(p.seed, static_cast<uint32_t>(s),
                                                mw::slot_of(p.base, static_cast<int>(t)));
        const cr::Decision x = cr::full_delivery(votes + i * p.R, alive + s * p.R, p.R, p.quorum,
                                                 p.n, prefix, p.threshold);
        dec[i] = x.decided;
        ph[i] = x.phase;
    }
}

template <int R>
int launch_tsr(const int8_t* v, const uint8_t* a, int8_t* d, int32_t* ph, const Params& p,
               cudaStream_t st) {
    dim3 grid, block;
    const int err = rw::tsr_launch_shape(p.T, p.S, grid, block);
    if (err != 0) return err;
    pipeline_tsr_kernel<R><<<grid, block, 0, st>>>(v, a, d, ph, p);
    return static_cast<int>(cudaGetLastError());
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

// slot_pipeline: votes i8[T, S, R] (any byte offset), alive u8[S, R]
// in; decided i8[T, S] and decided_phase i32[T, S] out; slot t is base +
// t (int32 wrapped), with `rounds` full-delivery rounds. Needs f1 <=
// quorum (the rule's derivation), as quorum_size and f_plus_1 give. Other
// arguments as cr_rounds'.
extern "C" int cr_slot_pipeline(const void* votes, const void* alive, void* decided, void* dphase,
                                long long T, long long S, int R, int base, int rounds, int quorum,
                                int f1, unsigned int seed, unsigned int threshold, void* stream) {
    if (bad_shape(S, R, quorum, f1) || f1 > quorum || T < 0 || T > INT32_MAX || rounds < 0) {
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
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* v = static_cast<const int8_t*>(votes);
    const auto* a = static_cast<const uint8_t*>(alive);
    auto* d = static_cast<int8_t*>(decided);
    auto* ph = static_cast<int32_t*>(dphase);
    if (R > rw::MAX_R) {
        int64_t blocks = (T * S + PIPE_BLOCK - 1) / PIPE_BLOCK;
        if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
        pipeline_bytes_kernel<<<static_cast<unsigned>(blocks), PIPE_BLOCK, 0, st>>>(v, a, d, ph, p);
        return static_cast<int>(cudaGetLastError());
    }
    // a quorum above R never decides; R + 1 keeps the four-lane compare exact
    if (p.quorum > R + 1) p.quorum = R + 1;
    switch (R) {
        case 1: return launch_tsr<1>(v, a, d, ph, p, st);
        case 2: return launch_tsr<2>(v, a, d, ph, p, st);
        case 3: return launch_tsr<3>(v, a, d, ph, p, st);
        case 4: return launch_tsr<4>(v, a, d, ph, p, st);
        case 5: return launch_tsr<5>(v, a, d, ph, p, st);
        case 6: return launch_tsr<6>(v, a, d, ph, p, st);
        case 7: return launch_tsr<7>(v, a, d, ph, p, st);
        default: return launch_tsr<8>(v, a, d, ph, p, st);
    }
}
