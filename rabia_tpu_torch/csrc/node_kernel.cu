// One node's weak-MVC kernel (NodeKernel) as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the reference's NodeKernel.node_cycle, node_step and
// start_slots (rabia_tpu/kernel/phase_driver.py), XLA programs on the
// TPU: a whole engine tick (start the opened slots, then K chained node
// steps) is one launch, on the per-shard math of node_kernel.cuh.
// start_slots is the launch with K = 0, node_step the launch with no
// mask and K = 1.
//
// Bound: bytes, and below them the launch. A tick reads the state (11 +
// 2R bytes a shard), the open planes (6 bytes) and the inboxes (2R + 1)
// and writes the state and K outbox rows of 10 bytes: at S=4096 R=5 K=3
// about 0.3 MB, 0.0001 ms at the H100 SXM's 3.35 TB/s, far below a
// launch (a few microseconds). The arithmetic is a few dozen integer
// operations a shard a step.
//
// Design: one thread a shard, the K steps chained in registers. For
// R <= 64 the two ledgers live in registers as bit planes (MaskRow: the
// tallies are population counts); above 64 each ledger row is worked on
// in place in the output state (ByteRow), so any R runs. The state is
// read from `in` and written to `out`, which may be the same tensors (an
// update in place: each thread reads its shard before it writes it).
// The state fields and outbox planes are structure-of-arrays, so the
// scalar loads and stores of a warp are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "node_kernel.cuh"

namespace {

constexpr int THREADS = 128;

template <bool MASK>
__global__ void __launch_bounds__(THREADS)
node_cycle_kernel(nk::Ptrs in, nk::Ptrs out, nk::OutPtrs ob, nk::Inputs ip, int64_t S, int K,
                  nk::Params p) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (s < S) nk::cycle_shard<MASK>(in, out, ob, ip, S, K, s, p);
}

nk::Ptrs ptrs(void* const* f) {
    nk::Ptrs p;
    p.slot = static_cast<int32_t*>(f[0]);
    p.phase = static_cast<int32_t*>(f[1]);
    p.stage = static_cast<int8_t*>(f[2]);
    p.my_r1 = static_cast<int8_t*>(f[3]);
    p.my_r2 = static_cast<int8_t*>(f[4]);
    p.led1 = static_cast<int8_t*>(f[5]);
    p.led2 = static_cast<int8_t*>(f[6]);
    p.decided = static_cast<int8_t*>(f[7]);
    p.done = static_cast<uint8_t*>(f[8]);
    p.active = static_cast<uint8_t*>(f[9]);
    return p;
}

nk::OutPtrs out_ptrs(void* const* f) {
    nk::OutPtrs o{};
    if (f == nullptr) return o;
    o.cast_r2 = static_cast<uint8_t*>(f[0]);
    o.r2_vals = static_cast<int8_t*>(f[1]);
    o.advanced = static_cast<uint8_t*>(f[2]);
    o.new_r1 = static_cast<int8_t*>(f[3]);
    o.new_phase = static_cast<int32_t*>(f[4]);
    o.newly_decided = static_cast<uint8_t*>(f[5]);
    o.decided_vals = static_cast<int8_t*>(f[6]);
    return o;
}

}  // namespace

// One tick over S shards: `in` and `out` are the 10 fields of a
// NodeState (the reference's order: slot i32, phase i32, stage, my_r1,
// my_r2 i8 [S], led1, led2 i8 [S, R], decided i8, done, active u8 [S];
// contiguous; `out` may be `in`), `outbox` the 7 planes of a NodeOutbox
// (cast_r2 u8, r2_vals i8, advanced u8, new_r1 i8, new_phase i32,
// newly_decided u8, decided_vals i8, each [K, S]; may be null when
// K = 0). mask u8[S] (null: no slot opens), slot_index i32[S], init
// i8[S]; ib1, ib2 i8[S, R], dec i8[S] (the first step's inboxes; may be
// null when K = 0). me is the node's replica row; quorum and f1 from R;
// seed the coin seed masked to 32 bits; threshold = coin_threshold(p1).
// Launches on `stream`, returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int nk_node_cycle(void* const* in, void* const* out, void* const* outbox,
                             const void* mask, const void* slot_index, const void* init,
                             const void* ib1, const void* ib2, const void* dec, long long S,
                             int R, int K, int me, int quorum, int f1, unsigned int seed,
                             unsigned int threshold, void* stream) {
    if (S < 0 || R < 1 || K < 0 || quorum < 1 || f1 < 1 || (K > 0 && outbox == nullptr) ||
        (K > 0 && (ib1 == nullptr || ib2 == nullptr || dec == nullptr)) ||
        (mask != nullptr && (slot_index == nullptr || init == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (S == 0) return 0;
    nk::Inputs ip;
    ip.mask = static_cast<const uint8_t*>(mask);
    ip.slot_index = static_cast<const int32_t*>(slot_index);
    ip.init = static_cast<const int8_t*>(init);
    ip.ib1 = static_cast<const int8_t*>(ib1);
    ip.ib2 = static_cast<const int8_t*>(ib2);
    ip.dec = static_cast<const int8_t*>(dec);
    nk::Params p;
    p.R = R;
    p.me = me;
    p.quorum = quorum;
    p.f1 = f1;
    p.seed = seed;
    p.threshold = threshold;
    const unsigned blocks = static_cast<unsigned>((S + THREADS - 1) / THREADS);
    const auto st = static_cast<cudaStream_t>(stream);
    if (R <= nk::MASK_REPLICAS) {
        node_cycle_kernel<true><<<blocks, THREADS, 0, st>>>(ptrs(in), ptrs(out), out_ptrs(outbox),
                                                            ip, S, K, p);
    } else {
        node_cycle_kernel<false><<<blocks, THREADS, 0, st>>>(ptrs(in), ptrs(out),
                                                             out_ptrs(outbox), ip, S, K, p);
    }
    return static_cast<int>(cudaGetLastError());
}
