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
// Where the bytes lie. The node's state stays on the card (the tick
// buffer, updated in place by the engine's tick). The tick's six input
// planes lie in one pinned host buffer that the host writes, and the
// results the host reads (the eight state fields it mirrors and the K
// outbox rows) go to a pinned host image: the kernel reads and writes
// both over the link, mapped into the card's address space
// (cudaHostGetDevicePointer), so a tick is one launch and one event with
// no copy before or after it. The outbox also goes to the tick buffer on
// the card, where the launch's NodeOutbox views it.
//
// Bound: the link, and below it the launch. At S=4096 R=5 K=3 a tick
// reads 17 bytes a shard of planes (2R + 7; 69,632 bytes) and writes 14
// bytes of mirrored state and 10K of outbox (180,224 bytes) over the
// link, and moves 2 x (11 + 2R) bytes of state and 10K of outbox a shard
// in HBM (294,912 bytes, 0.09 us at the H100 SXM's 3.35 TB/s). The
// arithmetic is a few dozen integer operations a shard a step.
//
// Design: per-thread byte loads of an R-byte inbox row and 1-byte stores
// to [K, S] planes are one small PCIe transaction each, so a block of T
// shards stages its rows of the six planes into shared memory with
// 16-byte loads, a batch issued before any is used, runs one thread a
// shard on the tile (the K steps chained in registers; for R <= 64 the
// two ledgers as bit planes, MaskRow, above that worked on in place in
// the state, ByteRow), and writes its outbox rows and mirrored fields
// back from the tile as 16-byte stores, a warp a run (node_kernel.cuh's
// tile section). The tile takes (2R + 7 + 14 + 10K) bytes a shard plus
// 16 an input run: 7,904 bytes at T = 128, R = 5, K = 3. T is 128 (32 blocks
// at S = 4096: the link's latency, not the SMs, sets the time, and 128
// shards give each input run 8 to 40 full 16-byte loads), halved down
// to 32 while the tile passes 48 KB; above that the tile takes dynamic
// shared memory up to the SM's 227 KB. The state is read from `in` and
// written to `out`, which may be the same tensors (each thread reads its
// shard before it writes it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "node_kernel.cuh"

namespace {

constexpr int MAX_THREADS = 128;
constexpr int64_t STATIC_SMEM = 48 * 1024;
constexpr int64_t MAX_SMEM = 227 * 1024;

template <bool MASK>
__global__ void __launch_bounds__(MAX_THREADS)
node_cycle_kernel(nk::Ptrs in, nk::Ptrs out, nk::OutPtrs ob, nk::Inputs ip, nk::Ptrs img,
                  nk::OutPtrs iob, int64_t S, int K, nk::Params p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int T = static_cast<int>(blockDim.x);
    const int tid = static_cast<int>(threadIdx.x);
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * T;
    const int n = static_cast<int>(min(static_cast<int64_t>(T), S - s0));
    const nk::Tile tile = nk::carve(smem, T, p.R, K);
    nk::stage_in(tile, ip, s0, n, p.R, tid, T);
    __syncthreads();
    if (tid < n) {
        nk::cycle_tile<MASK>(in, out, tile, nk::tile_inputs(tile, ip, s0, p.R), T, K, s0, tid, p);
    }
    __syncthreads();
    nk::put_out(tile, ob, img, iob, S, s0, n, T, K, tid, T);
}

// Does nothing: launched at the tick's grid and shared memory, it is the
// floor of a launch of its own, which chip_smoke.py times beside the tick.
__global__ void empty_kernel() {}

// The threads a block and the tile's bytes for S x R x K.
int threads_for(int R, int K) {
    int T = MAX_THREADS;
    while (T > 32 && nk::tile_bytes(T, R, K) > STATIC_SMEM) T /= 2;
    return T;
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

// base + off, or null where off < 0.
uint8_t* at(uint8_t* base, long long off) { return off < 0 ? nullptr : base + off; }

template <bool MASK>
int launch(unsigned blocks, int T, int64_t smem, cudaStream_t st, const nk::Ptrs& in,
           const nk::Ptrs& out, const nk::OutPtrs& ob, const nk::Inputs& ip, const nk::Ptrs& img,
           const nk::OutPtrs& iob, int64_t S, int K, const nk::Params& p) {
    if (smem > STATIC_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            node_cycle_kernel<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    node_cycle_kernel<MASK><<<blocks, T, static_cast<size_t>(smem), st>>>(in, out, ob, ip, img,
                                                                          iob, S, K, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One tick over S shards: `in` and `out` are the 10 fields of a
// NodeState on the card (the reference's order: slot i32, phase i32,
// stage, my_r1, my_r2 i8 [S], led1, led2 i8 [S, R], decided i8, done,
// active u8 [S]; contiguous; `out` may be `in`), `outbox` the 7 planes of
// a NodeOutbox on the card (cast_r2 u8, r2_vals i8, advanced u8, new_r1
// i8, new_phase i32, newly_decided u8, decided_vals i8, each [K, S]; may
// be null when K = 0).
//
// `planes` is the host address of a pinned buffer that holds the tick's
// planes at the byte offsets plane_off (-1: the tick has no such plane):
// mask u8[S] (absent: no slot opens), slot_index i32[S], init i8[S], ib1,
// ib2 i8[S, R] and dec i8[S] (the first step's inboxes; absent only when
// K = 0). `image` is the host address of a pinned buffer that takes the
// results at the byte offsets image_off: the 8 mirrored fields (slot,
// phase, stage, my_r1, my_r2, decided, done, active, each [S]), then the
// 7 outbox planes (each [image_K, S], image_K >= K). The kernel reads
// and writes both through their device addresses
// (cudaHostGetDevicePointer; its error is returned). me is the node's replica row; quorum and f1 from R; seed the
// coin seed masked to 32 bits; threshold = coin_threshold(p1). Launches
// on `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int nk_node_cycle(void* const* in, void* const* out, void* const* outbox, void* planes,
                             const long long* plane_off, void* image, const long long* image_off,
                             int image_K, long long S, int R, int K, int me, int quorum, int f1,
                             unsigned int seed, unsigned int threshold, void* stream) {
    if (S < 0 || R < 1 || K < 0 || quorum < 1 || f1 < 1 || image == nullptr ||
        plane_off == nullptr || image_off == nullptr || (K > 0 && outbox == nullptr) ||
        (K > 0 && (plane_off[3] < 0 || plane_off[4] < 0 || plane_off[5] < 0)) ||
        (plane_off[0] >= 0 && (plane_off[1] < 0 || plane_off[2] < 0)) ||
        image_K < K) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (S == 0) return 0;
    uint8_t* pdev = nullptr;
    bool any_plane = false;
    for (int r = 0; r < nk::IN_RUNS; ++r) any_plane = any_plane || plane_off[r] >= 0;
    if (any_plane) {
        if (planes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&pdev), planes, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    uint8_t* idev = nullptr;
    {
        const cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&idev), image, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    nk::Inputs ip;
    ip.mask = at(pdev, plane_off[0]);
    ip.slot_index = reinterpret_cast<const int32_t*>(at(pdev, plane_off[1]));
    ip.init = reinterpret_cast<const int8_t*>(at(pdev, plane_off[2]));
    ip.ib1 = reinterpret_cast<const int8_t*>(at(pdev, plane_off[3]));
    ip.ib2 = reinterpret_cast<const int8_t*>(at(pdev, plane_off[4]));
    ip.dec = reinterpret_cast<const int8_t*>(at(pdev, plane_off[5]));
    if (K == 0) {  // no step reads the inboxes
        ip.ib1 = ip.ib2 = nullptr;
        ip.dec = nullptr;
    }
    nk::Ptrs img{};
    img.slot = reinterpret_cast<int32_t*>(idev + image_off[0]);
    img.phase = reinterpret_cast<int32_t*>(idev + image_off[1]);
    img.stage = reinterpret_cast<int8_t*>(idev + image_off[2]);
    img.my_r1 = reinterpret_cast<int8_t*>(idev + image_off[3]);
    img.my_r2 = reinterpret_cast<int8_t*>(idev + image_off[4]);
    img.decided = reinterpret_cast<int8_t*>(idev + image_off[5]);
    img.done = idev + image_off[6];
    img.active = idev + image_off[7];
    img.led1 = img.led2 = nullptr;
    nk::OutPtrs iob{};
    if (K > 0) {
        iob.cast_r2 = idev + image_off[8];
        iob.r2_vals = reinterpret_cast<int8_t*>(idev + image_off[9]);
        iob.advanced = idev + image_off[10];
        iob.new_r1 = reinterpret_cast<int8_t*>(idev + image_off[11]);
        iob.new_phase = reinterpret_cast<int32_t*>(idev + image_off[12]);
        iob.newly_decided = idev + image_off[13];
        iob.decided_vals = reinterpret_cast<int8_t*>(idev + image_off[14]);
    }
    nk::Params p;
    p.R = R;
    p.me = me;
    p.quorum = quorum;
    p.f1 = f1;
    p.seed = seed;
    p.threshold = threshold;
    const int T = threads_for(R, K);
    const int64_t smem = nk::tile_bytes(T, R, K);
    if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((S + T - 1) / T);
    const auto st = static_cast<cudaStream_t>(stream);
    const nk::Ptrs pin = ptrs(in), pout = ptrs(out);
    const nk::OutPtrs ob = out_ptrs(K > 0 ? outbox : nullptr);
    return R <= nk::MASK_REPLICAS
               ? launch<true>(blocks, T, smem, st, pin, pout, ob, ip, img, iob, S, K, p)
               : launch<false>(blocks, T, smem, st, pin, pout, ob, ip, img, iob, S, K, p);
}

// The empty kernel at the grid and shared memory nk_node_cycle launches
// for S x R x K (within 48 KB); returns cudaGetLastError().
extern "C" int nk_empty(long long S, int R, int K, void* stream) {
    if (S < 1 || R < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int T = threads_for(R, K);
    const int64_t smem = nk::tile_bytes(T, R, K);
    if (smem > STATIC_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    empty_kernel<<<static_cast<unsigned>((S + T - 1) / T), T, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
