// The lockstep replica-parallel weak MVC window as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the reference's MeshPhaseKernel.slot_window and slot_pipeline
// (rabia_tpu/parallel/mesh.py), one jitted XLA program each: a map over
// the window's slots of a scan of phase_step. The per-(slot, shard) math
// is mesh_window.cuh.
//
// Bound: launch latency. At S=4096, R=5, T=16 the kernel moves 430 KB
// (votes T*S*R, alive S*R, base 4*S, decisions T*S), 0.13 us at the
// H100 SXM's 3.35 TB/s, and a fault-free entry decides in one phase of a
// few integer operations. A launch costs a few microseconds.
//
// Design: one thread per (t, s); a block takes 256 consecutive shards of
// one window entry, so its votes ([T, S, R] bytes) and alive rows are two
// contiguous byte runs. R-byte rows do not coalesce as per-thread loads,
// so the block stages both runs in shared memory with 16-byte loads,
// then each thread folds its rows into replica bitmasks and runs the
// phases on them in registers, stopping at the first deciding phase.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_window.cuh"

namespace {

constexpr int BLOCK = 256;

// Copy n bytes from src to shared memory so that src[0] lands at
// dst + (src & 15): 16-byte aligned pieces of the source then fill
// 16-byte aligned pieces of dst, and move as 16-byte loads; the unaligned
// head and tail move bytewise. dst is 16-byte aligned and has n + 16
// bytes. Returns where src[0] landed.
__device__ const uint8_t* stage(uint8_t* dst, const uint8_t* src, int n) {
    const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    const int head = min((16 - shift) & 15, n);
    const int body = (n - head) / 16;
    const int tail_at = head + 16 * body;
    uint8_t* out = dst + shift;
    const int4* src4 = reinterpret_cast<const int4*>(src + head);
    int4* dst4 = reinterpret_cast<int4*>(out + head);
    for (int i = threadIdx.x; i < body; i += blockDim.x) dst4[i] = src4[i];
    if (static_cast<int>(threadIdx.x) < head) out[threadIdx.x] = src[threadIdx.x];
    for (int i = tail_at + threadIdx.x; i < n; i += blockDim.x) out[i] = src[i];
    return out;
}

struct Params {
    int64_t S;
    int R, quorum, f1, max_phases, chunks;  // chunks: blocks per window entry
    uint32_t seed, threshold;
};

__global__ void __launch_bounds__(BLOCK)
mesh_window_kernel(const int8_t* votes, const uint8_t* alive, const int32_t* base,
                   int8_t* decided, Params p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int t = static_cast<int>(blockIdx.x / p.chunks);
    const int64_t s0 = static_cast<int64_t>(blockIdx.x % p.chunks) * BLOCK;
    const int n = static_cast<int>(min(static_cast<int64_t>(BLOCK), p.S - s0));
    const int R = p.R;
    const int region = BLOCK * R + 16;
    const uint8_t* sv = stage(smem, reinterpret_cast<const uint8_t*>(votes) + (t * p.S + s0) * R,
                              n * R);
    const uint8_t* sa = stage(smem + (region + 15) / 16 * 16, alive + s0 * R, n * R);
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= n) return;
    const int64_t s = s0 + i;
    const mw::Masks m = mw::row_masks(reinterpret_cast<const int8_t*>(sv) + i * R, sa + i * R, R);
    const uint32_t prefix = mw::coin_prefix(p.seed, static_cast<uint32_t>(s), mw::slot_of(base[s], t));
    decided[t * p.S + s] =
        static_cast<int8_t>(mw::decide(m, p.quorum, p.f1, prefix, p.threshold, p.max_phases));
}

// Does nothing: launched at the window's shape, it is the floor of a
// launch of its own, which chip_smoke.py times beside the window.
__global__ void empty_kernel() {}

}  // namespace

// votes i8[T, S, R], alive u8[S, R] (0 or 1), base i32[S], decided
// i8[T, S]; all contiguous. 1 <= R <= 64; quorum and f1 from R; seed is
// the coin seed masked to 32 bits; threshold = coin_threshold(coin_p1).
// Launches on `stream`, returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int mw_window(const void* votes, const void* alive, const void* base, void* decided,
                         long long T, long long S, int R, int quorum, int f1,
                         unsigned int seed, unsigned int threshold, int max_phases, void* stream) {
    if (T < 0 || S < 0 || R < 1 || R > mw::MAX_REPLICAS || max_phases < 0 || T > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (T == 0 || S == 0) return 0;
    Params p;
    p.S = S;
    p.R = R;
    p.quorum = quorum;
    p.f1 = f1;
    p.max_phases = max_phases;
    const int64_t chunks = (S + BLOCK - 1) / BLOCK;
    if (chunks * T > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    p.chunks = static_cast<int>(chunks);
    p.seed = seed;
    p.threshold = threshold;
    const int region = (BLOCK * R + 16 + 15) / 16 * 16;
    mesh_window_kernel<<<static_cast<unsigned>(chunks * T), BLOCK, 2 * region,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(votes), static_cast<const uint8_t*>(alive),
        static_cast<const int32_t*>(base), static_cast<int8_t*>(decided), p);
    return static_cast<int>(cudaGetLastError());
}

// The empty kernel at the grid mw_window launches for T x S; returns
// cudaGetLastError().
extern "C" int mw_empty(long long T, long long S, void* stream) {
    const long long blocks = (S + BLOCK - 1) / BLOCK * T;
    if (blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    empty_kernel<<<static_cast<unsigned>(blocks), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
