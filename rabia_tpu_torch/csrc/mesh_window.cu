// The lockstep replica-parallel weak MVC window as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the reference's MeshPhaseKernel.slot_window and slot_pipeline
// (rabia_tpu/parallel/mesh.py), one jitted XLA program each: a map over
// the window's slots of a scan of phase_step. The per-(slot, shard) math
// is mesh_window.cuh.
//
// Over a (shard x replica) mesh the reference's phase_step exchanges each
// round's votes with an all_gather over the replica axis. A replica's
// next fields depend only on its own and on the tallies of its whole
// row, so once a shard block's window votes and alive rows have been
// gathered over the replica axis (one exchange a window), the window is
// this kernel's function of them: the launch reads the votes and alive
// rows in the B replica blocks that the gather leaves ([B, T, S, R/B]
// and [B, S, R/B], each block at its own stride, so nothing is copied
// into [T, S, R] first), and numbers its shards from shard0, the block's
// first global shard, which keys the common coin. B = 1 with shard0 = 0
// is one device's [T, S, R] window.
//
// Bound: launch latency. At S=4096, R=5, T=16 the kernel moves 430 KB
// (votes T*S*R, alive S*R, base 4*S, decisions T*S), 0.13 us at the
// H100 SXM's 3.35 TB/s, and a fault-free entry decides in one phase of a
// few integer operations. A launch costs a few microseconds.
//
// Design: one thread per (t, s); a block takes 256 consecutive shards of
// one window entry, so in each replica block its votes and alive rows are
// two contiguous byte runs. R-byte rows do not coalesce as per-thread
// loads, so the block stages the 2 * B runs in shared memory with 16-byte
// loads, then each thread folds its rows into replica bitmasks and runs
// the phases on them in registers, stopping at the first deciding phase.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_window.cuh"

namespace {

constexpr int BLOCK = 256;

// Where stage() lands src[0] in its region: src's offset from 16 bytes.
__device__ __forceinline__ int landing(const uint8_t* src) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Copy n bytes from src to shared memory so that src[0] lands at
// dst + landing(src): 16-byte aligned pieces of the source then fill
// 16-byte aligned pieces of dst, and move as 16-byte loads; the unaligned
// head and tail move bytewise. dst is 16-byte aligned and has n + 16
// bytes.
__device__ void stage(uint8_t* dst, const uint8_t* src, int n) {
    const int shift = landing(src);
    const int head = min((16 - shift) & 15, n);
    const int body = (n - head) / 16;
    const int tail_at = head + 16 * body;
    uint8_t* out = dst + shift;
    const int4* src4 = reinterpret_cast<const int4*>(src + head);
    int4* dst4 = reinterpret_cast<int4*>(out + head);
    for (int i = threadIdx.x; i < body; i += blockDim.x) dst4[i] = src4[i];
    if (static_cast<int>(threadIdx.x) < head) out[threadIdx.x] = src[threadIdx.x];
    for (int i = tail_at + threadIdx.x; i < n; i += blockDim.x) out[i] = src[i];
}

struct Params {
    int64_t S, vstride, astride;  // strides: bytes between replica blocks
    int B, Rb, quorum, f1, max_phases, chunks;  // chunks: blocks per window entry
    uint32_t seed, threshold, shard0;
};

__global__ void __launch_bounds__(BLOCK)
mesh_window_kernel(const int8_t* votes, const uint8_t* alive, const int32_t* base,
                   int8_t* decided, Params p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int t = static_cast<int>(blockIdx.x / p.chunks);
    const int64_t s0 = static_cast<int64_t>(blockIdx.x % p.chunks) * BLOCK;
    const int n = static_cast<int>(min(static_cast<int64_t>(BLOCK), p.S - s0));
    const int Rb = p.Rb;
    const int region = (BLOCK * Rb + 16 + 15) / 16 * 16;  // a run and 16 bytes of slack
    // replica block b's runs: its votes in region b, its alive rows in
    // region B + b, each where stage() lands it
    const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(votes) + (t * p.S + s0) * Rb;
    const uint8_t* asrc = alive + s0 * Rb;
    for (int b = 0; b < p.B; ++b) {
        stage(smem + b * region, vsrc + b * p.vstride, n * Rb);
        stage(smem + (p.B + b) * region, asrc + b * p.astride, n * Rb);
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= n) return;
    mw::Masks m{0, 0, 0};
    for (int b = 0; b < p.B; ++b) {
        const uint8_t* sv = smem + b * region + landing(vsrc + b * p.vstride) + i * Rb;
        const uint8_t* sa = smem + (p.B + b) * region + landing(asrc + b * p.astride) + i * Rb;
        const mw::Masks q = mw::row_masks(reinterpret_cast<const int8_t*>(sv), sa, Rb);
        m.v0 |= q.v0 << (b * Rb);
        m.v1 |= q.v1 << (b * Rb);
        m.alive |= q.alive << (b * Rb);
    }
    const int64_t s = s0 + i;
    const uint32_t prefix = mw::coin_prefix(p.seed, p.shard0 + static_cast<uint32_t>(s),
                                            mw::slot_of(base[s], t));
    decided[t * p.S + s] =
        static_cast<int8_t>(mw::decide(m, p.quorum, p.f1, prefix, p.threshold, p.max_phases));
}

// Does nothing: launched at the window's shape, it is the floor of a
// launch of its own, which chip_smoke.py times beside the window.
__global__ void empty_kernel() {}

}  // namespace

// votes i8[B, T, S, Rb] and alive u8[B, S, Rb] (0 or 1): the window's
// R = B * Rb replicas in B blocks, block b holding replicas b * Rb ..
// b * Rb + Rb - 1; within a block the rows are contiguous, and block b
// starts vstride (votes) and astride (alive) bytes after block b - 1 (B = 1
// is votes i8[T, S, R] and alive u8[S, R], the strides unread). base
// i32[S] and decided i8[T, S] contiguous. Shard s of the launch is global
// shard shard0 + s (uint32, the coin's shard coordinate). 1 <= R <= 64;
// quorum and f1 from R; seed is the coin seed masked to 32 bits;
// threshold = coin_threshold(coin_p1). Launches on `stream`, returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int mw_window(const void* votes, const void* alive, const void* base, void* decided,
                         long long T, long long S, int B, int Rb, long long vstride,
                         long long astride, unsigned int shard0, int quorum, int f1,
                         unsigned int seed, unsigned int threshold, int max_phases, void* stream) {
    if (T < 0 || S < 0 || B < 1 || Rb < 1 || static_cast<long long>(B) * Rb > mw::MAX_REPLICAS ||
        max_phases < 0 || T > INT32_MAX || vstride < 0 || astride < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (T == 0 || S == 0) return 0;
    Params p;
    p.S = S;
    p.vstride = vstride;
    p.astride = astride;
    p.B = B;
    p.Rb = Rb;
    p.quorum = quorum;
    p.f1 = f1;
    p.max_phases = max_phases;
    const int64_t chunks = (S + BLOCK - 1) / BLOCK;
    if (chunks * T > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    p.chunks = static_cast<int>(chunks);
    p.seed = seed;
    p.threshold = threshold;
    p.shard0 = shard0;
    // 2 * B runs of at most BLOCK * Rb bytes: at most 36,864 bytes (B * Rb <= 64)
    const int region = (BLOCK * Rb + 16 + 15) / 16 * 16;
    mesh_window_kernel<<<static_cast<unsigned>(chunks * T), BLOCK, 2 * B * region,
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
