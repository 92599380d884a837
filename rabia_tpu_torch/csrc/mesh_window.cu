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
// Bound: the launch, then the bytes. At S=4096, R=5, T=16 a window
// moves 430,080 bytes (votes T*S*R, alive S*R, base 4*S, decisions
// T*S): 0.13 us at the H100 SXM's 3.35 TB/s when they lie in device
// memory; on the engine's path they cross the link instead, each byte
// once. A fault-free entry decides in one phase of a few integer
// operations. A launch costs a few microseconds.
//
// Design: one thread per (t, s); a block takes TB consecutive window
// entries of BS = 256 / TB consecutive shards (TB = 16 at the engine's
// T = 16, so BS = 16 and 256 blocks at S = 4096), so each replica
// block's votes are TB contiguous byte runs, its alive rows one, and the
// bases one: every byte of the window is read once, the alive rows and
// bases by one block for all its entries. R-byte rows do not coalesce as
// per-thread loads, so the block stages all its runs in shared memory as
// the aligned 16-byte chunks that cover them, every thread issuing a
// batch of its chunk loads before it stores or uses any; then each
// thread folds its rows into replica bitmasks and runs the phases on
// them in registers, stopping at the first deciding phase, and leaves its
// decision in a shared row, which a warp writes as 16-byte stores
// between the row's unaligned head and tail. TB is the largest power of
// two up to 16 and T whose staging fits 48 KB.
//
// One kernel serves device tensors and mapped host memory alike: the
// engine's window lies in a pinned host buffer (votes, alive rows, bases,
// decisions), which the launch reads and writes in place over the link
// through the buffer's device address (mw_device_pointer), so a window is
// one launch and one event with no copy. Over PCIe a 16-byte access is
// the smallest that does not waste most of a transaction, and a byte read
// twice crosses the link twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_window.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_TB = 16;  // window entries a block
constexpr int STATIC_SMEM = 48 * 1024;
// 16-byte loads a thread holds before it stores them
constexpr int HELD = 8;

__host__ __device__ __forceinline__ uintptr_t addr_of(const void* p) {
    return reinterpret_cast<uintptr_t>(p);
}

// Where a run's first byte lies from its 16-byte boundary.
__device__ __forceinline__ int landing(const void* p) { return static_cast<int>(addr_of(p) & 15); }

// The aligned 16-byte chunks that cover n bytes at p. A chunk that holds
// one byte of an allocation lies in that allocation's page, so reading the
// whole chunk is safe.
__device__ __forceinline__ int chunks_of(const void* p, int n) {
    return n > 0 ? (landing(p) + n + 15) / 16 : 0;
}

// The shared bytes of a run of BS rows of w bytes: its chunks at any landing.
__host__ __device__ __forceinline__ int region_of(int BS, int w) {
    return (BS * w + 31) / 16 * 16;
}

// A block's shared memory: B * (TB + 1) regions of votes and alive rows,
// one of bases, TB decided rows.
__host__ __device__ __forceinline__ int smem_of(int B, int Rb, int TB) {
    const int BS = BLOCK / TB;
    return B * (TB + 1) * region_of(BS, Rb) + region_of(BS, 4) + TB * region_of(BS, 1);
}

struct Params {
    int64_t S, vstride, astride;  // strides: bytes between replica blocks
    int B, Rb, quorum, f1, max_phases;
    int T, TB, BS, s_chunks;  // entries; entries and shards a block; blocks per entry row
    uint32_t seed, threshold, shard0;
};

// A run of the block's input: n bytes at src, staged at dst.
struct Run {
    const uint8_t* src;
    int n;
    uint8_t* dst;
};

__global__ void __launch_bounds__(BLOCK)
mesh_window_kernel(const int8_t* votes, const uint8_t* alive, const int32_t* base,
                   int8_t* decided, Params p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int64_t s0 = static_cast<int64_t>(blockIdx.x % p.s_chunks) * p.BS;
    const int t0 = static_cast<int>(blockIdx.x / p.s_chunks) * p.TB;
    const int n = static_cast<int>(min(static_cast<int64_t>(p.BS), p.S - s0));
    const int m = min(p.TB, p.T - t0);
    const int Rb = p.Rb;
    const int vreg = region_of(p.BS, Rb);
    uint8_t* bases = smem + p.B * (p.TB + 1) * vreg;
    uint8_t* rows = bases + region_of(p.BS, 4);
    const int drow = region_of(p.BS, 1);
    const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(votes);
    // run r < B * m: replica block r / m's votes of entry t0 + r % m;
    // B * m <= r < B * (m + 1): block r - B * m's alive rows; then the bases
    auto run_of = [&](int r) {
        Run u;
        if (r < p.B * m) {
            const int b = r / m, e = r % m;
            u.src = vsrc + b * p.vstride + ((t0 + e) * p.S + s0) * Rb;
            u.n = n * Rb;
            u.dst = smem + (b * p.TB + e) * vreg;
        } else if (r < p.B * (m + 1)) {
            const int b = r - p.B * m;
            u.src = alive + b * p.astride + s0 * Rb;
            u.n = n * Rb;
            u.dst = smem + (p.B * p.TB + b) * vreg;
        } else {
            u.src = reinterpret_cast<const uint8_t*>(base + s0);
            u.n = n * 4;
            u.dst = bases;
        }
        return u;
    };
    const int per_run = (p.BS * max(Rb, 4) + 30) / 16;  // the most chunks a run takes
    const int slots = (p.B * (m + 1) + 1) * per_run;
    const int i = threadIdx.x;
    for (int c0 = i; c0 < slots; c0 += HELD * BLOCK) {
        int4 v[HELD];
#pragma unroll
        for (int j = 0; j < HELD; ++j) {
            const int c = c0 + j * BLOCK;
            if (c < slots) {
                const Run u = run_of(c / per_run);
                const int k = c % per_run;
                if (k < chunks_of(u.src, u.n)) {
                    v[j] = reinterpret_cast<const int4*>(addr_of(u.src) & ~uintptr_t{15})[k];
                }
            }
        }
#pragma unroll
        for (int j = 0; j < HELD; ++j) {
            const int c = c0 + j * BLOCK;
            if (c < slots) {
                const Run u = run_of(c / per_run);
                const int k = c % per_run;
                if (k < chunks_of(u.src, u.n)) reinterpret_cast<int4*>(u.dst)[k] = v[j];
            }
        }
    }
    __syncthreads();
    const int e = i / p.BS, sl = i % p.BS;  // the thread's entry and shard in the block
    if (e < m && sl < n) {
        mw::Masks mk{0, 0, 0};
        for (int b = 0; b < p.B; ++b) {
            const Run uv = run_of(b * m + e), ua = run_of(p.B * m + b);
            const uint8_t* sv = uv.dst + landing(uv.src) + sl * Rb;
            const uint8_t* sa = ua.dst + landing(ua.src) + sl * Rb;
            const mw::Masks q = mw::row_masks(reinterpret_cast<const int8_t*>(sv), sa, Rb);
            mk.v0 |= q.v0 << (b * Rb);
            mk.v1 |= q.v1 << (b * Rb);
            mk.alive |= q.alive << (b * Rb);
        }
        const Run ub = run_of(p.B * (m + 1));
        const int32_t first = *reinterpret_cast<const int32_t*>(ub.dst + landing(ub.src) + 4 * sl);
        const uint32_t prefix = mw::coin_prefix(p.seed, p.shard0 + static_cast<uint32_t>(s0 + sl),
                                                mw::slot_of(first, t0 + e));
        const int8_t* dst = decided + (t0 + e) * p.S + s0;
        rows[e * drow + landing(dst) + sl] = static_cast<uint8_t>(
            mw::decide(mk, p.quorum, p.f1, prefix, p.threshold, p.max_phases));
    }
    __syncthreads();
    // a warp a decided row: its unaligned head and tail bytewise, the
    // rest as 16-byte stores (the row lands where dst does modulo 16)
    const int lane = i % 32;
    for (int r = i / 32; r < m; r += BLOCK / 32) {
        uint8_t* out = reinterpret_cast<uint8_t*>(decided + (t0 + r) * p.S + s0);
        const uint8_t* row = rows + r * drow + landing(out);
        const int head = min((16 - landing(out)) & 15, n);
        const int body = (n - head) / 16;
        for (int j = lane; j < head; j += 32) out[j] = row[j];
        for (int c = lane; c < body; c += 32) {
            reinterpret_cast<int4*>(out + head)[c] = reinterpret_cast<const int4*>(row + head)[c];
        }
        for (int j = head + 16 * body + lane; j < n; j += 32) out[j] = row[j];
    }
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
    p.T = static_cast<int>(T);
    p.TB = MAX_TB;
    while (p.TB > 1 && (p.TB > T || smem_of(B, Rb, p.TB) > STATIC_SMEM)) p.TB /= 2;
    p.BS = BLOCK / p.TB;
    const int64_t s_chunks = (S + p.BS - 1) / p.BS;
    const int64_t blocks = s_chunks * ((T + p.TB - 1) / p.TB);
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    p.s_chunks = static_cast<int>(s_chunks);
    p.seed = seed;
    p.threshold = threshold;
    p.shard0 = shard0;
    // at most 36,128 bytes (B * Rb <= 64)
    const int smem = smem_of(B, Rb, p.TB);
    mesh_window_kernel<<<static_cast<unsigned>(blocks), BLOCK, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(votes), static_cast<const uint8_t*>(alive),
        static_cast<const int32_t*>(base), static_cast<int8_t*>(decided), p);
    return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory at `host` (its first byte) in
// *dev; returns cudaHostGetDevicePointer's error (0 on success).
extern "C" int mw_device_pointer(void* host, void** dev) {
    return static_cast<int>(cudaHostGetDevicePointer(dev, host, 0));
}

// The empty kernel at the grid mw_window launches for T x S; returns
// cudaGetLastError().
extern "C" int mw_empty(long long T, long long S, void* stream) {
    int TB = MAX_TB;
    while (TB > 1 && TB > T) TB /= 2;
    const long long blocks = (S + BLOCK / TB - 1) / (BLOCK / TB) * ((T + TB - 1) / TB);
    if (blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    empty_kernel<<<static_cast<unsigned>(blocks), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
