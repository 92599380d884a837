// The scanned weak-MVC protocol as CUDA kernels for Hopper (sm_90a).
//
// Replaces the reference's ClusterKernel.round_step
// (rabia_tpu/kernel/phase_driver.py:234), one XLA program a round, and
// the lax.scan loops over it: run_rounds (:386, n rounds under lossy
// delivery) and slot_pipeline / slot_pipeline_wide (:420 and :466, every
// slot, rounds_per_slot rounds of full delivery each). The per-shard
// math is cluster_round.cuh; its common coin is mesh_window.cuh's.
// cr_rounds and cr_slot_pipeline take shard0, the global index of their
// first shard: a block of a mesh's shard axis (ShardedClusterKernel) runs
// them on its own shards with the coin of the whole mesh's numbering.
// cr_start_slot draws no coin and reads no shard coordinate.
//
// cr_rounds (run_rounds, round_step). Bound: bytes. The function must
// read and write each shard's 13 state fields (110 bytes at R=5), read
// the alive rows and the delivery masks of the rounds it runs (R*R bytes
// a shard a round; at S=4096 R=5 and 80 rounds, 8.2 MB), about 9.2 MB,
// 0.0027 ms at the H100 SXM's 3.35 TB/s. A round is a few hundred integer
// operations a shard, below that. But the rounds are a dependent chain,
// so the time is the chain's latency: each link is to be short. A shard
// whose live replicas have all decided is a fixed point
// (cluster_round.cuh, (d)), so its later rounds need no work and no mask.
// Design, R <= 8 (rounds_lanes_kernel): one 8-lane segment a shard, four
// shards a warp, lane j receiver j (cluster_round.cuh, the round by
// receivers): its phase, stage, votes and ledgers in registers, its
// delivery, tally, transition and coin in parallel with the others'.
// What crosses receivers is ballots and width-8 shuffles: every sender's
// codes, stage and phase before delivery, the shard's decision (the
// largest value, the least phase) and its done set after the
// transitions. A block of 4 warps (16 shards; 256 blocks at S=4096, so
// every SM has work) stages its shards' masks into shared memory with
// cp.async, 16 rounds at a time in a ring of two, the next 16 in flight
// while these run; lane j turns round k's bytes into its sender bitmask
// from shared memory, so no round waits on device memory. A warp stops
// once its four shards have settled, a block once its warps have. For
// R > 8 (rounds_kernel) one thread a shard runs round() on 64-bit masks,
// its arrays in local memory.
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
//
// cr_start_slot (start_slot, :201). Bound: bytes. The function writes a
// shard's 13 fields (110 bytes at R=5) and reads its mask, slot and
// active; a masked shard also reads its R votes, an unmasked one the
// rest of its fields. At S=4096 R=5 with every shard masked (the main
// path's call), 0.50 MB, 0.00015 ms at 3.35 TB/s; with none masked,
// 0.91 MB; either lies below a launch, so the time is the launch and one
// dependent read and write of device memory. Design (cluster_round.cuh,
// ss::): the fields' planes as flat bytes, 16 a thread, stored as one
// 16-byte vector each (a warp's 32 stores are 512 contiguous bytes),
// the [S] fields 16 shards a thread; a vector finds its shard by a 32-bit
// multiply-shift, never a 64-bit division. Every thread issues its loads
// together and then its one store, in one wave of CTAs. Any R up to
// ss::MAX_R; ragged ends and unaligned planes element by element. A
// mesh's shard blocks on one device go in one launch: the kernel's
// parameter is a table of up to ss::MAX_BLOCKS blocks' field pointers,
// blockIdx.y the block (cr_start_slot_blocks).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_round.cuh"

namespace ss = cr::ss;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ROUNDS_BLOCK = 64;  // R > 8: one thread a shard
constexpr int PIPE_BLOCK = 256;
constexpr int LANES_WARPS = 4;                      // R <= 8: a block of 4 warps,
constexpr int LANES_SHARDS = 4 * LANES_WARPS;       // 4 shards a warp
constexpr int LANES_CHUNK = 16;                     // rounds of masks staged at once
constexpr int ROUND_BYTES = LANES_SHARDS * cr::LANE_RM * cr::LANE_RM;  // a round's masks, R <= 8

struct Params {
    int64_t S, T, mask_stride;
    int R, n, quorum, f1;
    int32_t base;
    uint32_t seed, threshold, shard0;  // shard0: the coin's shard coordinate of shard 0
};

template <typename M, int RM>
__global__ void __launch_bounds__(ROUNDS_BLOCK)
rounds_kernel(cr::Ptrs in, cr::Ptrs out, const uint8_t* __restrict__ alive,
              const uint8_t* __restrict__ masks, Params p) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (s >= p.S) return;
    cr::rounds_shard<M, RM>(in, out, alive, masks, p.mask_stride, p.n, s, p.R, p.quorum, p.f1,
                            p.seed, p.threshold, p.shard0);
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bits of one shard's segment (lanes off..off+7) of a warp-wide ballot.
__device__ __forceinline__ uint32_t seg_bits(bool b, int off, uint32_t keep) {
    return (__ballot_sync(FULL, b) >> off) & keep;
}

// Rounds k0..k0+nk-1 of the block's nsh shards' masks (the block's bytes
// of each round are contiguous: [shard, sender, receiver]) into buf,
// round k at k * ROUND_BYTES. With async16 (masks and their round stride
// 16-byte aligned) as cp.async pieces, the last of a round zero-filled;
// else as byte loads and stores.
__device__ void stage_masks(uint8_t* buf, const uint8_t* masks, int64_t stride, int k0, int nk,
                            int64_t s0, int nsh, int R, bool async16) {
    const int per_round = nsh * R * R;
    const uint8_t* src0 = masks + static_cast<int64_t>(k0) * stride + s0 * R * R;
    if (async16) {
        const int pieces = (per_round + 15) / 16;
        for (int i = threadIdx.x; i < nk * pieces; i += blockDim.x) {
            const int k = i / pieces, c = i - k * pieces;
            const int bytes = min(16, per_round - 16 * c);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                             sptr(buf + k * ROUND_BYTES + 16 * c)),
                         "l"(src0 + k * stride + 16 * c), "r"(bytes)
                         : "memory");
        }
        return;
    }
    for (int i = threadIdx.x; i < nk * per_round; i += blockDim.x) {
        const int k = i / per_round, c = i - k * per_round;
        buf[k * ROUND_BYTES + c] = src0[k * stride + c];
    }
}

// One round of the shard of lane j's segment (lanes off..off+7), lane j
// receiver j: cluster_round.cuh's round by receivers, its exchanges as
// ballots and shuffles within the segment. alive: the shard's live
// replicas; din: receiver j's senders this round.
__device__ __forceinline__ void round_lane(cr::RLane& x, cr::Scalars& c, int j, int off, int R,
                                           uint32_t all, uint32_t alive, bool alive_j,
                                           uint32_t din, uint32_t prefix, const Params& p) {
    cr::View v;  // (a) every sender's offers, and its phase
    v.r1lo = seg_bits(x.r1 & 1, off, all);
    v.r1hi = seg_bits(x.r1 & 2, off, all);
    v.r2lo = seg_bits(x.r2 & 1, off, all);
    v.r2hi = seg_bits(x.r2 & 2, off, all);
    v.p1lo = seg_bits(x.p1 & 1, off, all);
    v.p1hi = seg_bits(x.p1 & 2, off, all);
    v.p2lo = seg_bits(x.p2 & 1, off, all);
    v.p2hi = seg_bits(x.p2 & 2, off, all);
    v.st2 = seg_bits(x.st2, off, all);
    int32_t ph[cr::LANE_RM];
#pragma unroll
    for (int i = 0; i < cr::LANE_RM; ++i) ph[i] = __shfl_sync(FULL, x.phase, i, cr::LANE_RM);
    uint32_t same, ahead;
    cr::phase_masks(ph, R, x.phase, same, ahead);
    const bool open = alive_j && !x.done;
    cr::deliver_lane(x, v, all, same, ahead, open ? din & alive & ~(1u << j) : 0u);
    int32_t at;
    const int d = cr::step_lane(x, j, all, c.active && open, p.quorum, p.f1, prefix, p.threshold,
                                at);
    // (b) the largest value decided, the least phase it was decided at
    const unsigned any = __ballot_sync(FULL, d >= 0), v1 = __ballot_sync(FULL, d == cr::V1);
    const uint32_t d1 = (v1 >> off) & 0xFFu, d0 = ((any & ~v1) >> off) & 0xFFu;
    if (any != 0) {
#pragma unroll
        for (int o = cr::LANE_RM / 2; o > 0; o >>= 1) {
            const int32_t y = __shfl_xor_sync(FULL, at, o, cr::LANE_RM);
            at = y < at ? y : at;
        }
    }
    cr::merge_decision(c, d1 ? cr::V1 : d0 ? cr::V0 : -1, at);
    // (c) the done set after the transitions, then propagation
    const uint32_t done = seg_bits(x.done, off, all);
    if (cr::adopts(c, alive_j, x, din, done, alive)) x.done = true;
}

// cr_rounds for R <= 8: one 8-lane segment a shard (see the top).
__global__ void __launch_bounds__(32 * LANES_WARPS)
rounds_lanes_kernel(cr::Ptrs in, cr::Ptrs out, const uint8_t* __restrict__ alive,
                    const uint8_t* __restrict__ masks, Params p) {
    __shared__ __align__(16) uint8_t ring[2][LANES_CHUNK * ROUND_BYTES];
    const int lane = threadIdx.x & 31, j = lane & 7, off = lane & ~7;
    const int sh = (threadIdx.x >> 5) * 4 + (lane >> 3);  // the shard within the block
    const int R = p.R;
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * LANES_SHARDS, s = s0 + sh;
    const bool mine = s < p.S && j < R;  // lane j is a receiver of a shard of the launch
    const uint32_t all = cr::all_of<uint32_t>(R);
    // the masks: none (full delivery), one for every round, or staged; the
    // first chunk's copies are issued before the state loads
    const bool staged = masks != nullptr && p.mask_stride != 0;
    const int nsh = static_cast<int>(p.S - s0 < LANES_SHARDS ? p.S - s0 : LANES_SHARDS);
    const bool async16 = staged && (reinterpret_cast<uintptr_t>(masks) & 15) == 0 &&
                         p.mask_stride % 16 == 0;
    if (staged) {
        stage_masks(ring[0], masks, p.mask_stride, 0, min(LANES_CHUNK, p.n), s0, nsh, R, async16);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    cr::RLane x{};
    cr::Scalars c{};
    if (s < p.S) cr::load_scalars(c, in, s);
    if (mine) cr::load_lane(x, in, s, j, R);
    const bool alive_j = mine && alive[s * R + j] != 0;
    const uint32_t a = seg_bits(alive_j, off, all);
    const uint32_t prefix = mw::coin_prefix(p.seed, p.shard0 + static_cast<uint32_t>(s),
                                            static_cast<uint32_t>(c.slot));
    uint32_t din = all;
    if (masks != nullptr && !staged && mine) din = cr::din_of(masks + s * R * R, R, j);
    bool settled = __all_sync(FULL, !(alive_j && !x.done));  // (d), over the warp's shards
    for (int k0 = 0; k0 < p.n; k0 += LANES_CHUNK) {
        const int nk = min(LANES_CHUNK, p.n - k0);
        const uint8_t* col = ring[(k0 / LANES_CHUNK) & 1] + sh * R * R + j;
        if (staged) {  // the next chunk in flight, this one landed and visible
            if (k0 + LANES_CHUNK < p.n) {
                stage_masks(ring[((k0 / LANES_CHUNK) & 1) ^ 1], masks, p.mask_stride,
                            k0 + LANES_CHUNK, min(LANES_CHUNK, p.n - k0 - LANES_CHUNK), s0, nsh,
                            R, async16);
            }
            asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
            __syncthreads();
        }
        for (int k = 0; k < nk && !settled; ++k) {
            if (staged) {  // receiver j's senders: column j of round k's R x R bytes
                din = 0;
#pragma unroll
                for (int i = 0; i < cr::LANE_RM; ++i)
                    din |= i < R && col[k * ROUND_BYTES + i * R] != 0 ? 1u << i : 0u;
            }
            round_lane(x, c, j, off, R, all, a, alive_j, din, prefix, p);
            settled = __all_sync(FULL, !(alive_j && !x.done));
        }
        // every warp is done with this chunk's buffer before it is refilled
        if (staged ? __syncthreads_and(settled) != 0 : settled) break;
    }
    if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (s < p.S && j == 0) cr::store_scalars(c, out, s);
    if (mine) cr::store_lane(x, out, s, j, R);
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
        cr::decide_chunk<R>(v, at, q, p.n, p.seed, p.threshold,
                            p.shard0 + static_cast<uint32_t>(s0),
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
        const uint32_t prefix = mw::coin_prefix(p.seed, p.shard0 + static_cast<uint32_t>(s),
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

// ClusterKernel.start_slot over a table of shard blocks
// (cluster_round.cuh, ss::thread): the table is the kernel's parameter,
// read in place from the parameter bank.
static_assert(sizeof(ss::Args) <= 4000, "the table must fit a kernel's 4 KB of parameters");

__global__ void __launch_bounds__(ss::THREADS)
start_slot_kernel(const __grid_constant__ ss::Args a) {
    ss::thread(a, blockIdx.x, blockIdx.y, threadIdx.x);
}

// The same grid and parameter doing nothing: the launch's own time.
__global__ void __launch_bounds__(ss::THREADS)
start_slot_empty_kernel(const __grid_constant__ ss::Args a) {}

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
// synchronise. Shard s is global shard shard0 + s in the common coin (a
// block of a mesh's shard axis; 0 on one device).
extern "C" int cr_rounds(void* const* in, void* const* out, const void* alive, const void* masks,
                         long long mask_stride, int n, long long S, int R, int quorum, int f1,
                         unsigned int seed, unsigned int threshold, unsigned int shard0,
                         void* stream) {
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
    p.shard0 = shard0;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* a = static_cast<const uint8_t*>(alive);
    const auto* m = static_cast<const uint8_t*>(masks);
    if (R <= cr::LANE_RM) {
        const auto blocks = static_cast<unsigned>((S + LANES_SHARDS - 1) / LANES_SHARDS);
        rounds_lanes_kernel<<<blocks, 32 * LANES_WARPS, 0, st>>>(ptrs(in), ptrs(out), a, m, p);
    } else {
        const auto blocks = static_cast<unsigned>((S + ROUNDS_BLOCK - 1) / ROUNDS_BLOCK);
        rounds_kernel<uint64_t, 64><<<blocks, ROUNDS_BLOCK, 0, st>>>(ptrs(in), ptrs(out), a, m, p);
    }
    return static_cast<int>(cudaGetLastError());
}

// slot_pipeline: votes i8[T, S, R] (any byte offset), alive u8[S, R]
// in; decided i8[T, S] and decided_phase i32[T, S] out; slot t is base +
// t (int32 wrapped), with `rounds` full-delivery rounds. Needs f1 <=
// quorum (the rule's derivation), as quorum_size and f_plus_1 give. Other
// arguments (shard0 too) as cr_rounds'.
extern "C" int cr_slot_pipeline(const void* votes, const void* alive, void* decided, void* dphase,
                                long long T, long long S, int R, int base, int rounds, int quorum,
                                int f1, unsigned int seed, unsigned int threshold,
                                unsigned int shard0, void* stream) {
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
    p.shard0 = shard0;
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

// ClusterKernel.start_slot over nblk shard blocks of S shards each, in
// one launch for up to 16 blocks (ss::MAX_BLOCKS; more, or a block whose
// [S, R, R] plane passes 2^31 bytes, take ceil(entries / 16) launches):
// each block's 13 state fields in[13 b .. 13 b + 12] to out[...]
// (ClusterState's order and dtypes, contiguous, any alignment; out may be
// in), its mask u8[S] masks[b] and votes i8[S, R] votes[b]; 1 <= R <=
// 46340. empty != 0 launches a kernel that does nothing on the same grid
// and parameter instead (the launch's own time). Launches on `stream`,
// writes the launches made to *launches, returns cudaGetLastError() (0
// on success); does not synchronise.
extern "C" int cr_start_slot_blocks(int nblk, void* const* in, void* const* out,
                                    const void* const* masks, const void* const* votes,
                                    long long S, int R, int empty, int* launches, void* stream) {
    *launches = 0;
    const auto st = static_cast<cudaStream_t>(stream);
    int err = 0;
    const int n = ss::launches(nblk, in, out, masks, votes, S, R,
                               [&](const ss::Args& a, uint32_t grid_x) {
        if (err != 0) return;
        const dim3 grid(grid_x, static_cast<unsigned>(a.nblk));
        if (empty) {
            start_slot_empty_kernel<<<grid, ss::THREADS, 0, st>>>(a);
        } else {
            start_slot_kernel<<<grid, ss::THREADS, 0, st>>>(a);
        }
        err = static_cast<int>(cudaGetLastError());
        if (err == 0) ++*launches;
    });
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    return err;
}

// One block: cr_start_slot_blocks with nblk = 1 (the 13 fields in and out,
// mask u8[S], votes i8[S, R]).
extern "C" int cr_start_slot(void* const* in, void* const* out, const void* mask,
                             const void* votes, long long S, int R, void* stream) {
    int launches = 0;
    return cr_start_slot_blocks(1, in, out, &mask, &votes, S, R, 0, &launches, stream);
}
