// Fault-free slot window as CUDA kernels for Hopper (sm_90a), one for
// each vote layout.
//
// Replaces the TPU kernels `pallas_window_rmajor` (replica-major votes,
// fused_window_kernel below) and `pallas_window` ([T, S, R] votes,
// fused_window_tsr_kernel at the bottom) of
// rabia_tpu/kernel/fused_window.py: the closed-form quorum tally that the
// scanned weak-MVC pipeline collapses to under full delivery.
//
// Bound: bytes. Per window the kernel must read R*T*S vote bytes and R*S
// alive bytes and write T*S decision bytes (plus 4*T*S phase bytes when
// the phase plane is asked for); the arithmetic is a few 32-bit integer
// operations per four lanes. At R=5, S=4096, T=32768 without phase that
// is ~805 MB, ~0.24 ms at the H100 SXM's 3.35 TB/s.
//
// Design: one thread per 16 consecutive shards of one slot row. Each
// replica plane is read as one 16-byte vector per thread (neighbouring
// threads on neighbouring addresses, so a warp reads 512 contiguous
// bytes per plane), tallied four lanes per 32-bit word (fused_window.cuh),
// and the decisions leave as one 16-byte store. Counters live in
// registers; nothing is staged in shared memory because no byte is read
// twice. A chunk whose address is not 16-byte aligned, or that is cut by
// the end of a row, takes the byte-wise path of the same math, so any S
// and T work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_window.cuh"

namespace {

using rw::aligned16;

__device__ __forceinline__ void load16(const uint8_t* p, int n, uint32_t w[4], uint8_t pad) {
    if (n == rw::LANES && aligned16(p)) {
        uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
        rw::load_lanes(p, n, w, pad);
    }
}

__global__ void __launch_bounds__(256)
fused_window_kernel(const int8_t* __restrict__ votes, const uint8_t* __restrict__ alive,
                    int8_t* __restrict__ dec, int32_t* __restrict__ ph,
                    int R, int64_t T, int64_t S, uint32_t q) {
    const int64_t chunks = (S + rw::LANES - 1) / rw::LANES;
    const int64_t total = T * chunks;
    const int64_t plane = T * S;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int64_t t = i / chunks;
        const int64_t s0 = (i - t * chunks) * rw::LANES;
        const int n = static_cast<int>(S - s0 < rw::LANES ? S - s0 : rw::LANES);
        const int64_t off = t * S + s0;

        uint32_t c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
        for (int r = 0; r < R; ++r) {
            uint32_t v[4], a[4];
            load16(reinterpret_cast<const uint8_t*>(votes + r * plane + off), n, v, rw::CODE_ABSENT);
            load16(alive + r * S + s0, n, a, 0);
#pragma unroll
            for (int k = 0; k < 4; ++k) rw::tally_word(v[k], a[k] & rw::ONES, c0[k], c1[k]);
        }
        uint32_t d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k] = rw::decide_word(c0[k], c1[k], q);

        int8_t* dp = dec + off;
        if (n == rw::LANES && aligned16(dp)) {
            *reinterpret_cast<uint4*>(dp) = make_uint4(d[0], d[1], d[2], d[3]);
        } else {
            rw::store_dec_lanes(dp, n, d);
        }
        if (ph != nullptr) {
            int32_t* pp = ph + off;
            if (n == rw::LANES && aligned16(pp)) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    reinterpret_cast<int4*>(pp)[k] = make_int4(
                        rw::phase_of(d[k], 0), rw::phase_of(d[k], 1),
                        rw::phase_of(d[k], 2), rw::phase_of(d[k], 3));
                }
            } else {
                rw::store_phase_lanes(pp, n, d);
            }
        }
    }
}

}  // namespace

// votes: int8[R, T, S], alive: uint8[R, S] holding 0/1, dec: int8[T, S],
// ph: int32[T, S] or null. All contiguous. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int rw_fused_window(const void* votes, const void* alive, void* dec, void* ph,
                               int R, long long T, long long S, int quorum, void* stream) {
    if (R < 1 || R > rw::MAX_R || quorum < 1 || quorum > rw::MAX_QUORUM || T < 0 || S < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t total = static_cast<int64_t>(T) * ((S + rw::LANES - 1) / rw::LANES);
    if (total == 0) return 0;
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
    fused_window_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(votes), static_cast<const uint8_t*>(alive),
        static_cast<int8_t*>(dec), static_cast<int32_t*>(ph), R, T, S,
        static_cast<uint32_t>(quorum));
    return static_cast<int>(cudaGetLastError());
}

// ---- the [T, S, R] layout ----
//
// Replaces `pallas_window` (rabia_tpu/kernel/fused_window.py), which on
// the TPU relayouts the votes to replica-major (R sits on the 128-lane
// axis there) and runs the replica-major kernel. Hopper needs no
// relayout: the 16 shards x R replicas of one slot row's chunk are 16*R
// contiguous bytes, R 16-byte vectors whenever S is a multiple of 16.
//
// Bound: bytes. R*T*S + R*S bytes in, T*S decision bytes out, plus
// 4*T*S phase bytes when asked for: at R=5, S=4096, T=32768 with phase
// 1.342 GB, 0.40 ms at the H100 SXM's 3.35 TB/s. The integer work is
// about three byte permutes per transposed word on top of the
// replica-major tally, below the bytes time.
//
// Design: one thread per chunk of 16 shards, walking slot rows with a
// stride. It transposes its chunk's alive row once (fused_window.cuh),
// then for each row transposes its R vote vectors word by word in
// registers straight into the replica-major tally. A warp's 32 chunks
// are 32*16*R contiguous bytes, and a warp whose chunks are whole moves
// them through shared memory: R load instructions of 512 contiguous
// bytes each, then every lane reads its own R vectors back; its phases
// (4 vectors a lane) go out the same way, through a swizzled buffer, as
// 4 stores of 512 contiguous bytes. (Per-lane vectors 16*R and 64 bytes
// apart fill half a sector an instruction, and measured slower: PERF.md.)
// Decisions leave as one 16-byte vector a lane. A chunk cut by the end of
// a row, or not 16-byte aligned, loads and stores bytewise: the same
// math, so any S and T and a misaligned view work.

namespace {

__device__ __forceinline__ int4 phase_vec(uint32_t d) {
    return make_int4(rw::phase_of(d, 0), rw::phase_of(d, 1), rw::phase_of(d, 2),
                     rw::phase_of(d, 3));
}

template <int R>
__global__ void __launch_bounds__(256)
fused_window_tsr_kernel(const int8_t* __restrict__ votes, const uint8_t* __restrict__ alive,
                        int8_t* __restrict__ dec, int32_t* __restrict__ ph,
                        int64_t T, int64_t S, uint32_t q) {
    // a warp's vote vectors of one row, or its phase vectors
    constexpr int BUF = 32 * R > 128 ? 32 * R : 128;
    __shared__ uint4 bufs[256 / 32 * BUF];
    const int64_t chunks = (S + rw::LANES - 1) / rw::LANES;
    const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= chunks) return;
    const int lane = threadIdx.x & 31;
    uint4* buf = bufs + ((threadIdx.y * blockDim.x + threadIdx.x) >> 5) * BUF;
    const bool warp_whole = (c - lane + 32) * rw::LANES <= S;  // uniform over the warp
    const int64_t s0 = c * rw::LANES;
    const int n = static_cast<int>(S - s0 < rw::LANES ? S - s0 : rw::LANES);
    uint32_t a[4 * R], at[4][R];
    rw::load_chunk<R>(alive + s0 * R, n, a, 0);
    rw::transpose_alive<R>(a, at);
    const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
    for (int64_t t = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; t < T;
         t += stride) {
        const int64_t off = t * S + s0, warp_off = off - lane * rw::LANES;
        uint32_t v[4 * R], d[4];
        const int8_t* pv = votes + warp_off * R;
        if (warp_whole && aligned16(pv)) {
            rw::load_warp_row<R>(reinterpret_cast<const uint4*>(pv), buf, lane, v);
        } else {
            rw::load_chunk<R>(reinterpret_cast<const uint8_t*>(votes + off * R), n, v, rw::CODE_ABSENT);
        }
        rw::decide_rows<R>(v, at, q, d);

        int8_t* dp = dec + off;
        if (n == rw::LANES && aligned16(dp)) {
            *reinterpret_cast<uint4*>(dp) = make_uint4(d[0], d[1], d[2], d[3]);
        } else {
            rw::store_dec_lanes(dp, n, d);
        }
        if (ph == nullptr) continue;
        int32_t* pp = ph + off;
        if (warp_whole && aligned16(ph + warp_off)) {
            const int4 p[4] = {phase_vec(d[0]), phase_vec(d[1]), phase_vec(d[2]), phase_vec(d[3])};
            rw::store_warp_phases(reinterpret_cast<int4*>(ph + warp_off),
                                  reinterpret_cast<int4*>(buf), lane, p);
        } else if (n == rw::LANES && aligned16(pp)) {
#pragma unroll
            for (int k = 0; k < 4; ++k) reinterpret_cast<int4*>(pp)[k] = phase_vec(d[k]);
        } else {
            rw::store_phase_lanes(pp, n, d);
        }
    }
}

template <int R>
int launch_tsr(const int8_t* votes, const uint8_t* alive, int8_t* dec, int32_t* ph,
               int64_t T, int64_t S, uint32_t q, cudaStream_t stream) {
    dim3 grid, block;
    const int err = rw::tsr_launch_shape(T, S, grid, block);
    if (err != 0) return err;
    fused_window_tsr_kernel<R><<<grid, block, 0, stream>>>(votes, alive, dec, ph, T, S, q);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// votes: int8[T, S, R], alive: uint8[S, R] holding 0/1, dec: int8[T, S],
// ph: int32[T, S] or null. All contiguous; votes may start at any byte.
// 1 <= R <= 8. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int rw_fused_window_tsr(const void* votes, const void* alive, void* dec, void* ph,
                                   int R, long long T, long long S, int quorum, void* stream) {
    if (R < 1 || R > rw::MAX_R || quorum < 1 || quorum > rw::MAX_QUORUM || T < 0 || S < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (T == 0 || S == 0) return 0;
    const auto* v = static_cast<const int8_t*>(votes);
    const auto* a = static_cast<const uint8_t*>(alive);
    auto* d = static_cast<int8_t*>(dec);
    auto* p = static_cast<int32_t*>(ph);
    const auto q = static_cast<uint32_t>(quorum);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return launch_tsr<1>(v, a, d, p, T, S, q, st);
        case 2: return launch_tsr<2>(v, a, d, p, T, S, q, st);
        case 3: return launch_tsr<3>(v, a, d, p, T, S, q, st);
        case 4: return launch_tsr<4>(v, a, d, p, T, S, q, st);
        case 5: return launch_tsr<5>(v, a, d, p, T, S, q, st);
        case 6: return launch_tsr<6>(v, a, d, p, T, S, q, st);
        case 7: return launch_tsr<7>(v, a, d, p, T, S, q, st);
        default: return launch_tsr<8>(v, a, d, p, T, S, q, st);
    }
}
