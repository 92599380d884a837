// The packed-vote fault-free window as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the reference's packed_window_rmajor
// (rabia_tpu/kernel/packed_window.py), an XLA program on the TPU: the
// closed-form quorum tally on votes packed 16 to a 32-bit word, in
// bit-sliced counters (the per-word math is packed_window.cuh).
//
// Bound: bytes. Per window the kernel reads R*T*SW vote words and R*SW
// alive words and writes T*SW decision words, SW = ceil(S/16): at S=4096
// R=5 T=32768 that is 201 MB, 0.060 ms at the H100 SXM's 3.35 TB/s. The
// arithmetic is about 20 integer operations a replica a word, below the
// bytes time.
//
// Design: each thread owns one output word, or four neighbouring words
// when the row width is a multiple of four and the planes are 16-byte
// aligned (then every load and the store is a 16-byte vector). A warp's
// threads sit on neighbouring words of one row, so each replica's load is
// one coalesced run. The R loads per word are independent, the counters
// live in registers, nothing is staged. R <= 8 is a template parameter,
// so the replica loop unrolls and its loads issue together; larger R
// (up to 127) takes a runtime loop. Offsets are 64-bit: at bench.py's
// T=393216 one replica plane alone holds 100 M words.
//
// The packers (pw_pack_codes, pw_unpack_codes, pw_pack_alive) replace the
// reference's pack_codes, unpack_codes and pack_alive
// (rabia_tpu/kernel/packed_window.py:55-96), XLA programs that feed and
// read the window; pw_pack_inputs packs a window's votes and alive plane
// in one launch (pack_alive alone is a launch for a few KB, at the launch
// floor). Bound: bytes. pack_codes reads S code bytes and writes
// S/4 bytes of words a row, unpack_codes the reverse: at S=4096 R=5
// T=32768, 671 MB + 168 MB, 0.2504 ms at 3.35 TB/s. Design: one thread a
// 32-bit word, its 16 codes read as one 16-byte vector (bytewise at a
// ragged row end or an unaligned view) and shifted into place in
// registers, never widened past 32 bits; unpack_codes writes its 16
// lanes as one vector where rows are whole words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_window.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = (1 << pw::MAX_CAP) - 1;

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// RT: the replica count when known at compile time (0: runtime R_rt);
// CAP: counter planes enough for R; W: words a thread (4 needs SW % 4 == 0
// and 16-byte aligned planes).
template <int RT, int CAP, int W>
__global__ void __launch_bounds__(THREADS)
packed_window_kernel(const uint32_t* __restrict__ votes, const uint32_t* __restrict__ alive,
                     uint32_t* __restrict__ out, int R_rt, int64_t T, int64_t SW, int q) {
    const int R = RT > 0 ? RT : R_rt;
    const int cap = pw::cap_of(R);
    const int64_t groups = SW / W;
    const int64_t total = T * groups;
    const int64_t plane = T * SW;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int64_t t = i / groups;
        const int64_t w0 = (i - t * groups) * W;
        const int64_t off = t * SW + w0;
        uint32_t c1[W][CAP] = {}, c0[W][CAP] = {};
#pragma unroll
        for (int r = 0; r < R; ++r) {
            uint32_t w[W], a[W];
            if constexpr (W == 4) {
                const uint4 x = __ldg(reinterpret_cast<const uint4*>(votes + r * plane + off));
                const uint4 y = __ldg(reinterpret_cast<const uint4*>(alive + r * SW + w0));
                w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
                a[0] = y.x; a[1] = y.y; a[2] = y.z; a[3] = y.w;
            } else {
                w[0] = __ldg(votes + r * plane + off);
                a[0] = __ldg(alive + r * SW + w0);
            }
#pragma unroll
            for (int k = 0; k < W; ++k) {
                pw::add_plane(c1[k], pw::v1_plane(w[k], a[k]), cap);
                pw::add_plane(c0[k], pw::v0_plane(w[k], a[k]), cap);
            }
        }
        if constexpr (W == 4) {
            uint4 d;
            d.x = pw::decide(c1[0], c0[0], cap, q);
            d.y = pw::decide(c1[1], c0[1], cap, q);
            d.z = pw::decide(c1[2], c0[2], cap, q);
            d.w = pw::decide(c1[3], c0[3], cap, q);
            *reinterpret_cast<uint4*>(out + off) = d;
        } else {
            out[off] = pw::decide(c1[0], c0[0], cap, q);
        }
    }
}

template <int RT, int CAP>
int launch(const uint32_t* v, const uint32_t* a, uint32_t* o, int R, int64_t T, int64_t SW,
           int q, cudaStream_t stream) {
    const bool vec = SW % 4 == 0 && ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(a) |
                                      reinterpret_cast<uintptr_t>(o)) & 15u) == 0;
    const int64_t total = T * (vec ? SW / 4 : SW);
    int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
    if (vec) {
        packed_window_kernel<RT, CAP, 4><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
            v, a, o, R, T, SW, q);
    } else {
        packed_window_kernel<RT, CAP, 1><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
            v, a, o, R, T, SW, q);
    }
    return static_cast<int>(cudaGetLastError());
}

// The packers: one thread a 32-bit word, reading its 16 bytes (one
// 16-byte vector where rows are whole words and the input is 16-byte
// aligned) and writing the word. ALIVE: pack_alive, else pack_codes.
template <bool ALIVE, bool VEC>
__device__ __forceinline__ void pack_word(const int8_t* __restrict__ x, uint32_t* __restrict__ out,
                                          int64_t i, int64_t S, int64_t SW, int fill) {
    const int64_t row = i / SW, w = i - row * SW;
    const int8_t* src = x + row * S + w * 16;
    alignas(16) int8_t b[16];
    int n = 16;
    if constexpr (VEC) {
        *reinterpret_cast<uint4*>(b) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
        n = static_cast<int>(S - w * 16 < 16 ? S - w * 16 : 16);
#pragma unroll
        for (int k = 0; k < 16; ++k) b[k] = k < n ? src[k] : 0;
    }
    out[i] = ALIVE ? pw::pack16_alive(reinterpret_cast<const uint8_t*>(b), n)
                   : pw::pack16(b, n, fill);
}

template <bool ALIVE, bool VEC>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const int8_t* __restrict__ x, uint32_t* __restrict__ out, int64_t rows, int64_t S,
            int64_t SW, int fill) {
    const int64_t total = rows * SW;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        pack_word<ALIVE, VEC>(x, out, i, S, SW, fill);
    }
}

// pack_codes and pack_alive of one window in one launch: every thread
// walks the code words as pack_kernel does, then the alive words with the
// same stride, so the alive words ride on the first CTAs' threads and add
// no CTA at the grid's tail.
template <bool VEC_CODES, bool VEC_ALIVE>
__global__ void __launch_bounds__(THREADS)
pack_inputs_kernel(const int8_t* __restrict__ codes, uint32_t* __restrict__ codes_out,
                   const int8_t* __restrict__ alive, uint32_t* __restrict__ alive_out,
                   int64_t code_words, int64_t alive_words, int64_t S, int64_t SW) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = first; i < code_words; i += stride) {
        pack_word<false, VEC_CODES>(codes, codes_out, i, S, SW, 3);
    }
    for (int64_t i = first; i < alive_words; i += stride) {
        pack_word<true, VEC_ALIVE>(alive, alive_out, i, S, SW, 0);
    }
}

// unpack_codes: one thread a word, writing its lanes below S (one 16-byte
// vector where rows are whole words and the output is 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
unpack_kernel(const uint32_t* __restrict__ p, int8_t* __restrict__ out, int64_t rows, int64_t SW,
              int64_t S) {
    const int64_t total = rows * SW;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int64_t row = i / SW, w = i - row * SW;
        if (w * 16 >= S) continue;
        const uint32_t word = __ldg(p + i);
        int8_t* dst = out + row * S + w * 16;
        if constexpr (VEC) {
            alignas(16) int8_t b[16];
            pw::unpack16(word, b, 16);
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
        } else {
            pw::unpack16(word, dst, static_cast<int>(S - w * 16 < 16 ? S - w * 16 : 16));
        }
    }
}

unsigned grid_for(int64_t total) {
    int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
    return static_cast<unsigned>(blocks);
}

template <bool ALIVE>
int launch_pack(const void* x, void* out, long long rows, long long S, long long SW, int fill,
                void* stream) {
    if (rows < 0 || S < 0 || SW != (S + 15) / 16) return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || SW == 0) return 0;
    const auto* xi = static_cast<const int8_t*>(x);
    auto* o = static_cast<uint32_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = grid_for(rows * SW);
    if (S % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
        pack_kernel<ALIVE, true><<<g, THREADS, 0, st>>>(xi, o, rows, S, SW, fill);
    } else {
        pack_kernel<ALIVE, false><<<g, THREADS, 0, st>>>(xi, o, rows, S, SW, fill);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// votes u32[R, T, SW] (the words' bit patterns, as torch int32), alive
// u32[R, SW] (lane-LSB alive bits), out u32[T, SW]; all contiguous.
// 1 <= R <= 127; any quorum (<= 0: every lane decides V1). Launches on
// `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int pw_window(const void* votes, const void* alive, void* out, int R, long long T,
                         long long SW, int quorum, void* stream) {
    if (R < 1 || R > MAX_R || T < 0 || SW < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (T == 0 || SW == 0) return 0;
    const auto* v = static_cast<const uint32_t*>(votes);
    const auto* a = static_cast<const uint32_t*>(alive);
    auto* o = static_cast<uint32_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return launch<1, pw::cap_of(1)>(v, a, o, R, T, SW, quorum, st);
        case 2: return launch<2, pw::cap_of(2)>(v, a, o, R, T, SW, quorum, st);
        case 3: return launch<3, pw::cap_of(3)>(v, a, o, R, T, SW, quorum, st);
        case 4: return launch<4, pw::cap_of(4)>(v, a, o, R, T, SW, quorum, st);
        case 5: return launch<5, pw::cap_of(5)>(v, a, o, R, T, SW, quorum, st);
        case 6: return launch<6, pw::cap_of(6)>(v, a, o, R, T, SW, quorum, st);
        case 7: return launch<7, pw::cap_of(7)>(v, a, o, R, T, SW, quorum, st);
        case 8: return launch<8, pw::cap_of(8)>(v, a, o, R, T, SW, quorum, st);
        default: return launch<0, pw::MAX_CAP>(v, a, o, R, T, SW, quorum, st);
    }
}

// pack_codes: codes i8[rows, S] (contiguous, any byte offset) to words
// u32[rows, SW], SW = ceil(S/16), lanes past S ABSENT (3). pack_alive:
// flags u8[rows, S] (0 or not) to lane-LSB alive words, lanes past S 0.
// unpack_codes: words u32[rows, SW] to codes i8[rows, S], S <= 16*SW.
// Each launches on `stream`, returns cudaGetLastError() (0 on success);
// none synchronises.
extern "C" int pw_pack_codes(const void* x, void* out, long long rows, long long S, long long SW,
                             void* stream) {
    return launch_pack<false>(x, out, rows, S, SW, 3, stream);
}

extern "C" int pw_pack_alive(const void* x, void* out, long long rows, long long S, long long SW,
                             void* stream) {
    return launch_pack<true>(x, out, rows, S, SW, 0, stream);
}

// pack_codes of codes i8[code_rows, S] and pack_alive of flags
// u8[alive_rows, S] (each contiguous, any byte offset) in one launch, to
// words u32[code_rows, SW] and u32[alive_rows, SW], SW = ceil(S/16): a
// window's votes and alive plane. The same words as pw_pack_codes and
// pw_pack_alive. Launches on `stream`, returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int pw_pack_inputs(const void* codes, void* codes_out, long long code_rows,
                              const void* alive, void* alive_out, long long alive_rows,
                              long long S, long long SW, void* stream) {
    if (code_rows < 0 || alive_rows < 0 || S < 0 || SW != (S + 15) / 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t cw = code_rows * SW, aw = alive_rows * SW;
    if (cw + aw == 0) return 0;
    const auto* c = static_cast<const int8_t*>(codes);
    const auto* a = static_cast<const int8_t*>(alive);
    auto* co = static_cast<uint32_t*>(codes_out);
    auto* ao = static_cast<uint32_t*>(alive_out);
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = grid_for(cw > aw ? cw : aw);
    const bool vc = S % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
    const bool va = S % 16 == 0 && (reinterpret_cast<uintptr_t>(alive) & 15u) == 0;
    if (vc && va) {
        pack_inputs_kernel<true, true><<<g, THREADS, 0, st>>>(c, co, a, ao, cw, aw, S, SW);
    } else if (vc) {
        pack_inputs_kernel<true, false><<<g, THREADS, 0, st>>>(c, co, a, ao, cw, aw, S, SW);
    } else if (va) {
        pack_inputs_kernel<false, true><<<g, THREADS, 0, st>>>(c, co, a, ao, cw, aw, S, SW);
    } else {
        pack_inputs_kernel<false, false><<<g, THREADS, 0, st>>>(c, co, a, ao, cw, aw, S, SW);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int pw_unpack_codes(const void* p, void* out, long long rows, long long SW, long long S,
                               void* stream) {
    if (rows < 0 || SW < 0 || S < 0 || S > 16 * SW) return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || S == 0) return 0;
    const auto* pi = static_cast<const uint32_t*>(p);
    auto* o = static_cast<int8_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = grid_for(rows * SW);
    if (S == 16 * SW && (reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
        unpack_kernel<true><<<g, THREADS, 0, st>>>(pi, o, rows, SW, S);
    } else {
        unpack_kernel<false><<<g, THREADS, 0, st>>>(pi, o, rows, SW, S);
    }
    return static_cast<int>(cudaGetLastError());
}
