// The device KV table's window programs as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the wave scans of the reference's XLA programs in
// rabia_tpu/apps/device_kv.py: `_apply_set_wave` scanned by
// `_build_fused` (decide_apply), the lookup scan of `_build_lookup`
// (lookup_window) and `step_body` scanned by `_build_mixed`
// (mixed_apply). A SET window passes kind 1 for every op, a lookup
// kind 2 where the key is non-empty and no output table, a mixed window
// its real kinds. The per-op math is kv_window.cuh.
//
// Bound: bytes. A window reads the table once and writes a fresh copy
// (the programs are functional: a dirty window rolls back by keeping
// the input table), reads the op planes once, and writes the read
// planes when asked for. At S=4096, P=64, K=32 B, VW=64 B that is
// ~28 MB of table each way, ~56 MB, ~17 us at the H100 SXM's 3.35 TB/s;
// the compares are a few integer operations per byte.
//
// Design: one warp per shard. The warp stages its shard's P slots in
// shared memory (key words word-major, so the 32 lanes comparing 32
// slots read 32 banks), then runs the W waves in order: the op's words
// are staged once, each lane compares the slots it owns, and two warp
// ballots give the lowest matching and the lowest free slot; the
// warp-uniform step (kv_window.cuh) then reads, frees or writes one
// slot, its words split over the lanes. The shard's rows leave in one
// coalesced pass at the end. Shards never share a slot, so the warps
// run without block-wide barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_window.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct Table {
    const uint8_t* used;
    const int32_t* keyw;
    const int32_t* klen;
    const int32_t* ver;
    const int32_t* valw;
    const int32_t* vlen;
    const int32_t* sver;
};

struct OutTable {
    uint8_t* used;
    int32_t* keyw;
    int32_t* klen;
    int32_t* ver;
    int32_t* valw;
    int32_t* vlen;
    int32_t* sver;
};

struct Ops {
    const int8_t* kind;
    const int16_t* klen;
    const int16_t* vlen;
    const int32_t* kw;
    const int32_t* vw;
};

struct Reads {
    uint8_t* overflow;  // [S], always written
    uint8_t* found;     // [W, S] or null (with ver, vlen, val)
    int32_t* ver;
    int32_t* vlen;
    int32_t* val;  // [W, S, VW4]
};

struct Dims {
    int64_t S;
    int W, depth, P, K4, VW4, ku4, vwu4;
};

// Shared-memory words one warp needs for one shard (used bytes rounded
// up to whole words).
__host__ __device__ inline int64_t warp_words(const Dims& d) {
    return static_cast<int64_t>(d.P) * (d.K4 + d.VW4 + 3) + d.K4 + d.VW4 + (d.P + 3) / 4;
}

__global__ void kv_window_kernel(Table in, OutTable out, Ops ops, Reads rd, Dims d) {
    extern __shared__ int32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t s = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (s >= d.S) return;  // whole warps only: no block-wide barrier follows
    const int P = d.P, K4 = d.K4, VW4 = d.VW4;

    int32_t* base = smem + warp * warp_words(d);
    int32_t* keyk = base;            // [K4, P] word-major
    int32_t* valw = keyk + P * K4;   // [P, VW4] row-major
    int32_t* klen = valw + P * VW4;  // [P]
    int32_t* ver = klen + P;
    int32_t* vlen = ver + P;
    int32_t* opk = vlen + P;  // [K4] the current op's key words
    int32_t* opv = opk + K4;  // [VW4] its value words
    uint8_t* used = reinterpret_cast<uint8_t*>(opv + VW4);

    // stage the shard: coalesced reads of each row-major plane
    const int32_t* gk = in.keyw + s * P * K4;
    for (int i = lane; i < P * K4; i += 32) keyk[(i % K4) * P + i / K4] = gk[i];
    const int32_t* gv = in.valw + s * P * VW4;
    for (int i = lane; i < P * VW4; i += 32) valw[i] = gv[i];
    for (int p = lane; p < P; p += 32) {
        used[p] = in.used[s * P + p];
        klen[p] = in.klen[s * P + p];
        ver[p] = in.ver[s * P + p];
        vlen[p] = in.vlen[s * P + p];
    }
    int32_t sver = in.sver[s];
    bool overflow = false;
    __syncwarp();

    for (int t = 0; t < d.W; ++t) {
        const int64_t o = kvw::op_index(t, d.S, s);
        const int kind = ops.kind[o];
        const int32_t kl_t = ops.klen[o];
        for (int j = lane; j < K4; j += 32) opk[j] = kvw::op_word(ops.kw + o * d.ku4, j, d.ku4);
        for (int j = lane; j < VW4; j += 32) opv[j] = kvw::op_word(ops.vw + o * d.vwu4, j, d.vwu4);
        __syncwarp();

        int match = -1, first_free = -1;
        for (int p0 = 0; p0 < P; p0 += 32) {
            const int p = p0 + lane;
            const bool in_range = p < P;
            const bool u = in_range && used[p];
            const bool m = in_range && kvw::key_matches(u, in_range ? klen[p] : 0, keyk + p, P,
                                                         kl_t, opk, K4);
            const unsigned bm = __ballot_sync(FULL, m);
            const unsigned bf = __ballot_sync(FULL, in_range && !u);
            if (match < 0 && bm) match = p0 + __ffs(bm) - 1;
            if (first_free < 0 && bf) first_free = p0 + __ffs(bf) - 1;
            if (match >= 0 && first_free >= 0) break;  // warp-uniform
        }
        const kvw::Step st = kvw::wave_step(kind, t < d.depth, kl_t, match, first_free);

        if (rd.found != nullptr) {  // reads see the wave-entry state
            if (lane == 0) {
                rd.found[o] = st.rfound;
                rd.ver[o] = st.get_hit ? ver[match] : 0;
                rd.vlen[o] = st.get_hit ? vlen[match] : 0;
            }
            for (int j = lane; j < VW4; j += 32)
                rd.val[o * VW4 + j] = st.get_hit ? valw[match * VW4 + j] : 0;
        }
        if (st.del_hit) {
            if (lane == 0) used[match] = 0;
            sver = kvw::bump(sver);
        }
        if (st.apply) {
            sver = kvw::bump(sver);
            const int p = st.slot;
            for (int j = lane; j < K4; j += 32) keyk[j * P + p] = opk[j];
            for (int j = lane; j < VW4; j += 32) valw[p * VW4 + j] = opv[j];
            if (lane == 0) {
                used[p] = 1;
                klen[p] = kl_t;
                vlen[p] = ops.vlen[o];
                ver[p] = sver;
            }
        }
        overflow = overflow || st.overflow;
        __syncwarp();
    }

    if (lane == 0) rd.overflow[s] = overflow;
    if (out.used == nullptr) return;  // read-only window: the input stays the table
    int32_t* ok = out.keyw + s * P * K4;
    for (int i = lane; i < P * K4; i += 32) ok[i] = keyk[(i % K4) * P + i / K4];
    int32_t* ov = out.valw + s * P * VW4;
    for (int i = lane; i < P * VW4; i += 32) ov[i] = valw[i];
    for (int p = lane; p < P; p += 32) {
        out.used[s * P + p] = used[p];
        out.klen[s * P + p] = klen[p];
        out.ver[s * P + p] = ver[p];
        out.vlen[s * P + p] = vlen[p];
    }
    if (lane == 0) out.sver[s] = sver;
}

constexpr int64_t MAX_SMEM = 227 * 1024;  // a block's shared memory on Hopper

}  // namespace

// table/out: 7 pointers each (used u8[S,P], keyw i32[S,P,K4], klen, ver
// i32[S,P], valw i32[S,P,VW4], vlen i32[S,P], sver i32[S]); out may be
// all null for a read-only window. ops: kind i8[W,S], klen/vlen
// i16[W,S], kw i32[W,S,ku4], vw i32[W,S,vwu4]. reads: overflow u8[S],
// then found u8[W,S], ver/vlen i32[W,S], val i32[W,S,VW4] (those four
// may be null). dims: S, W, depth, P, K4, VW4, ku4, vwu4. All
// contiguous. Launches on `stream`, returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int kvw_window(void* const* table, void* const* out, void* const* ops,
                          void* const* reads, const long long* dims, void* stream) {
    Dims d;
    d.S = dims[0];
    d.W = static_cast<int>(dims[1]);
    d.depth = static_cast<int>(dims[2]);
    d.P = static_cast<int>(dims[3]);
    d.K4 = static_cast<int>(dims[4]);
    d.VW4 = static_cast<int>(dims[5]);
    d.ku4 = static_cast<int>(dims[6]);
    d.vwu4 = static_cast<int>(dims[7]);
    if (d.S < 0 || d.W < 0 || d.P < 1 || d.K4 < 1 || d.VW4 < 1 || d.ku4 < 0 || d.ku4 > d.K4 ||
        d.vwu4 < 0 || d.vwu4 > d.VW4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (d.S == 0) return 0;
    const int64_t per_warp = warp_words(d) * 4;
    if (per_warp > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    int warps = static_cast<int>(MAX_SMEM / 4 / per_warp);
    if (warps > 4) warps = 4;
    const int64_t smem = per_warp * warps;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kv_window_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    Table in{static_cast<const uint8_t*>(table[0]), static_cast<const int32_t*>(table[1]),
             static_cast<const int32_t*>(table[2]), static_cast<const int32_t*>(table[3]),
             static_cast<const int32_t*>(table[4]), static_cast<const int32_t*>(table[5]),
             static_cast<const int32_t*>(table[6])};
    OutTable o{static_cast<uint8_t*>(out[0]), static_cast<int32_t*>(out[1]),
               static_cast<int32_t*>(out[2]), static_cast<int32_t*>(out[3]),
               static_cast<int32_t*>(out[4]), static_cast<int32_t*>(out[5]),
               static_cast<int32_t*>(out[6])};
    Ops op{static_cast<const int8_t*>(ops[0]), static_cast<const int16_t*>(ops[1]),
           static_cast<const int16_t*>(ops[2]), static_cast<const int32_t*>(ops[3]),
           static_cast<const int32_t*>(ops[4])};
    Reads rd{static_cast<uint8_t*>(reads[0]), static_cast<uint8_t*>(reads[1]),
             static_cast<int32_t*>(reads[2]), static_cast<int32_t*>(reads[3]),
             static_cast<int32_t*>(reads[4])};
    const int64_t blocks = (d.S + warps - 1) / warps;
    kv_window_kernel<<<static_cast<unsigned>(blocks), 32 * warps, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(in, o, op, rd, d);
    return static_cast<int>(cudaGetLastError());
}
