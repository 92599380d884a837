// The device KV table's read-only windows as one CUDA kernel for Hopper
// (sm_90a): the consensus-free probe and the GET window.
//
// Replaces the reference's `_build_lookup_only` (rabia_tpu/apps/
// device_kv.py:850, behind `lookup_only`) and the read-only scan of
// `_build_lookup` (:692-766, behind `lookup_window`), in the row form and
// in the dictionary form (a rank u8[W, S] into each shard's D distinct key
// rows, read in place through kvw::op_row). Every op reads its non-empty
// key and nothing is written, so every wave sees the table as it was when
// the window began (kv_window.cuh, read_of): the waves are independent.
// The GET window also decides its waves (every replica votes V1 for the
// waves below depth) and reduces the flags, as kvw_decide_window does.
//
// Bound: bytes. The function must read each shard's used flags, key
// lengths and keys (at S=4096, P=64, 32 B keys: 9.7 MB), the op keys, and
// for each slot a GET finds its version, value length and value; it
// writes the read planes (found, version, length and a 64-byte value a
// (wave, shard): 4.8 MB at W=16). About 21 MB in all, 6.4 us at the H100
// SXM's 3.35 TB/s; the compares are a few integer operations a byte.
// The write kernel (kv_window.cu) must stage the whole table, values and
// versions included (28.6 MB), and run the waves as a dependent chain;
// a read needs neither.
//
// Design: one warp a shard, nothing staged in shared memory.
//   1. Keys. Lane l loads slots l and l + 32 of each group of 64: used
//      flag, key length and key row (16-byte loads where the rows allow;
//      neighbouring lanes read neighbouring rows), and keeps only the
//      row's 32-bit tag (kvw::key_tag). Lane t loads op t's key length and
//      row (its dictionary row through the rank) and keeps its tag.
//   2. Match. For each wave, one shuffle of its tag and one ballot a group
//      of 32 slots give the wave's lane the used slots whose tag is its
//      key's; kvw::read_match compares the full rows of those candidates,
//      lowest first, from device memory (the rows were just loaded, so
//      they come from L1). No wave waits on another.
//   3. Gather. Lane t picks its slot (kvw::read_of) and loads only that
//      slot's version and length; each found value row (64 bytes) is read
//      and written by a quarter-warp in 16-byte pieces.
//   4. The GET window's decision: the alive row and the base load first,
//      and the waves' decisions (mw::decide on V1 votes, lane i wave i)
//      run after the shard's reads are issued. Each warp ORs its flag bits
//      into a scratch word; the last block to finish writes the flags and
//      clears the scratch (zero between launches and across graph
//      replays), as in kv_window.cu.
// With no shared memory and at most 64 registers a thread, 32 warps fit
// an SM, so 4096 shards run in one round of warps on 132 SMs (ptxas on
// sm_90a: 64 registers; the GET window's build spills 8 bytes). A half-warp
// a shard would idle no lane at W=16 but give each lane four slots' rows
// to hash; the warp keeps the loads of a shard's table one 16-byte piece a
// lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_window.cuh"
#include "mesh_window.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
// Shards (warps) a block: 8 for the probe; the GET window takes 32 (one
// block an SM), as each of its blocks ends with a fence and an atomic on
// one counter.
template <bool FOLD>
constexpr int WARPS = FOLD ? 32 : 8;

struct Table {
    const uint8_t* __restrict__ used;
    const int32_t* __restrict__ keyw;
    const int32_t* __restrict__ klen;
    const int32_t* __restrict__ ver;
    const int32_t* __restrict__ valw;
    const int32_t* __restrict__ vlen;
    const int32_t* __restrict__ sver;
};

struct Ops {
    const int16_t* __restrict__ klen;  // [W, S], or [S, D] with idx
    const int32_t* __restrict__ kw;    // [W, S, ku4], or [S, D, ku4] with idx
    const uint8_t* __restrict__ idx;   // [W, S] dictionary ranks; null: the row form
};

struct Reads {
    uint8_t* overflow;  // [S], always written (zero: a read overflows nothing)
    uint8_t* found;     // [W, S] or null (with ver, vlen, val)
    int32_t* ver;
    int32_t* vlen;
    int32_t* val;  // [W, S, VW4]
};

struct Dims {
    int64_t S;
    int W, depth, P, K4, VW4, ku4, D;
};

// The window's decision (kvr_decide_window), as kv_window.cu's.
struct Decide {
    const uint8_t* alive;  // u8[S, R], 0/1
    const int32_t* base;   // i32[S]: wave t of shard s is slot base[s] + t
    int R, quorum, f1, max_phases;
    uint32_t seed, threshold;
    int32_t* flags;     // i32[3] out
    uint32_t* scratch;  // u32[2]: blocks done, OR of shard flag bits; zero between launches
    uint32_t shard0;    // the global index of shard 0 (the coin's shard is shard0 + s)
};

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kvw::key_tag of n words at w (wu of them read, zero past), 16 bytes a
// load where v16 (w 16-byte aligned, wu a multiple of 4).
__device__ __forceinline__ uint32_t tag_of(int32_t klen, const int32_t* w, int wu, int n,
                                           bool v16) {
    uint32_t h = static_cast<uint32_t>(klen);
    int j = 0;
    if (v16) {
        for (; j < wu; j += 4) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(w + j));
            h = kvw::tag_add(kvw::tag_add(kvw::tag_add(kvw::tag_add(h, x.x), x.y), x.z), x.w);
        }
    } else {
        for (; j < wu; ++j) h = kvw::tag_add(h, __ldg(w + j));
    }
    for (; j < n; ++j) h = kvw::tag_add(h, 0);
    return h;
}

// One chunk of nw <= 32 waves t0.. of shard s: lane i reads wave t0 + i.
__device__ void read_chunk(const Table& in, const Ops& ops, const Reads& rd, const Dims& d,
                           int64_t s, int t0, int nw, int lane) {
    const int P = d.P, K4 = d.K4, VW4 = d.VW4;
    const int32_t* keyw = in.keyw + s * P * K4;
    const int32_t* klen = in.klen + s * P;
    const uint8_t* used = in.used + s * P;
    const bool kv16 = K4 % 4 == 0 && aligned16(in.keyw);

    // 1. the op's key and tag (lane i: wave t0 + i)
    const bool mine = lane < nw;
    const int64_t row = mine ? kvw::op_row(ops.idx, d.D, t0 + lane, d.S, s) : -1;
    const int32_t kl = row < 0 ? 0 : ops.klen[row];
    const int32_t* ow = row < 0 ? nullptr : ops.kw + row * d.ku4;
    const int wu = row < 0 ? 0 : d.ku4;
    const uint32_t tag = tag_of(kl, ow, wu, K4, wu % 4 == 0 && aligned16(ow));

    // 2. the match: candidates by tag, 32 slots a ballot, then full rows
    int match = -1;
    for (int p0 = 0; p0 < P; p0 += 64) {
        const int pA = p0 + lane, pB = pA + 32;
        const bool uA = pA < P && used[pA] != 0, uB = pB < P && used[pB] != 0;
        const uint32_t tA = uA ? tag_of(klen[pA], keyw + pA * K4, K4, K4, kv16) : 0u;
        const uint32_t tB = uB ? tag_of(klen[pB], keyw + pB * K4, K4, K4, kv16) : 0u;
        uint64_t cand = 0;
        for (int i = 0; i < nw; ++i) {
            const uint32_t ti = __shfl_sync(FULL, tag, i);
            const uint32_t lo = __ballot_sync(FULL, uA && tA == ti);
            const uint32_t hi = __ballot_sync(FULL, uB && tB == ti);
            if (lane == i) cand = (static_cast<uint64_t>(hi) << 32) | lo;
        }
        if (match < 0 && cand != 0) match = kvw::read_match(cand, p0, klen, keyw, K4, kl, ow, wu);
    }

    // 3. the gather: only the found slots' version, length and value
    if (rd.found == nullptr) return;
    const kvw::Read r = kvw::read_of(kl, match);
    const int64_t q = s * P + r.slot;
    if (mine) {
        const int64_t o = kvw::op_index(t0 + lane, d.S, s);
        rd.found[o] = r.found;
        rd.ver[o] = r.slot < 0 ? 0 : __ldg(in.ver + q);
        rd.vlen[o] = r.slot < 0 ? 0 : __ldg(in.vlen + q);
    }
    const bool v16 = VW4 % 4 == 0 && aligned16(in.valw) && aligned16(rd.val);
    const int per_row = v16 ? VW4 / 4 : VW4, n = nw * per_row;
    for (int q0 = 0; q0 < n; q0 += 32) {  // piece c of wave i's row
        const int k = q0 + lane;
        const int i = min(k / per_row, nw - 1), c = k - (k / per_row) * per_row;
        const int slot = __shfl_sync(FULL, r.slot, i);
        if (k >= n) continue;
        const int64_t o = kvw::op_index(t0 + i, d.S, s);
        const int64_t src = (s * P + slot) * VW4;
        if (v16) {
            reinterpret_cast<int4*>(rd.val + o * VW4)[c] =
                slot < 0 ? make_int4(0, 0, 0, 0)
                         : __ldg(reinterpret_cast<const int4*>(in.valw + src) + c);
        } else {
            rd.val[o * VW4 + c] = slot < 0 ? 0 : __ldg(in.valw + src + c);
        }
    }
}

// One warp a shard; FOLD: the GET window, with its decision and flags.
// At most 64 registers a thread, so 32 warps fit an SM.
template <bool FOLD>
__global__ void __launch_bounds__(32 * WARPS<FOLD>, 32 / WARPS<FOLD>)
kv_read_kernel(Table in, Ops ops, Reads rd, Dims d, Decide dc) {
    const int lane = threadIdx.x & 31;
    const int64_t s = static_cast<int64_t>(blockIdx.x) * WARPS<FOLD> + (threadIdx.x >> 5);
    if (s < d.S) {  // whole warps: no block-wide barrier inside
        // the decision's inputs load first; it runs once the reads are issued
        const uint8_t a0 = FOLD && lane < dc.R ? dc.alive[s * dc.R + lane] : 0;
        const uint8_t a1 = FOLD && lane + 32 < dc.R ? dc.alive[s * dc.R + lane + 32] : 0;
        const int32_t base = FOLD ? dc.base[s] : 0;
        const int32_t sver = FOLD ? in.sver[s] : 0;
        for (int t0 = 0; t0 < d.W; t0 += 32)
            read_chunk(in, ops, rd, d, s, t0, min(32, d.W - t0), lane);
        if (lane == 0) rd.overflow[s] = 0;
        if (FOLD) {
            const uint64_t alive = (static_cast<uint64_t>(__ballot_sync(FULL, a1 != 0)) << 32) |
                                   __ballot_sync(FULL, a0 != 0);
            const uint64_t v1 = dc.R >= 64 ? ~uint64_t{0} : (uint64_t{1} << dc.R) - 1;
            bool all_v1 = true;
            for (int t0 = 0; t0 < d.depth; t0 += 32) {
                const int t = t0 + lane;
                const uint32_t prefix =
                    mw::coin_prefix(dc.seed, dc.shard0 + static_cast<uint32_t>(s),
                                    mw::slot_of(base, t));
                const bool ok = t >= d.depth || mw::decide(mw::Masks{0, v1, alive}, dc.quorum,
                                                           dc.f1, prefix, dc.threshold,
                                                           dc.max_phases) == mw::V1;
                all_v1 = __all_sync(FULL, ok) && all_v1;
            }
            const uint32_t bits = kvw::shard_flags(all_v1, false, sver);
            if (lane == 0 && bits != 0) atomicOr(dc.scratch + 1, bits);
        }
    }
    if (!FOLD) return;
    // the last block to finish writes the flags and clears the scratch
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(dc.scratch, 1u) == gridDim.x - 1) {
            __threadfence();
            kvw::window_flags(atomicExch(dc.scratch + 1, 0u), dc.flags);
            atomicExch(dc.scratch, 0u);
        }
    }
}

// The arguments of both entries, checked: kv_window.cu's layout, with no
// output table, no kind plane, every op a read (kind_all KIND_GET) and no
// value planes. Returns 0 or a cudaError.
int unpack(void* const* table, void* const* out, void* const* ops, void* const* reads,
           const long long* dims, Table& in, Ops& op, Reads& rd, Dims& d) {
    d.S = dims[0];
    d.W = static_cast<int>(dims[1]);
    d.depth = static_cast<int>(dims[2]);
    d.P = static_cast<int>(dims[3]);
    d.K4 = static_cast<int>(dims[4]);
    d.VW4 = static_cast<int>(dims[5]);
    d.ku4 = static_cast<int>(dims[6]);
    d.D = static_cast<int>(dims[8]);
    bool no_out = true;
    for (int i = 0; i < 7; ++i) no_out = no_out && out[i] == nullptr;
    if (d.S < 0 || d.W < 0 || d.P < 1 || d.K4 < 1 || d.VW4 < 1 || d.ku4 < 0 || d.ku4 > d.K4 ||
        d.depth < 0 || d.depth > d.W || d.D < 0 || dims[7] != 0 ||
        dims[9] != kvw::KIND_GET || !no_out || ops[0] != nullptr || ops[1] == nullptr ||
        ops[2] != nullptr || ops[4] != nullptr || (ops[5] != nullptr && d.D < 1) ||
        reads[0] == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    in = Table{static_cast<const uint8_t*>(table[0]), static_cast<const int32_t*>(table[1]),
               static_cast<const int32_t*>(table[2]), static_cast<const int32_t*>(table[3]),
               static_cast<const int32_t*>(table[4]), static_cast<const int32_t*>(table[5]),
               static_cast<const int32_t*>(table[6])};
    op = Ops{static_cast<const int16_t*>(ops[1]), static_cast<const int32_t*>(ops[3]),
             static_cast<const uint8_t*>(ops[5])};
    rd = Reads{static_cast<uint8_t*>(reads[0]), static_cast<uint8_t*>(reads[1]),
               static_cast<int32_t*>(reads[2]), static_cast<int32_t*>(reads[3]),
               static_cast<int32_t*>(reads[4])};
    return 0;
}

template <bool FOLD>
int launch(const Table& in, const Ops& op, const Reads& rd, const Dims& d, const Decide& dc,
           cudaStream_t stream) {
    const int64_t blocks = (d.S + WARPS<FOLD> - 1) / WARPS<FOLD>;
    kv_read_kernel<FOLD><<<static_cast<unsigned>(blocks), 32 * WARPS<FOLD>, 0, stream>>>(
        in, op, rd, d, dc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The read-only window, with kvw_window's arguments (kv_window.cu): out
// all null, ops kind null with kind_all 2 (a read of every non-empty key),
// klen and kw in the row or the dictionary form, vlen and vw null (vwu4
// 0); reads: overflow u8[S] (written zero), then found u8[W,S], ver/vlen
// i32[W,S], val i32[W,S,VW4] (those four may be null). Launches on
// `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int kvr_window(void* const* table, void* const* out, void* const* ops,
                          void* const* reads, const long long* dims, void* stream) {
    Table in;
    Ops op;
    Reads rd;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, op, rd, d)) return err;
    if (d.S == 0) return 0;
    return launch<false>(in, op, rd, d, Decide{}, static_cast<cudaStream_t>(stream));
}

// kvr_window with the window's decision and flags, with
// kvw_decide_window's arguments: decide = alive u8[S,R], base i32[S],
// flags i32[3] (out), scratch u32[2] (zero before the launch; the launch
// leaves it zero); params = R (1..64), quorum, f1, max_phases, seed,
// coin threshold, shard0 (the global index of the table's first shard).
extern "C" int kvr_decide_window(void* const* table, void* const* out, void* const* ops,
                                 void* const* reads, const long long* dims,
                                 void* const* decide, const long long* params, void* stream) {
    Table in;
    Ops op;
    Reads rd;
    Dims d;
    if (const int err = unpack(table, out, ops, reads, dims, in, op, rd, d)) return err;
    Decide dc{static_cast<const uint8_t*>(decide[0]), static_cast<const int32_t*>(decide[1]),
              static_cast<int>(params[0]), static_cast<int>(params[1]),
              static_cast<int>(params[2]), static_cast<int>(params[3]),
              static_cast<uint32_t>(params[4]), static_cast<uint32_t>(params[5]),
              static_cast<int32_t*>(decide[2]), static_cast<uint32_t*>(decide[3]),
              static_cast<uint32_t>(params[6])};
    if (dc.R < 1 || dc.R > mw::MAX_REPLICAS || dc.max_phases < 0 || dc.alive == nullptr ||
        dc.base == nullptr || dc.flags == nullptr || dc.scratch == nullptr || d.S == 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<true>(in, op, rd, d, dc, static_cast<cudaStream_t>(stream));
}
