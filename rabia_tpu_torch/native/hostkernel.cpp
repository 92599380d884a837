// Native host-kernel step: the C twin of HostNodeKernel.node_step /
// start_slots (rabia_tpu_torch/kernel/host_driver.py), which is itself the
// numpy twin of the jitted NodeKernel (kernel/phase_driver.py).
//
// Why: the engine's serial-latency floor is per-activation kernel cost.
// The numpy step is ~40 vectorized calls; at small shard counts (the
// reference's single-shard deployment shape, rabia-engine/src/engine.rs
// round loop) the ~2us-per-call dispatch overhead dominates, putting a
// ~76us floor under every activation. This C step is one call that walks
// each shard's ledger column once. Measured vs the numpy step: 4.7x at
// S=16 down to a steady ~1.2-1.4x at S=16384-65536 — the C path wins at
// every size, so the wrapper uses it unconditionally when the library
// builds. Both paths are bit-identical, gated by the differential fuzz
// in tests/test_native_hostkernel.py.
//
// Semantics owner: host_driver.py. Every transition here mirrors it
// element-for-element, including the portable lowbias32 common coin
// (phase_driver._coin_bits) and the exact vote-code tallies of
// rabia-engine/src/engine.rs:424-706 (vote rules / quorum / coin /
// decision), vectorized over shards.
//
// Layout contract (replica-major, matching HostNodeState): led1/led2 are
// i8[R*S] with sender r's votes at led[r*S + s]. All arrays are dense,
// C-contiguous, caller-owned. node_step mutates state in place (the
// Python wrapper passes fresh copies, preserving the functional step
// contract) and writes the outbox extras that do not alias new state.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <ctime>
#include <vector>

extern "C" {

// vote codes (core/types.py) and stages (kernel/phase_driver.py)
enum : int8_t { V0 = 0, V1 = 1, VQ = 2, ABS = 3 };
enum : int8_t { R1_WAIT = 0, R2_WAIT = 1 };

static inline uint32_t mix32(uint32_t h) {
  // lowbias32 avalanche — must match phase_driver._mix32 bit-for-bit
  h ^= h >> 16;
  h *= 0x21F0AAADu;
  h ^= h >> 15;
  h *= 0x735A2D97u;
  h ^= h >> 15;
  return h;
}

static const uint32_t GOLD = 0x9E3779B9u;

static inline int8_t coin_bit(uint32_t seed, uint32_t shard, uint32_t slot,
                              uint32_t phase, uint32_t threshold) {
  uint32_t h = mix32(seed ^ GOLD);
  h = mix32(h ^ (shard + GOLD));
  h = mix32(h ^ (slot + GOLD));
  h = mix32(h ^ (phase + GOLD));
  return h < threshold ? V1 : V0;
}

// One node_step over S shards. State arrays are mutated in place; the
// outbox fields that alias new state (new_r1=my_r1, new_phase=phase,
// decided_vals=decided) are read by the caller from the state arrays.
// coin_out (nullable): 2 uint64 cells accumulating common-coin flip
// outcomes (index 0 = V0, 1 = V1) — the chaos plane's coin-behavior
// telemetry; pure accounting, no protocol effect.
// s_lo/s_hi bound the shard scan: the thread-per-shard-group runtime
// gives each worker its own RkCtx over a contiguous shard range, and a
// worker must never READ another group's state cells (TSan-visible and
// semantically wrong — foreign ledgers live in foreign contexts). The
// full-range wrappers pass (0, S); coin values depend only on
// (seed, shard, slot, phase), so a range split never changes decisions.
static void rk_node_step_impl(
    int32_t S, int32_t R, int32_t me, int32_t quorum, int32_t f1,
    uint32_t seed, uint32_t coin_threshold, int32_t s_lo, int32_t s_hi,
    const int32_t* slot,       // [S]
    int32_t* phase,            // [S] in/out
    int8_t* stage,             // [S] in/out
    int8_t* my_r1,             // [S] in/out
    int8_t* my_r2,             // [S] in/out
    int8_t* led1,              // [R*S] in/out
    int8_t* led2,              // [R*S] in/out
    int8_t* decided,           // [S] in/out
    uint8_t* done,             // [S] in/out
    const uint8_t* active,     // [S]
    const int8_t* decision_in, // [S] or nullptr
    uint8_t* cast_r2,          // [S] out
    int8_t* r2_vals,           // [S] out
    uint8_t* advanced,         // [S] out
    uint8_t* newly_decided,    // [S] out
    uint64_t* coin_out         // [2] or nullptr (accounting only)
) {
  for (int32_t s = s_lo; s < s_hi; s++) {
    const int8_t st0 = stage[s];
    int8_t m2 = my_r2[s];
    uint8_t cast = 0, adv = 0, newdec = 0;
    const bool enabled = active[s] && !done[s];

    if (enabled && st0 == R1_WAIT) {
      // round-1 tally down this shard's ledger column
      int32_t c0 = 0, c1 = 0, cq = 0;
      for (int32_t r = 0; r < R; r++) {
        const int8_t v = led1[(int64_t)r * S + s];
        c0 += (v == V0);
        c1 += (v == V1);
        cq += (v == VQ);
      }
      if (c0 + c1 + cq >= quorum) {
        cast = 1;
        m2 = (c1 >= quorum) ? V1 : ((c0 >= quorum) ? V0 : VQ);
        my_r2[s] = m2;
        stage[s] = R2_WAIT;
        led2[(int64_t)me * S + s] = m2;
      }
    } else if (enabled && st0 == R2_WAIT) {
      int32_t d0 = 0, d1 = 0, dq = 0;
      for (int32_t r = 0; r < R; r++) {
        const int8_t v = led2[(int64_t)r * S + s];
        d0 += (v == V0);
        d1 += (v == V1);
        dq += (v == VQ);
      }
      if (d0 + d1 + dq >= quorum) {
        adv = 1;
        const bool dec1 = d1 >= f1, dec0 = d0 >= f1;
        int8_t next_v;
        if (dec1) next_v = V1;
        else if (dec0) next_v = V0;
        else if (d1 > 0) next_v = V1;
        else if (d0 > 0) next_v = V0;
        else {
          next_v = coin_bit(seed, (uint32_t)s, (uint32_t)slot[s],
                            (uint32_t)phase[s], coin_threshold);
          if (coin_out) coin_out[next_v == V1 ? 1 : 0]++;
        }
        if (dec1 || dec0) {
          newdec = 1;
          decided[s] = dec1 ? V1 : V0;
        }
        // advance to the next weak-MVC phase
        phase[s] += 1;
        my_r1[s] = next_v;
        stage[s] = R1_WAIT;
        my_r2[s] = ABS;
        for (int32_t r = 0; r < R; r++) {
          led1[(int64_t)r * S + s] = ABS;
          led2[(int64_t)r * S + s] = ABS;
        }
        led1[(int64_t)me * S + s] = next_v;
      }
    }

    // adopted decision (Decision frames routed by the engine): only when
    // not decided by this very step
    if (enabled && !newdec && decision_in && decision_in[s] != ABS) {
      decided[s] = decision_in[s];
      done[s] = 1;
    } else if (newdec) {
      done[s] = 1;
    }

    cast_r2[s] = cast;
    // pre-advance-clear value: an advancing shard reports the R2 vote it
    // had cast in the phase it is leaving (numpy copies my_r2 post-cast,
    // pre-clear)
    r2_vals[s] = m2;
    advanced[s] = adv;
    newly_decided[s] = newdec;
  }
}

void rk_node_step(
    int32_t S, int32_t R, int32_t me, int32_t quorum, int32_t f1,
    uint32_t seed, uint32_t coin_threshold,
    const int32_t* slot, int32_t* phase, int8_t* stage, int8_t* my_r1,
    int8_t* my_r2, int8_t* led1, int8_t* led2, int8_t* decided,
    uint8_t* done, const uint8_t* active, const int8_t* decision_in,
    uint8_t* cast_r2, int8_t* r2_vals, uint8_t* advanced,
    uint8_t* newly_decided) {
  rk_node_step_impl(S, R, me, quorum, f1, seed, coin_threshold, 0, S, slot,
                    phase, stage, my_r1, my_r2, led1, led2, decided, done,
                    active, decision_in, cast_r2, r2_vals, advanced,
                    newly_decided, nullptr);
}

// rk_node_step + coin accounting (coin_out: 2 uint64 cells, V0/V1).
void rk_node_step_ex(
    int32_t S, int32_t R, int32_t me, int32_t quorum, int32_t f1,
    uint32_t seed, uint32_t coin_threshold,
    const int32_t* slot, int32_t* phase, int8_t* stage, int8_t* my_r1,
    int8_t* my_r2, int8_t* led1, int8_t* led2, int8_t* decided,
    uint8_t* done, const uint8_t* active, const int8_t* decision_in,
    uint8_t* cast_r2, int8_t* r2_vals, uint8_t* advanced,
    uint8_t* newly_decided, uint64_t* coin_out) {
  rk_node_step_impl(S, R, me, quorum, f1, seed, coin_threshold, 0, S, slot,
                    phase, stage, my_r1, my_r2, led1, led2, decided, done,
                    active, decision_in, cast_r2, r2_vals, advanced,
                    newly_decided, coin_out);
}

// start_slots: (re)arm masked shards for a new decision slot.
void rk_start_slots(
    int32_t S, int32_t R, int32_t me,
    const uint8_t* mask,        // [S]
    const int32_t* slot_index,  // [S]
    const int8_t* initial,      // [S]
    int32_t* slot, int32_t* phase, int8_t* stage, int8_t* my_r1,
    int8_t* my_r2, int8_t* led1, int8_t* led2, int8_t* decided,
    uint8_t* done, uint8_t* active) {
  for (int32_t s = 0; s < S; s++) {
    if (!mask[s]) continue;
    slot[s] = slot_index[s];
    phase[s] = 0;
    stage[s] = R1_WAIT;
    my_r1[s] = initial[s];
    my_r2[s] = ABS;
    decided[s] = ABS;
    done[s] = 0;
    active[s] = 1;
    for (int32_t r = 0; r < R; r++) {
      led1[(int64_t)r * S + s] = ABS;
      led2[(int64_t)r * S + s] = ABS;
    }
    led1[(int64_t)me * S + s] = initial[s];
  }
}

// Columnar open-candidate scan (engine _open_slots prologue): one pass
// instead of ~9 numpy dispatches per tick. Fills head[s] =
// max(next_slot, applied) and cand[s]; returns the candidate count so an
// idle tick exits on a single int.
// Device-KV window pack gather (the GRID fast path: full-width sorted
// blocks, op i covers wave i/n, shard i%n). One pass copies each op's
// key/value bytes into the zeroed padded planes — replacing numpy's
// materialize-gather + where-mask + reshape-scatter chain (~4 full
// passes over the op bytes) with a single read+write. Validation
// stays in Python (the numpy path remains the semantics owner and
// fallback); this function only trusts its own bounds check and
// returns nonzero on any out-of-range op so the caller can fall back.
int32_t rk_pack_gather(
    const uint8_t* dbuf, int64_t dbuf_len,
    const int64_t* off, const int64_t* klen, const int64_t* vlen,
    int64_t n_ops, int64_t n, int64_t S, int64_t hdr,
    int64_t ku, int64_t vu,
    uint8_t* kwin, uint8_t* vwin) {
  for (int64_t i = 0; i < n_ops; i++) {
    const int64_t kl = klen[i];
    const int64_t vl = vlen[i];
    const int64_t o = off[i] + hdr;
    if (kl < 0 || vl < 0 || kl > ku || vl > vu || o < 0 ||
        o + kl + vl > dbuf_len) {
      return 1;  // out of envelope/bounds: caller uses the numpy path
    }
    const int64_t row = (i / n) * S + (i % n);
    std::memcpy(kwin + row * ku, dbuf + o, (size_t)kl);
    std::memcpy(vwin + row * vu, dbuf + o + kl, (size_t)vl);
  }
  return 0;
}

int32_t rk_open_scan(
    int32_t S,
    const int64_t* next_slot, const int64_t* applied,
    const uint8_t* in_flight, const int64_t* queue_len,
    const uint8_t* prop_flag, const uint8_t* dec_flag,
    const int64_t* votes_seen, const int64_t* tainted,
    int64_t* head, uint8_t* cand) {
  int32_t n = 0;
  for (int32_t s = 0; s < S; s++) {
    const int64_t h =
        next_slot[s] > applied[s] ? next_slot[s] : applied[s];
    head[s] = h;
    const uint8_t c =
        !in_flight[s] &&
        (queue_len[s] > 0 || prop_flag[s] || dec_flag[s] ||
         votes_seen[s] >= h || tainted[s] > 0);
    cand[s] = c;
    n += c;
  }
  return n;
}

// Timeout pre-scan: "is any in-flight shard stalled past `timeout`?" in
// one C call — the engine's per-tick retransmit check early-outs on this
// instead of ~5 numpy dispatches (which dominate the serial shape).
int32_t rk_stall_scan(int32_t S, const uint8_t* in_flight,
                      const double* last_progress, double now,
                      double timeout) {
  for (int32_t s = 0; s < S; s++) {
    if (in_flight[s] && now - last_progress[s] >= timeout) return 1;
  }
  return 0;
}

// ===========================================================================
// Native per-tick fast path (the "rk tick context").
//
// The engine's per-round ingest→route→tally→outbox path, with Python
// touched only for EVENTS (decisions ready to record/apply, sync,
// membership, timeouts). Semantics owner: the Python paths in
// engine/engine.py (`_ingest_vote_arrays`/`_route_votes`/`_kernel_round`/
// `_process_outbox`) — every transition here mirrors them element-for-
// element; conformance is pinned by tests/test_native_tick.py and the
// seeded fuzz schedules run under RABIA_PY_TICK=1 vs the default.
//
// What runs here:
//  - rk_ingest: decode VoteRound1/VoteRound2/Decision wire frames
//    (byte layout of core/serialization.py v3) straight out of the
//    transport arena (or any bytes buffer) — no Python objects; perform
//    the stale-drop / taint-mark / votes-seen side effects; scatter
//    (slot, phase)-matched votes into the kernel ledger; carry future
//    votes; buffer stale ones for the Python repair path.
//  - rk_tick: chained route→node_step→outbox rounds (R1→R2→decide with
//    no Python in between when input allows), framing outbound vote /
//    decision messages directly into a caller-provided buffer in the
//    exact wire format peers decode.
//
// Everything the context touches is borrowed, caller-owned numpy memory
// registered once at creation — the engine guarantees those arrays stay
// alive and in place for the context's lifetime.
// ===========================================================================

enum : int32_t {
  RK_HANDLED = 1,       // consumed natively, with ledger/plane effects
  RK_NOOP = 2,          // consumed natively, NO effects (all entries
                        // stale/dropped) — the engine may skip the kernel
                        // round it would otherwise run for this traffic
  RK_PY = 0,            // not a fast-path frame: Python must handle it
  RK_DROP = -1,         // malformed / spoofed / validation-failed: drop
};

// Versioned, append-only counter block (the observability plane's
// zero-copy window into the rk tick context). Indices are ABI: new
// counters append before RKC_COUNT and bump RK_COUNTERS_VERSION; nothing
// is ever renumbered or removed, so a newer Python reader degrades to
// reading the prefix it knows. Read via rk_counters() as a uint64[]
// ndarray — single-writer (the engine's event loop), so plain u64 cells.
enum : int32_t {
  RKC_TICKS = 0,        // rk_tick calls
  RKC_STAGES,           // chained route->step->outbox activations
  RKC_FRAMES_V1,        // VoteRound1 frames consumed natively
  RKC_FRAMES_V2,        // VoteRound2 frames consumed natively
  RKC_FRAMES_DEC,       // Decision frames consumed natively
  RKC_FRAMES_NOOP,      // frames consumed with no effects (RK_NOOP)
  RKC_DROP_SPOOF,       // envelope/transport sender mismatch
  RKC_DROP_SKEW,        // clock-skew rejections
  RKC_DROP_MALFORMED,   // bad vote/decision codes, empty vote vectors
  RKC_STALE,            // stale (below-applied) vote entries observed
  RKC_TAINT_HITS,       // votes landing under a taint horizon
  RKC_CARRY,            // future-(slot,phase) votes carried
  RKC_SCATTER,          // ledger cell writes (ingest + carry replay)
  RKC_OUT_FRAMES,       // outbound frames emitted by rk_tick
  RKC_DECIDED,          // shards newly decided inside rk_tick
  RKC_OPENED,           // shards armed (opened) by rk_tick
  // -- consensus-health telemetry (chaos plane, v2) --------------------
  RKC_COIN_V0,          // common-coin flips landing V0 (MUST stay
  RKC_COIN_V1,          // adjacent to RKC_COIN_V1: rk_tick hands the
                        // pair to the step as one 2-cell block)
  RKC_PHASE_SUM,        // sum of phases-to-decide over local decisions
  RKC_COUNT
};
static const int32_t RK_COUNTERS_VERSION = 2;

// Phases-to-decide histogram: bin p counts local tally decisions whose
// weak-MVC phase count was p (clamped into the top bin). Sized for the
// tail the paper's termination analysis cares about (P[phases > p]
// decays ~2^-p; 32 covers anything a live cluster can produce).
static const int32_t RK_PHASE_HIST = 32;

// ---------------------------------------------------------------------------
// Flight recorder: a fixed-size binary event ring written on the fast path.
//
// One 32-byte record per ingest / route / node_step / outbox decision, so a
// misrouted vote or stale storm inside a native run is reconstructable after
// the fact (the engine auto-dumps the ring on severe anomalies; the trace
// collector slices it per batch). The record layout and kind codes are a
// versioned ABI like the RKC_* counter block: fields/kinds append, nothing is
// renumbered. The Python twin (rabia_tpu_torch/obs/flight.py FR_DTYPE /
// FlightRecorder) mirrors this layout exactly; RABIA_PY_TICK=1 feeds the
// same kinds from the Python tick paths.
//
// batch_hash is always 0 here: vote/decision wire frames carry no batch ids
// (ids derive from (client_id, seq)), so batch association happens at
// the Python event layer (propose/decide/apply records) and the trace merger
// joins on (shard, slot).
// ---------------------------------------------------------------------------

enum : uint8_t {
  FRE_FRAME_IN = 1,     // consensus frame consumed (arg = wire msg_type,
                        // peer = sender row, shard/slot of first entry)
  FRE_ROUTE1 = 2,       // R1 vote scattered into the ledger (arg = vote)
  FRE_ROUTE2 = 3,       // R2 vote scattered into the ledger (arg = vote)
  FRE_CARRY = 4,        // future-(slot,phase) vote carried (arg = round)
  FRE_STALE = 5,        // below-applied vote entry (repair path)
  FRE_DROP = 6,         // frame dropped (arg: 1 spoof, 2 skew, 3 malformed)
  FRE_OPEN = 7,         // slot armed (arg = initial vote)
  FRE_CAST_R2 = 8,      // R1 quorum -> R2 cast (arg = cast vote)
  FRE_ADVANCE = 9,      // weak-MVC phase advance (arg = new phase & 0xFF)
  FRE_STEP_DECIDE = 10, // node_step decided (arg = decided value)
  FRE_FRAME_OUT = 11,   // outbound frame emitted (arg = wire msg_type,
                        // shard/slot of first entry)
  // 12..16 are Python-event kinds (submit/propose/decide/apply/result) and
  // 17/18 the transport frame in/out kinds — never written by this ring but
  // reserved here so the numbering space stays single-sourced.
};

struct FrEvent {
  uint64_t t_ns;        // CLOCK_MONOTONIC
  uint64_t slot;        // decision slot (0 when not slot-scoped)
  uint64_t batch_hash;  // always 0 on the native ring (see above)
  uint32_t shard;
  uint16_t peer;        // sender row, or 0xFFFF when not peer-scoped
  uint8_t kind;         // FRE_*
  uint8_t arg;
};
static_assert(sizeof(FrEvent) == 32, "flight record layout is ABI");

static const int32_t RK_FLIGHT_VERSION = 1;
static const uint32_t RK_FLIGHT_CAP = 4096;  // power of two

// ---------------------------------------------------------------------------
// Per-phase consensus dwell: how long each weak-MVC phase actually took,
// measured where the phase runs (slot open -> advance -> ... -> decide),
// not inferred from aggregate phase counts. One histogram row per phase
// ordinal (1..RK_DWELL_PHASES, top row clamps "8+"), RTH-style log-bucket
// geometry (runtime.cpp): 2^SUB_BITS sub-buckets per power-of-two octave
// from 2^MIN_EXP ns; row layout = BUCKETS counts + total count + sum_ns
// (stride BUCKETS + 2). Versioned ABI like the RKC_* block; the Python
// tick twin (engine._py_dwell) mirrors this geometry exactly.
// ---------------------------------------------------------------------------
static const int32_t RK_DWELL_VERSION = 1;
static const int32_t RK_DWELL_SUB_BITS = 2;  // 4 sub-buckets per octave
static const int32_t RK_DWELL_MIN_EXP = 10;  // floor 1.024us
static const int32_t RK_DWELL_OCTAVES = 25;  // top bound 2^35 ns ~ 34.4s
static const int32_t RK_DWELL_BUCKETS = RK_DWELL_OCTAVES << RK_DWELL_SUB_BITS;
static const int32_t RK_DWELL_STRIDE = RK_DWELL_BUCKETS + 2;
static const int32_t RK_DWELL_PHASES = 8;  // rows: phase 1..7 + "8+"

static inline uint64_t fr_now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

struct RkCarry {
  int32_t row;
  int32_t shard;
  int64_t slot;
  int32_t mvc;
  int8_t val;
};

struct RkStale {
  int32_t row;
  int32_t shard;
  int64_t slot;
};

struct RkCtx {
  // geometry / protocol constants
  int32_t S, n, R, me, quorum, f1;
  uint32_t seed, coin_threshold;
  int32_t dec_ring;           // ring depth (power of two)
  int32_t decision_broadcast; // emit Decision frames for newly decided
  double max_future_skew, max_age;

  // engine runtime columns (borrowed)
  int64_t* next_slot;
  int64_t* applied;
  uint8_t* in_flight;
  int64_t* votes_seen;
  int64_t* tainted;
  double* taint_traffic;
  double* last_progress;
  int64_t* ring_slot;  // [S, dec_ring]
  int8_t* ring_val;    // [S, dec_ring]

  // kernel state (borrowed, persistent — mutated in place)
  int32_t* slot;
  int32_t* phase;
  int8_t* stage;
  int8_t* my_r1;
  int8_t* my_r2;
  int8_t* led1;  // [R, S]
  int8_t* led2;  // [R, S]
  int8_t* decided;
  uint8_t* done;
  uint8_t* active;
  int8_t* dec_plane;   // adopted-decision inbox [S]
  uint8_t* newly_acc;  // newly-decided accumulator [S] (engine reads+clears)

  // shard-group range [g_lo, g_hi): the thread-per-shard-group runtime
  // partitions the shard space across per-worker contexts — this ctx
  // ingests/ticks ONLY shards in its range and skips foreign entries
  // (another worker's ctx owns them). Default [0, n) = today's single
  // full-range context, byte-for-byte. id_salt keeps message ids unique
  // across sibling contexts sharing (seed, me); it never feeds the coin.
  int32_t g_lo, g_hi;
  uint32_t id_salt;

  // identity: row -> 16B node uuid (spoof check + outbound sender field)
  std::vector<uint8_t> uuids;  // R * 16
  uint64_t rows_seen;

  // carried future-(slot, phase) votes, bounded like the Python carry
  std::vector<RkCarry> carry1, carry2;
  // stale-vote reports for the Python repair path (rate-limited there)
  std::vector<RkStale> stale;
  uint64_t dropped;  // frames rejected with RK_DROP (engine stats)

  // node_step outbox scratch
  std::vector<uint8_t> cast_r2, advanced, newly_step;
  std::vector<int8_t> r2_vals;
  std::vector<int32_t> idx_scratch;

  uint64_t msg_counter;

  // observability counter block (see RKC_* above); zero-initialized
  uint64_t ctrs[RKC_COUNT];

  // phases-to-decide histogram (see RK_PHASE_HIST above); zero-init
  uint64_t phase_hist[RK_PHASE_HIST];

  // per-phase dwell histogram block (see RK_DWELL_* above); zero-init
  uint64_t dwell[RK_DWELL_PHASES * RK_DWELL_STRIDE];
  // per-shard stamp of the in-progress phase's start, plus the slot it
  // was stamped for (-1 = unarmed). Slots armed outside rk_tick's open
  // path (rk_start_slots called directly) carry no stamp; the slot
  // guard skips them instead of mis-attributing a stale interval.
  std::vector<uint64_t> dwell_t0;
  std::vector<int64_t> dwell_t0_slot;

  // flight-recorder event ring (see FrEvent above); fr_head counts every
  // record ever written, the live window is the last RK_FLIGHT_CAP
  std::vector<FrEvent> fr;
  // relaxed atomic: written on the tick path, read by the Python
  // scrape thread via rk_flight_head while the engine runs
  std::atomic<uint64_t> fr_head;
};

static inline void fr_rec(RkCtx* c, uint8_t kind, uint8_t arg, uint16_t peer,
                          uint32_t shard, int64_t slot) {
  const uint64_t head = c->fr_head.load(std::memory_order_relaxed);
  FrEvent& e = c->fr[head & (RK_FLIGHT_CAP - 1)];
  e.t_ns = fr_now_ns();
  e.slot = (uint64_t)slot;
  e.batch_hash = 0;
  e.shard = shard;
  e.peer = peer;
  e.kind = kind;
  e.arg = arg;
  c->fr_head.store(head + 1, std::memory_order_relaxed);
}

// One completed phase -> its dwell row (phase is the 1-based ordinal of
// the phase that just finished: slots open at phase 0 and each advance
// bumps by one, so the post-advance value counts completed phases).
// Bucketing is bit-identical to runtime.cpp rth_observe.
static inline void rk_dwell_obs(RkCtx* c, int32_t phase, uint64_t ns) {
  if (phase < 1) return;
  const int32_t row =
      (phase < RK_DWELL_PHASES ? phase : RK_DWELL_PHASES) - 1;
  uint64_t* h = c->dwell + (size_t)row * RK_DWELL_STRIDE;
  int32_t idx = 0;
  if (ns >= (1ull << RK_DWELL_MIN_EXP)) {
    const int32_t exp = 63 - __builtin_clzll(ns);
    const int32_t sub = (int32_t)((ns >> (exp - RK_DWELL_SUB_BITS)) &
                                  ((1 << RK_DWELL_SUB_BITS) - 1));
    idx = ((exp - RK_DWELL_MIN_EXP) << RK_DWELL_SUB_BITS) + sub;
    if (idx >= RK_DWELL_BUCKETS) idx = RK_DWELL_BUCKETS - 1;
  }
  h[idx]++;
  h[RK_DWELL_BUCKETS]++;
  h[RK_DWELL_BUCKETS + 1] += ns;
}

static const size_t RK_STALE_CAP = 1024;

static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint64_t rd_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
static inline double rd_f64(const uint8_t* p) {
  double v;
  std::memcpy(&v, p, 8);
  return v;
}

// --- context lifecycle ------------------------------------------------------

// dims: [S, n, R, me, quorum, f1, seed, coin_threshold, dec_ring,
//        decision_broadcast]
// ptrs: [next_slot, applied, in_flight, votes_seen, tainted, taint_traffic,
//        last_progress, ring_slot, ring_val,
//        slot, phase, stage, my_r1, my_r2, led1, led2, decided, done,
//        active, dec_plane, newly_acc]
// uuids: R * 16 bytes (row-major node ids)
// fparams: [max_future_skew, max_age]
void* rk_ctx_create(const int64_t* dims, const int64_t* ptrs,
                    const uint8_t* uuids, const double* fparams) {
  RkCtx* c = new RkCtx();
  c->S = (int32_t)dims[0];
  c->n = (int32_t)dims[1];
  c->R = (int32_t)dims[2];
  c->me = (int32_t)dims[3];
  c->quorum = (int32_t)dims[4];
  c->f1 = (int32_t)dims[5];
  c->seed = (uint32_t)dims[6];
  c->coin_threshold = (uint32_t)dims[7];
  c->dec_ring = (int32_t)dims[8];
  c->decision_broadcast = (int32_t)dims[9];
  int i = 0;
  c->next_slot = (int64_t*)ptrs[i++];
  c->applied = (int64_t*)ptrs[i++];
  c->in_flight = (uint8_t*)ptrs[i++];
  c->votes_seen = (int64_t*)ptrs[i++];
  c->tainted = (int64_t*)ptrs[i++];
  c->taint_traffic = (double*)ptrs[i++];
  c->last_progress = (double*)ptrs[i++];
  c->ring_slot = (int64_t*)ptrs[i++];
  c->ring_val = (int8_t*)ptrs[i++];
  c->slot = (int32_t*)ptrs[i++];
  c->phase = (int32_t*)ptrs[i++];
  c->stage = (int8_t*)ptrs[i++];
  c->my_r1 = (int8_t*)ptrs[i++];
  c->my_r2 = (int8_t*)ptrs[i++];
  c->led1 = (int8_t*)ptrs[i++];
  c->led2 = (int8_t*)ptrs[i++];
  c->decided = (int8_t*)ptrs[i++];
  c->done = (uint8_t*)ptrs[i++];
  c->active = (uint8_t*)ptrs[i++];
  c->dec_plane = (int8_t*)ptrs[i++];
  c->newly_acc = (uint8_t*)ptrs[i++];
  c->g_lo = 0;
  c->g_hi = c->n;
  c->id_salt = 0;
  c->uuids.assign(uuids, uuids + (size_t)c->R * 16);
  c->rows_seen = 0;
  c->dropped = 0;
  c->msg_counter = 0;
  c->max_future_skew = fparams[0];
  c->max_age = fparams[1];
  c->cast_r2.resize(c->S);
  c->advanced.resize(c->S);
  c->newly_step.resize(c->S);
  c->r2_vals.resize(c->S);
  c->idx_scratch.resize(c->S);
  std::memset(c->ctrs, 0, sizeof(c->ctrs));
  std::memset(c->phase_hist, 0, sizeof(c->phase_hist));
  std::memset(c->dwell, 0, sizeof(c->dwell));
  c->dwell_t0.assign((size_t)c->S, 0);
  c->dwell_t0_slot.assign((size_t)c->S, -1);
  c->fr.resize(RK_FLIGHT_CAP);
  c->fr_head = 0;
  return c;
}

void rk_ctx_destroy(void* ctx) { delete (RkCtx*)ctx; }

// Restrict this context to the shard-group range [lo, hi) (the
// thread-per-shard-group runtime: one ctx per worker, disjoint ranges
// over shared engine arrays). `salt` differentiates sibling contexts'
// outbound message ids; it does NOT perturb the common coin, so a
// range-partitioned cluster decides identically to a full-range one.
// Call only while no thread is inside this ctx (pre-start or paused).
void rk_set_range(void* ctx, int32_t lo, int32_t hi, uint32_t salt) {
  RkCtx* c = (RkCtx*)ctx;
  if (lo < 0) lo = 0;
  if (hi > c->n) hi = c->n;
  if (hi < lo) hi = lo;
  c->g_lo = lo;
  c->g_hi = hi;
  c->id_salt = salt;
}

uint64_t rk_rows_seen(void* ctx) {
  RkCtx* c = (RkCtx*)ctx;
  uint64_t m = c->rows_seen;
  c->rows_seen = 0;
  return m;
}

uint64_t rk_dropped(void* ctx) { return ((RkCtx*)ctx)->dropped; }

// --- counter block (observability plane) ------------------------------------

int32_t rk_counters_version(void) { return RK_COUNTERS_VERSION; }
int32_t rk_counters_count(void) { return RKC_COUNT; }
// Borrowed pointer to the context's uint64 counter block; valid for the
// context's lifetime. The Python side wraps it as a read-only ndarray.
void* rk_counters(void* ctx) { return ((RkCtx*)ctx)->ctrs; }

// Phases-to-decide histogram (uint64[rk_phase_hist_len()], bin p =
// decisions taking p phases, top bin clamps). Borrowed, context-lifetime,
// single-writer — same contract as rk_counters.
int32_t rk_phase_hist_len(void) { return RK_PHASE_HIST; }
void* rk_phase_hist(void* ctx) { return ((RkCtx*)ctx)->phase_hist; }

// --- flight recorder (binary event ring) ------------------------------------

int32_t rk_flight_version(void) { return RK_FLIGHT_VERSION; }
int32_t rk_flight_cap(void) { return (int32_t)RK_FLIGHT_CAP; }
int32_t rk_flight_record_size(void) { return (int32_t)sizeof(FrEvent); }
// Borrowed pointer to the ring base (RK_FLIGHT_CAP records of
// rk_flight_record_size() bytes); valid for the context's lifetime.
// Single-writer (the engine's event loop); foreign-thread snapshot reads
// may see one torn in-flight record — metrics-grade, not ledger-grade.
void* rk_flight(void* ctx) { return ((RkCtx*)ctx)->fr.data(); }
// Total records ever written; the live window is the last
// min(head, RK_FLIGHT_CAP) records ending at head % RK_FLIGHT_CAP.
uint64_t rk_flight_head(void* ctx) {
  return ((RkCtx*)ctx)->fr_head.load(std::memory_order_relaxed);
}

// --- per-phase dwell histogram block ----------------------------------------

int32_t rk_dwell_version(void) { return RK_DWELL_VERSION; }
int32_t rk_dwell_phases(void) { return RK_DWELL_PHASES; }
int32_t rk_dwell_buckets(void) { return RK_DWELL_BUCKETS; }
int32_t rk_dwell_sub_bits(void) { return RK_DWELL_SUB_BITS; }
int32_t rk_dwell_min_exp(void) { return RK_DWELL_MIN_EXP; }
// Borrowed pointer to the context's dwell block (rk_dwell_phases() rows
// of rk_dwell_buckets() bucket counts + total count + sum_ns, stride
// buckets + 2); context-lifetime, single-writer — the rk_counters
// contract. The geometry accessors exist so the Python exporter can
// refuse to decode a block whose shape it does not recognize.
void* rk_dwell(void* ctx) { return ((RkCtx*)ctx)->dwell; }

int64_t rk_carry_count(void* ctx) {
  RkCtx* c = (RkCtx*)ctx;
  return (int64_t)(c->carry1.size() + c->carry2.size());
}

// Pop up to `cap` buffered stale-vote reports (row, shard, slot) for the
// Python repair path. Returns the count written.
int64_t rk_drain_stale(void* ctx, int64_t* rows, int64_t* shards,
                       int64_t* slots, int64_t cap) {
  RkCtx* c = (RkCtx*)ctx;
  int64_t k = 0;
  for (const RkStale& st : c->stale) {
    if (k >= cap) break;
    rows[k] = st.row;
    shards[k] = st.shard;
    slots[k] = st.slot;
    k++;
  }
  c->stale.clear();
  return k;
}

// --- frame ingest -----------------------------------------------------------

// Wire layout (core/serialization.py, version 3):
//   u8 version | u8 msg_type | u8 flags | 16B id | 16B sender |
//   [16B recipient] | f64 timestamp | u32 body_len | body
// Vote body:     u32 count + count * 13B (u32 shard | u64 phase | u8 vote)
// Decision body: u32 count + count * 14B (u32 shard | u64 phase | u8 val |
//                u8 has_bid) + 16B per has_bid entry
enum : uint8_t {
  MT_VOTE1 = 2,
  MT_VOTE2 = 3,
  MT_DECISION = 4,
  FLAG_COMPRESSED = 0x01,
  FLAG_RECIPIENT = 0x02,
};

static inline bool rk_route_one(RkCtx* c, int32_t round_no, int32_t row,
                                int32_t s, int64_t slot, int32_t mvc,
                                int8_t val, std::vector<RkCarry>& carry) {
  if (c->in_flight[s] && slot == (int64_t)c->slot[s] &&
      mvc == c->phase[s]) {
    int8_t* led = (round_no == 1 ? c->led1 : c->led2);
    int8_t& cell = led[(int64_t)row * c->S + s];
    if (cell == ABS) {
      cell = val;
      c->ctrs[RKC_SCATTER]++;
      fr_rec(c, round_no == 1 ? FRE_ROUTE1 : FRE_ROUTE2, (uint8_t)val,
             (uint16_t)row, (uint32_t)s, slot);
      return true;
    }
    return false;  // first-write-wins duplicate: nothing changed
  }
  carry.push_back(RkCarry{row, s, slot, mvc, val});
  c->ctrs[RKC_CARRY]++;
  fr_rec(c, FRE_CARRY, (uint8_t)round_no, (uint16_t)row, (uint32_t)s, slot);
  return true;
}

int32_t rk_ingest(void* ctx, const uint8_t* data, int64_t len, int32_t row,
                  double now) {
  RkCtx* c = (RkCtx*)ctx;
  if (len < 47) return RK_PY;  // not even a recipient-less header
  const uint8_t version = data[0];
  const uint8_t msg_type = data[1];
  const uint8_t flags = data[2];
  if (version != 3) return RK_PY;
  if (msg_type != MT_VOTE1 && msg_type != MT_VOTE2 &&
      msg_type != MT_DECISION)
    return RK_PY;
  if (flags & FLAG_COMPRESSED) return RK_PY;  // votes are never compressed
  if (row < 0 || row >= c->R) return RK_PY;
  // envelope sender must match the transport-authenticated peer row
  // (engine._handle_message spoof guard)
  if (std::memcmp(data + 19, c->uuids.data() + (size_t)row * 16, 16) != 0) {
    c->dropped++;
    c->ctrs[RKC_DROP_SPOOF]++;
    fr_rec(c, FRE_DROP, 1, (uint16_t)row, 0, 0);
    return RK_DROP;
  }
  int64_t base = 35 + ((flags & FLAG_RECIPIENT) ? 16 : 0);
  if (len < base + 12) return RK_PY;
  const double ts = rd_f64(data + base);
  if (ts > now + c->max_future_skew || ts < now - c->max_age) {
    c->dropped++;  // clock-skew rejection (MessageValidator parity)
    c->ctrs[RKC_DROP_SKEW]++;
    fr_rec(c, FRE_DROP, 2, (uint16_t)row, 0, 0);
    return RK_DROP;
  }
  const uint32_t body_len = rd_u32(data + base + 8);
  const uint8_t* body = data + base + 12;
  if ((int64_t)body_len > len - (base + 12) || body_len < 4) return RK_PY;
  const uint32_t count = rd_u32(body);
  const uint8_t* ent = body + 4;

  if (msg_type == MT_DECISION) {
    if (body_len < 4 + (uint64_t)count * 14) return RK_PY;
    // pass 1: classify without side effects — any entry the Python path
    // must see (bid-bearing, out-of-range, live-but-not-current and not
    // in the decided ring) bails the WHOLE frame out untouched
    for (uint32_t k = 0; k < count; k++) {
      const uint8_t* e = ent + (size_t)k * 14;
      const uint32_t s = rd_u32(e);
      const uint64_t ph = rd_u64(e + 4);
      const uint8_t val = e[12];
      if (e[13]) return RK_PY;       // has_bid: recovery path
      if (val == VQ || val > 3) {
        // "decision cannot be V?" (validator) / code out of range
        // (codec parity) — adopting a garbage code would later blow up
        // StateValue() on the Python event path
        c->dropped++;
        c->ctrs[RKC_DROP_MALFORMED]++;
        fr_rec(c, FRE_DROP, 3, (uint16_t)row, s, (int64_t)(ph >> 16));
        return RK_DROP;
      }
      if (s >= (uint32_t)c->n) return RK_PY;
      if ((int32_t)s < c->g_lo || (int32_t)s >= c->g_hi)
        continue;  // another shard group's entry: its worker owns it
      const int64_t slot = (int64_t)(ph >> 16);
      if (slot < c->applied[s]) continue;  // stale: dropped in pass 2
      if (c->in_flight[s] && slot == (int64_t)c->slot[s]) continue;
      const int64_t ring = slot & (c->dec_ring - 1);
      if (c->ring_slot[(int64_t)s * c->dec_ring + ring] == slot)
        continue;  // already decided locally: recording again is a no-op
      return RK_PY;  // gap/future decision: Python ledger logic owns it
    }
    bool dec_effect = false;
    for (uint32_t k = 0; k < count; k++) {
      const uint8_t* e = ent + (size_t)k * 14;
      const uint32_t s = rd_u32(e);
      const uint64_t ph = rd_u64(e + 4);
      const int64_t slot = (int64_t)(ph >> 16);
      if (s >= (uint32_t)c->n || slot < c->applied[s]) continue;
      if ((int32_t)s < c->g_lo || (int32_t)s >= c->g_hi) continue;
      if (c->in_flight[s] && slot == (int64_t)c->slot[s]) {
        c->dec_plane[s] = (int8_t)e[12];
        dec_effect = true;
      }
    }
    c->rows_seen |= 1ull << (row & 63);
    c->ctrs[RKC_FRAMES_DEC]++;
    if (!dec_effect) c->ctrs[RKC_FRAMES_NOOP]++;
    fr_rec(c, FRE_FRAME_IN, MT_DECISION, (uint16_t)row,
           count ? rd_u32(ent) : 0,
           count ? (int64_t)(rd_u64(ent + 4) >> 16) : 0);
    return dec_effect ? RK_HANDLED : RK_NOOP;
  }

  // vote vector (R1/R2)
  if (count == 0) {
    c->dropped++;  // "vote vector must be non-empty" (validator)
    c->ctrs[RKC_DROP_MALFORMED]++;
    fr_rec(c, FRE_DROP, 3, (uint16_t)row, 0, 0);
    return RK_DROP;
  }
  if (body_len < 4 + (uint64_t)count * 13) return RK_PY;
  // codec parity: reject out-of-range vote codes before any side effect
  for (uint32_t k = 0; k < count; k++) {
    if (ent[(size_t)k * 13 + 12] > 3) {
      c->dropped++;
      c->ctrs[RKC_DROP_MALFORMED]++;
      fr_rec(c, FRE_DROP, 3, (uint16_t)row, 0, 0);
      return RK_DROP;
    }
  }
  const int32_t round_no = (msg_type == MT_VOTE1) ? 1 : 2;
  std::vector<RkCarry>& carry = (round_no == 1) ? c->carry1 : c->carry2;
  bool effect = false;
  for (uint32_t k = 0; k < count; k++) {
    const uint8_t* e = ent + (size_t)k * 13;
    const uint32_t s = rd_u32(e);
    if (s >= (uint32_t)c->n) continue;  // bounds filter (ingest parity)
    if ((int32_t)s < c->g_lo || (int32_t)s >= c->g_hi)
      continue;  // another shard group's vote: its worker's ctx owns it
    const uint64_t ph = rd_u64(e + 4);
    const int64_t slot = (int64_t)(ph >> 16);
    const int32_t mvc = (int32_t)(ph & 0xFFFF);
    const int8_t val = (int8_t)e[12];
    if (slot < c->applied[s]) {
      c->ctrs[RKC_STALE]++;
      fr_rec(c, FRE_STALE, (uint8_t)round_no, (uint16_t)row, s, slot);
      if (c->stale.size() < RK_STALE_CAP)
        c->stale.push_back(RkStale{row, (int32_t)s, slot});
      continue;
    }
    if (slot < c->tainted[s]) {
      c->taint_traffic[s] = now;
      c->ctrs[RKC_TAINT_HITS]++;
      effect = true;
    }
    if (slot > c->votes_seen[s]) {
      c->votes_seen[s] = slot;
      effect = true;
    }
    effect |= rk_route_one(c, round_no, row, (int32_t)s, slot, mvc, val,
                           carry);
  }
  // bound the carry exactly like _route_votes: genuinely unreachable
  // future votes must not accumulate without limit
  const size_t cap = (size_t)8 * c->S * c->R;
  if (carry.size() > cap)
    carry.erase(carry.begin(), carry.begin() + (carry.size() - cap));
  c->rows_seen |= 1ull << (row & 63);
  c->ctrs[round_no == 1 ? RKC_FRAMES_V1 : RKC_FRAMES_V2]++;
  if (!effect) c->ctrs[RKC_FRAMES_NOOP]++;
  fr_rec(c, FRE_FRAME_IN, msg_type, (uint16_t)row, rd_u32(ent),
         (int64_t)(rd_u64(ent + 4) >> 16));
  return effect ? RK_HANDLED : RK_NOOP;
}

// --- outbound framing -------------------------------------------------------

static void rk_msg_id(RkCtx* c, uint8_t* out) {
  // deterministic-unique 16 bytes: lowbias32 stream over (seed, me,
  // counter). Receivers treat message ids as opaque.
  const uint64_t ctr = ++c->msg_counter;
  uint32_t h = mix32(c->seed ^ c->id_salt ^ GOLD ^
                     (uint32_t)(c->me * 0x85EBCA6Bu));
  for (int w = 0; w < 4; w++) {
    h = mix32(h ^ (uint32_t)(ctr >> (16 * (w & 1))) ^ GOLD * (w + 1));
    std::memcpy(out + 4 * w, &h, 4);
  }
  out[6] = (out[6] & 0x0F) | 0x40;  // uuid4 version/variant cosmetics
  out[8] = (out[8] & 0x3F) | 0x80;
}

struct RkFrameWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos;
  int32_t frames;
  int32_t overflow;
};

// One broadcast frame: [u32 record_len][frame bytes] with the frame in the
// exact v3 wire layout. entry_sz is 13 (votes) or 14 (decisions).
static void rk_emit_frame(RkCtx* c, RkFrameWriter* w, uint8_t msg_type,
                          double now, const int32_t* idx, int32_t count,
                          int32_t entry_sz, const int8_t* vals,
                          int32_t phase_mode) {
  const int64_t frame_len = 47 + 4 + (int64_t)count * entry_sz;
  if (w->pos + 4 + frame_len > w->cap) {
    w->overflow = 1;
    return;
  }
  uint8_t* p = w->out + w->pos;
  const uint32_t rec = (uint32_t)frame_len;
  std::memcpy(p, &rec, 4);
  p += 4;
  p[0] = 3;  // version
  p[1] = msg_type;
  p[2] = 0;  // flags: uncompressed broadcast
  rk_msg_id(c, p + 3);
  std::memcpy(p + 19, c->uuids.data() + (size_t)c->me * 16, 16);
  std::memcpy(p + 35, &now, 8);
  const uint32_t body_len = 4 + (uint32_t)count * entry_sz;
  std::memcpy(p + 43, &body_len, 4);
  uint8_t* body = p + 47;
  const uint32_t cnt = (uint32_t)count;
  std::memcpy(body, &cnt, 4);
  uint8_t* e = body + 4;
  for (int32_t k = 0; k < count; k++) {
    const int32_t s = idx[k];
    const uint32_t su = (uint32_t)s;
    // phase_mode 0: (slot<<16) | phase[s]  (vote frames)
    //            1: (slot<<16)             (decision frames)
    uint64_t ph = ((uint64_t)(int64_t)c->slot[s]) << 16;
    if (phase_mode == 0) ph |= (uint64_t)(uint32_t)c->phase[s] & 0xFFFF;
    std::memcpy(e, &su, 4);
    std::memcpy(e + 4, &ph, 8);
    e[12] = (uint8_t)vals[s];
    if (entry_sz == 14) e[13] = 0;  // has_bid=0 (steady-state decisions)
    e += entry_sz;
  }
  w->pos += 4 + frame_len;
  w->frames++;
  fr_rec(c, FRE_FRAME_OUT, msg_type, 0xFFFF, (uint32_t)idx[0],
         (int64_t)c->slot[idx[0]]);
}

// --- the chained tick -------------------------------------------------------

static void rk_route_carry(RkCtx* c, int32_t round_no) {
  std::vector<RkCarry>& carry = (round_no == 1) ? c->carry1 : c->carry2;
  if (carry.empty()) return;
  size_t w = 0;
  for (size_t i = 0; i < carry.size(); i++) {
    const RkCarry& e = carry[i];
    if (e.slot < c->applied[e.shard]) continue;  // stale: decided+applied
    if (c->in_flight[e.shard] && e.slot == (int64_t)c->slot[e.shard] &&
        e.mvc == c->phase[e.shard]) {
      int8_t* led = (round_no == 1 ? c->led1 : c->led2);
      int8_t& cell = led[(int64_t)e.row * c->S + e.shard];
      if (cell == ABS) {
        cell = e.val;
        c->ctrs[RKC_SCATTER]++;
        fr_rec(c, round_no == 1 ? FRE_ROUTE1 : FRE_ROUTE2, (uint8_t)e.val,
               (uint16_t)e.row, (uint32_t)e.shard, e.slot);
      }
    } else {
      carry[w++] = e;  // keep for a later tick
    }
  }
  carry.resize(w);
}

// res: [out_bytes, done_any, restep, frames, overflow]
// open_mask/open_slots/open_init (nullable): shards opening a new decision
// slot this tick — armed in place (rk_start_slots) and announced with one
// VoteRound1 frame BEFORE the chained rounds, exactly like the Python
// path's start_slots + open broadcast.
void rk_tick(void* ctx, double now, uint8_t* out, int64_t out_cap,
             int32_t max_iters, const uint8_t* open_mask,
             const int32_t* open_slots, const int8_t* open_init,
             int64_t* res) {
  RkCtx* c = (RkCtx*)ctx;
  RkFrameWriter w{out, out_cap, 0, 0, 0};
  int32_t restep = 0;
  c->ctrs[RKC_TICKS]++;
  if (open_mask) {
    rk_start_slots(c->S, c->R, c->me, open_mask, open_slots, open_init,
                   c->slot, c->phase, c->stage, c->my_r1, c->my_r2, c->led1,
                   c->led2, c->decided, c->done, c->active);
    int32_t n_open = 0;
    int32_t* idx = c->idx_scratch.data();
    for (int32_t s = c->g_lo; s < c->g_hi; s++) {
      if (open_mask[s]) {
        idx[n_open++] = s;
        c->dwell_t0[s] = fr_now_ns();
        c->dwell_t0_slot[s] = (int64_t)open_slots[s];
        fr_rec(c, FRE_OPEN, (uint8_t)open_init[s], 0xFFFF, (uint32_t)s,
               (int64_t)open_slots[s]);
      }
    }
    if (n_open)
      rk_emit_frame(c, &w, MT_VOTE1, now, idx, n_open, 13, c->my_r1, 0);
    c->ctrs[RKC_OPENED] += (uint64_t)n_open;
  }
  for (int32_t it = 0; it < max_iters; it++) {
    c->ctrs[RKC_STAGES]++;
    rk_route_carry(c, 1);
    rk_route_carry(c, 2);
    rk_node_step_impl(c->S, c->R, c->me, c->quorum, c->f1, c->seed,
                      c->coin_threshold, c->g_lo, c->g_hi, c->slot,
                      c->phase, c->stage, c->my_r1, c->my_r2, c->led1,
                      c->led2, c->decided, c->done, c->active, c->dec_plane,
                      c->cast_r2.data(), c->r2_vals.data(),
                      c->advanced.data(), c->newly_step.data(),
                      &c->ctrs[RKC_COIN_V0]);
    // dec_plane is a SHARED [S] column: clear only this group's cells
    // (a full-plane memset would erase a sibling worker's adopted
    // decisions mid-tick)
    std::memset(c->dec_plane + c->g_lo, ABS, (size_t)(c->g_hi - c->g_lo));
    // outbox: per-iteration frames, masked by the engine's in-flight set
    // (engine._process_outbox parity)
    int32_t n_cast = 0, n_adv = 0, n_new = 0;
    int32_t* idx = c->idx_scratch.data();
    for (int32_t s = c->g_lo; s < c->g_hi; s++) {
      if (!c->in_flight[s]) continue;
      if (c->cast_r2[s]) {
        idx[n_cast++] = s;
        fr_rec(c, FRE_CAST_R2, (uint8_t)c->r2_vals[s], 0xFFFF, (uint32_t)s,
               (int64_t)c->slot[s]);
      }
    }
    if (n_cast) {
      rk_emit_frame(c, &w, MT_VOTE2, now, idx, n_cast, 13,
                    c->r2_vals.data(), 0);
      for (int32_t k = 0; k < n_cast; k++) c->last_progress[idx[k]] = now;
    }
    for (int32_t s = c->g_lo; s < c->g_hi; s++) {
      if (!c->in_flight[s]) continue;
      if (c->advanced[s] && !c->done[s]) {
        idx[n_adv++] = s;
        fr_rec(c, FRE_ADVANCE, (uint8_t)(c->phase[s] & 0xFF), 0xFFFF,
               (uint32_t)s, (int64_t)c->slot[s]);
      }
    }
    if (n_adv) {
      rk_emit_frame(c, &w, MT_VOTE1, now, idx, n_adv, 13, c->my_r1, 0);
      for (int32_t k = 0; k < n_adv; k++) c->last_progress[idx[k]] = now;
    }
    int32_t any_adv = 0;
    for (int32_t s = c->g_lo; s < c->g_hi; s++) {
      if (!c->in_flight[s]) continue;
      if (c->advanced[s]) {
        any_adv = 1;
        // close the phase that just completed (deciding advances mask
        // FRE_ADVANCE via done[] but still finish their final phase,
        // so dwell is observed on ALL advances); restamp for the next
        if (c->dwell_t0_slot[s] == (int64_t)c->slot[s]) {
          const uint64_t t = fr_now_ns();
          rk_dwell_obs(c, c->phase[s], t - c->dwell_t0[s]);
          c->dwell_t0[s] = t;
        }
      }
      if (c->newly_step[s]) {
        c->newly_acc[s] = 1;
        idx[n_new++] = s;
        // post-advance phase == phases-to-decide for this slot (the
        // decide step bumps phase): the termination-analysis curve
        const int32_t p = c->phase[s];
        c->ctrs[RKC_PHASE_SUM] += (uint64_t)p;
        c->phase_hist[p < RK_PHASE_HIST ? p : RK_PHASE_HIST - 1]++;
        fr_rec(c, FRE_STEP_DECIDE, (uint8_t)c->decided[s], 0xFFFF,
               (uint32_t)s, (int64_t)c->slot[s]);
      }
    }
    if (n_new && c->decision_broadcast)
      rk_emit_frame(c, &w, MT_DECISION, now, idx, n_new, 14, c->decided, 1);
    c->ctrs[RKC_DECIDED] += (uint64_t)n_new;
    restep = (n_cast || any_adv) ? 1 : 0;
    if (!restep) break;
  }
  c->ctrs[RKC_OUT_FRAMES] += (uint64_t)w.frames;
  int64_t done_any = 0;
  for (int32_t s = c->g_lo; s < c->g_hi; s++) {
    if (c->done[s] && c->in_flight[s]) {
      done_any = 1;
      break;
    }
  }
  res[0] = w.pos;
  res[1] = done_any;
  res[2] = restep;
  res[3] = w.frames;
  res[4] = w.overflow;
}

// Retransmit current votes for stalled in-flight shards (the native
// runtime's twin of engine._check_timeouts' vote half): frames a
// VoteRound1 for every stalled shard holding an R1 vote and a
// VoteRound2 for every stalled shard waiting in R2, then refreshes
// last_progress — all without the GIL. Propose/block retransmission
// stays an escalation (the payload bytes live on the control plane).
// res: [out_bytes, stalled, frames, overflow]
void rk_retransmit(void* ctx, double now, double timeout, uint8_t* out,
                   int64_t out_cap, int64_t* res) {
  RkCtx* c = (RkCtx*)ctx;
  RkFrameWriter w{out, out_cap, 0, 0, 0};
  int32_t* idx = c->idx_scratch.data();
  int32_t n_stall = 0, n_r1 = 0;
  for (int32_t s = c->g_lo; s < c->g_hi; s++) {
    if (c->in_flight[s] && now - c->last_progress[s] >= timeout) {
      n_stall++;
      if (c->my_r1[s] != ABS) idx[n_r1++] = s;
    }
  }
  if (n_stall == 0) {
    res[0] = res[1] = res[2] = res[3] = 0;
    return;
  }
  if (n_r1) rk_emit_frame(c, &w, MT_VOTE1, now, idx, n_r1, 13, c->my_r1, 0);
  int32_t n_r2 = 0;
  for (int32_t s = c->g_lo; s < c->g_hi; s++) {
    if (c->in_flight[s] && now - c->last_progress[s] >= timeout &&
        c->stage[s] == R2_WAIT && c->my_r2[s] != ABS)
      idx[n_r2++] = s;
  }
  if (n_r2) rk_emit_frame(c, &w, MT_VOTE2, now, idx, n_r2, 13, c->my_r2, 0);
  for (int32_t s = c->g_lo; s < c->g_hi; s++) {
    if (c->in_flight[s] && now - c->last_progress[s] >= timeout)
      c->last_progress[s] = now;
  }
  c->ctrs[RKC_OUT_FRAMES] += (uint64_t)w.frames;
  res[0] = w.pos;
  res[1] = n_stall;
  res[2] = w.frames;
  res[3] = w.overflow;
}

}  // extern "C"
