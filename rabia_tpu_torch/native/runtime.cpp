// Native engine runtime: a GIL-free io/tick thread running the commit
// path end-to-end — transport readable events feed rk_ingest directly,
// chained rk_tick stages decide, decided waves flow into sk_apply_wave,
// and staged vote/decision frames go out via rt_broadcast_frames — all
// without acquiring the GIL or waking the Python asyncio loop.
//
// Python is demoted to control plane (engine/runtime_bridge.py):
// membership, sync/recovery, config, gateway session logic and obs
// scrapes, talking to this thread through two bounded byte rings (the
// command ring Python->C, the event mailbox C->Python) plus an eventfd
// the Python loop selects on. RABIA_PY_RUNTIME=1 forces today's asyncio
// orchestration, which stays the semantics owner behind the
// run_schedule_on_runtime_paths conformance gate
// (rabia_tpu_torch/testing/conformance.py).
//
// Ownership contract (the whole point of the design): while the runtime
// thread is RUNNING, it is the single writer of the engine's consensus
// columns (next_slot, applied_upto, in_flight, votes_seen, taint
// traffic, last_progress, opened_at, the decided-value rings) and of
// the kernel state arrays behind the rk tick context. Python reads
// them advisorily (aligned 8-byte loads; metrics-grade) and mutates
// them ONLY while the runtime is paused (rtm_pause -> state PAUSED).
// Everything Python must act on — decisions for listeners/futures,
// escalated frames, stalls — arrives through the event mailbox, in
// per-shard slot order.
//
// This file links against nothing: every foreign entry point (transport,
// hostkernel, statekernel) arrives as a raw function pointer registered
// at rtm_create, so the four native libraries stay independently built
// and digest-keyed (native/build.py).

#include <errno.h>
#include <string.h>
#include <sys/eventfd.h>
#include <time.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <thread>
#include <vector>

#include "annotations.h"

extern "C" {

// --- foreign entry points (function-pointer table indices) ------------------

typedef int64_t (*fn_recv_borrow_t)(void*, uint8_t*, const uint8_t**,
                                    uint32_t*, int);
typedef void (*fn_recv_release_t)(void*, int64_t);
typedef int (*fn_bcast_frames_t)(void*, const uint8_t*, int64_t);
typedef int (*fn_send_t)(void*, const uint8_t*, const uint8_t*, uint32_t);
typedef int32_t (*fn_rk_ingest_t)(void*, const uint8_t*, int64_t, int32_t,
                                  double);
typedef void (*fn_rk_tick_t)(void*, double, uint8_t*, int64_t, int32_t,
                             const uint8_t*, const int32_t*, const int8_t*,
                             int64_t*);
typedef void (*fn_rk_retransmit_t)(void*, double, double, uint8_t*, int64_t,
                                   int64_t*);
typedef int64_t (*fn_rk_drain_stale_t)(void*, int64_t*, int64_t*, int64_t*,
                                       int64_t);
typedef int64_t (*fn_sk_apply_wave_t)(void*, const uint8_t*, const int64_t*,
                                      const int64_t*, const int64_t*,
                                      const int64_t*, int64_t, double,
                                      int32_t);
typedef void* (*fn_sk_ptr_t)(void*);
typedef void (*fn_sk_plane_lk_t)(void*);
// durability plane (walkernel.cpp): stage a record / advance the vote
// barrier / read the durability watermark — all lock-cheap, never disk
typedef int64_t (*fn_wal_append_t)(void*, const uint8_t*, int64_t);
typedef int64_t (*fn_wal_barrier_t)(void*, int64_t, int64_t);
typedef uint64_t (*fn_wal_durable_t)(void*);
// thread-per-shard-group additions: per-group transport inbox + per-lane
// statekernel apply (worker g stages results into its private lane)
typedef int64_t (*fn_recv_borrow_grp_t)(void*, int32_t, uint8_t*,
                                        const uint8_t**, uint32_t*, int);
typedef int64_t (*fn_sk_apply_lane_t)(void*, int32_t, const uint8_t*,
                                      const int64_t*, const int64_t*,
                                      const int64_t*, const int64_t*,
                                      int64_t, double, int32_t);
typedef void* (*fn_sk_lane_ptr_t)(void*, int32_t);

enum : int32_t {
  FN_RECV_BORROW = 0,
  FN_RECV_RELEASE,
  FN_BCAST_FRAMES,
  FN_SEND,
  FN_RK_INGEST,
  FN_RK_TICK,
  FN_RK_RETRANSMIT,
  FN_RK_DRAIN_STALE,
  FN_SK_APPLY_WAVE,
  FN_SK_OUT_BUF,
  FN_SK_OUT_OFFS,
  FN_SK_PLANE_LOCK,
  FN_SK_PLANE_UNLOCK,
  FN_WAL_APPEND,
  FN_WAL_BARRIER,
  FN_WAL_DURABLE,
  // appended (workers > 1 only; null with a single worker)
  FN_RECV_BORROW_GROUP,
  FN_SK_APPLY_WAVE_LANE,
  FN_SK_OUT_BUF_LANE,
  FN_SK_OUT_OFFS_LANE,
  FN_COUNT
};

// --- observability counter block (versioned, append-only like RKC_*) --------

enum : int32_t {
  RTM_LOOPS = 0,        // runtime loop iterations
  RTM_WAKES_FRAME,      // blocking waits that returned a frame
  RTM_WAKES_IDLE,       // blocking waits that timed out / were kicked
  RTM_FRAMES_NATIVE,    // frames consumed by rk_ingest (handled + noop)
  RTM_FRAMES_BLOCK,     // ProposeBlock frames bound natively
  RTM_FRAMES_ESCALATED, // frames handed to the Python control plane
  RTM_FRAMES_DROPPED,   // frames dropped (spoof/skew/malformed)
  RTM_CMDS,             // command records consumed
  RTM_OPENS_SCALAR,     // scalar slots armed
  RTM_OPENS_BLOCK,      // block-bound slots armed
  RTM_TICKS,            // rk_tick activations
  RTM_DECIDED_SCALAR,   // scalar decides handed to Python
  RTM_WAVES_NATIVE,     // decided block waves applied natively (no GIL)
  RTM_WAVES_PY,         // decided waves that needed a Python handoff
  RTM_SLOTS_APPLIED,    // slots applied through sk_apply_wave
  RTM_RESULT_BYTES,     // staged result bytes copied into the mailbox
  RTM_EV_RECORDS,       // event records appended
  RTM_EV_STALLS,        // times the event mailbox was full (backpressure)
  RTM_RETRANSMITS,      // stalled-shard vote retransmission rounds
  RTM_STALE_REPAIRS,    // native stale-vote repair Decisions sent
  RTM_PAUSES,           // pause/resume round trips
  RTM_GIL_HANDOFFS,     // commit-path transitions that required Python
                        // (scalar decides + py waves): the acceptance
                        // counter — zero growth per steady-state native
                        // wave
  RTM_EV_DROPPED,       // event records larger than the whole mailbox
                        // (dropped instead of livelocking the thread)
  RTM_COUNT
};
static const int32_t RTM_COUNTERS_VERSION = 2;

// --- runtime stage profiler (versioned, append-only like RTM_*) --------------
//
// Cumulative CLOCK_MONOTONIC nanoseconds per loop stage. Every loop
// iteration is fully attributed: each instrumented section adds its
// duration to one stage AND to a per-iteration accumulator, and the
// iteration remainder lands in RTS_OTHER — so the stage sum equals the
// thread's wall time by construction ("where did the wall move" is a
// scrape, not a guess). Exported as rabia_runtime_stage_seconds{stage=…}
// via the engine registry; rendered by `python -m rabia_tpu profile`.

enum : int32_t {
  RTS_RECV_WAIT = 0,   // blocking inbox wait that returned a frame
  RTS_INGEST,          // frame pump: rk_ingest / native bind / escalate
  RTS_TICK,            // open collection + chained rk_tick stages
  RTS_APPLY,           // sk_apply_wave (decided waves applying in C)
  RTS_RESULT_STAGING,  // result copy-out + event record build/push
  RTS_BROADCAST,       // rt_broadcast_frames staging of tick out-frames
  RTS_CMD,             // command-ring drain (control-plane commands)
  RTS_TIMERS,          // retransmit / stale repair / stall escalation
  RTS_IDLE,            // blocking inbox wait that timed out; pause park
  RTS_OTHER,           // loop remainder (bookkeeping between sections)
  RTS_COUNT
};
static const int32_t RTS_VERSION = 1;

// --- SLO latency histogram block (versioned like RKC_*/SKC_*) ----------------
//
// HDR-style log-bucketed fixed-size histograms: per stage, RTH_BUCKETS
// u64 bucket counts + [RTH_BUCKETS] total count + [RTH_BUCKETS+1] sum of
// observed nanoseconds. Bucketing: 2^RTH_SUB_BITS sub-buckets per
// power-of-two octave starting at 2^RTH_MIN_EXP ns — bucket upper bound
// for octave o, sub s is 2^(RTH_MIN_EXP+o) * (2^SUB + s + 1) / 2^SUB
// (worst-case relative error 1/2^SUB per bucket). Values below the
// floor clamp into bucket 0, values past the top into the last bucket.
// observe() is branch-light bit math + three u64 increments: zero
// allocation on the hot path. The Python twin of the bucket bounds is
// rabia_tpu_torch.obs.registry.SLO_BUCKETS; both paths export the merged
// result as rabia_slo_seconds{stage=…}.

enum : int32_t {
  RTH_DECIDE_APPLY = 0,  // kernel decide -> native wave apply complete
  RTH_BROADCAST,         // tick vote/decision frames staged to the wire
  RTH_STAGE_COUNT
};
static const int32_t RTH_VERSION = 1;
static const int32_t RTH_SUB_BITS = 2;  // 4 sub-buckets per octave
static const int32_t RTH_MIN_EXP = 10;  // floor 1.024us
static const int32_t RTH_OCTAVES = 25;  // top bound 2^35 ns ~ 34.4s
static const int32_t RTH_BUCKETS = RTH_OCTAVES << RTH_SUB_BITS;
static const int32_t RTH_STRIDE = RTH_BUCKETS + 2;  // + count + sum_ns

// --- flight recorder (FrEvent ABI of hostkernel.cpp / obs/flight.py) --------

enum : uint8_t {
  FRE_RT_WAKE = 19,     // runtime thread wakeup (arg: 1 frames, 2 idle)
  FRE_RT_HANDOFF = 20,  // event record handed to Python (arg = ev type)
};

struct FrEvent {
  uint64_t t_ns;
  uint64_t slot;
  uint64_t batch;
  uint32_t shard;
  uint16_t peer;
  uint8_t kind;
  uint8_t arg;
};
static_assert(sizeof(FrEvent) == 32, "FrEvent ABI is 32 bytes");
static const int32_t RTM_FLIGHT_VERSION = 1;
static const uint32_t RTM_FLIGHT_CAP = 2048;  // power of two

// --- mailbox record types ---------------------------------------------------

// events (C -> Python); each record is u32 len | u8 type | payload
enum : uint8_t {
  EV_FRAME = 1,    // u16 row | frame bytes (escalated wire frame)
  EV_DECIDE = 2,   // u32 shard | u64 slot | u8 value | f64 opened_at
  EV_WAVE = 3,     // u64 token | u8 applied | u8 has_results | u32 count |
                   // count * (u32 shard | u64 slot | u32 bidx | u8 value)
                   // | if has_results: count * (u32 rlen | bytes)
  EV_REJECT = 4,   // u64 token | u32 bidx | u32 shard | u64 slot | u8 why
  EV_STALL = 5,    // u8 kind | u32 shard | u64 slot_or_token
                   // kind 0: scalar propose retransmit wanted
                   // kind 1: block announce retransmit wanted (token)
                   // kind 2: peer votes waiting, no binding (V0 candidate)
  EV_REPAIR = 7,   // u16 row | u32 n | n * u32 entry | frame bytes: a
                   // ProposeBlock whose listed entries took no binding
                   // (their slot decided here before the announce came,
                   // or the shard's binding is busy): Python keeps their
                   // payloads for the slots' decisions
  EV_LEDGER = 6,   // 16B block id | u32 count | count * (u32 shard |
                   // u64 slot): natively applied PEER-block wave entries
                   // (token 0 — no Python owner) whose K_WAVE records
                   // were staged with zero batch ids; the control plane
                   // derives bid = block_batch_id(block_id, shard) and
                   // backfills K_LEDGER so follower recovery repopulates
                   // the applied_ids dedup ledger (ROADMAP 3c)
};

// commands (Python -> C); u32 len | u8 type | payload
enum : uint8_t {
  CMD_OPEN_SCALAR = 1,  // u32 shard | u64 slot | u8 init | u32 flen | frame
  CMD_OPEN_WAVE = 2,    // u64 token | u8 want | u32 k | u32 announce_len |
                        // u32 blob_len | u32 total_ops |
                        // k * (u32 shard | u64 slot | u32 bidx | u32 nops) |
                        // total_ops * u32 op_len | announce | blob
  CMD_ADVANCE = 3,      // u32 count | count * (u32 shard | u64 new_applied)
  CMD_DECIDE = 4,       // u32 shard | u64 slot | u8 value (adopt at head)
  CMD_STOP = 5,
};

enum : int32_t {
  RTM_RUNNING = 0,
  RTM_PAUSE_REQ = 1,
  RTM_PAUSED = 2,
  RTM_STOPPED = 3,
};

// --- wire constants (core/serialization.py v3) ------------------------------

enum : uint8_t {
  MT_VOTE1 = 2,
  MT_VOTE2 = 3,
  MT_DECISION = 4,
  MT_PROPOSE_BLOCK = 10,
  FLAG_COMPRESSED = 0x01,
  FLAG_RECIPIENT = 0x02,
};

enum : int32_t { RK_HANDLED = 1, RK_NOOP = 2, RK_PY = 0, RK_DROP = -1 };
enum : int8_t { V0c = 0, V1c = 1 };

// --- small helpers ----------------------------------------------------------

// The io/tick thread ROLE (annotations.h ThreadRole): every function
// below marked RABIA_REQUIRES(rtm_io_role) touches state the runtime's
// single-writer-while-RUNNING contract reserves for the io thread —
// calling one from a control-plane entry point is a compile error under
// clang -Werror=thread-safety. The runtime handshake that actually
// transfers ownership (rtm_pause -> PAUSED -> mutate -> rtm_resume) is
// stress-checked under TSan in native/stress/stress_runtime.cpp.
static rabia::ThreadRole rtm_io_role{"runtime.io"};

static inline uint64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

static inline double wall_s() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t rd_u64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline double rd_f64(const uint8_t* p) {
  double v;
  memcpy(&v, p, 8);
  return v;
}
static inline void wr_u32(std::vector<uint8_t>& b, uint32_t v) {
  size_t w = b.size();
  b.resize(w + 4);
  memcpy(b.data() + w, &v, 4);
}
static inline void wr_u64(std::vector<uint8_t>& b, uint64_t v) {
  size_t w = b.size();
  b.resize(w + 8);
  memcpy(b.data() + w, &v, 8);
}
static inline void wr_f64(std::vector<uint8_t>& b, double v) {
  size_t w = b.size();
  b.resize(w + 8);
  memcpy(b.data() + w, &v, 8);
}

// --- the SPSC byte rings ----------------------------------------------------

// Records are u32 len | payload at (pos % cap); a record never wraps —
// when the tail of the buffer is too short, a u32 0xFFFFFFFF pad marker
// (when >= 4 bytes remain) skips to offset 0. head/tail are absolute
// monotonic byte counters; both sides run the producer/consumer halves
// in C (rtm_cmd_push / rtm_ev_drain are called from the Python thread),
// so the acquire/release pairing is real on every architecture.
struct ByteRing {
  std::vector<uint8_t> buf;
  std::atomic<uint64_t> head{0};  // producer cursor (bytes ever written)
  std::atomic<uint64_t> tail{0};  // consumer cursor (bytes ever consumed)

  int64_t cap() const { return (int64_t)buf.size(); }
  int64_t free_space() const {
    return cap() - (int64_t)(head.load(std::memory_order_relaxed) -
                             tail.load(std::memory_order_acquire));
  }
  // space a record of `len` payload bytes needs, worst case (pad + hdr)
  static int64_t need(int64_t len) { return len + 8; }

  bool push(const uint8_t* a, int64_t alen, const uint8_t* b, int64_t blen) {
    const int64_t len = alen + blen;
    if (free_space() < need(len)) return false;
    uint64_t h = head.load(std::memory_order_relaxed);
    int64_t at = (int64_t)(h % (uint64_t)cap());
    if (at + 4 + len > cap()) {
      // pad to the wrap point, restart at 0 (space already checked via
      // the conservative need(); re-check against the real layout)
      int64_t pad = cap() - at;
      if ((int64_t)(h + pad + 4 + len -
                    tail.load(std::memory_order_acquire)) > cap())
        return false;
      if (pad >= 4) {
        uint32_t marker = 0xFFFFFFFFu;
        memcpy(buf.data() + at, &marker, 4);
      }
      h += pad;
      at = 0;
    }
    uint32_t l32 = (uint32_t)len;
    memcpy(buf.data() + at, &l32, 4);
    memcpy(buf.data() + at + 4, a, (size_t)alen);
    if (blen) memcpy(buf.data() + at + 4 + alen, b, (size_t)blen);
    head.store(h + 4 + len, std::memory_order_release);
    return true;
  }

  // Pop records into `out` back to back as u32 len | payload; returns
  // bytes written. Stops before a record that would not fit.
  int64_t drain(uint8_t* out, int64_t out_cap) {
    uint64_t t = tail.load(std::memory_order_relaxed);
    const uint64_t h = head.load(std::memory_order_acquire);
    int64_t w = 0;
    while (t < h) {
      int64_t at = (int64_t)(t % (uint64_t)cap());
      if (at + 4 > cap()) {
        t += cap() - at;  // unmarked short tail: skip to 0
        continue;
      }
      uint32_t len = rd_u32(buf.data() + at);
      if (len == 0xFFFFFFFFu) {
        t += cap() - at;  // pad marker
        continue;
      }
      if (w + 4 + (int64_t)len > out_cap) break;
      memcpy(out + w, buf.data() + at, 4 + (size_t)len);
      w += 4 + len;
      t += 4 + len;
    }
    tail.store(t, std::memory_order_release);
    return w;
  }
};

// --- C-side block registry --------------------------------------------------

struct CBlk {
  std::vector<uint8_t> data;         // op blob (empty when !has_data)
  std::vector<int64_t> cmd_offsets;  // total+1 byte offsets into data
  std::vector<int64_t> starts;       // k+1 command-index prefix
  std::vector<int64_t> shards;       // k actual shard ids
  std::vector<int64_t> slots;        // k bound slots
  std::vector<uint32_t> bidx;        // k Python-side block indices
  uint64_t token = 0;                // 0 = peer block (no Python owner)
  int want = 0;                      // stage result frames on apply
  int has_data = 0;
  int64_t remaining = 0;             // live bindings (pending + open)
  double bound_at = 0.0;
  // 16B wire block id of a natively parsed peer block (has_block_id=1):
  // lets the control plane backfill K_LEDGER batch ids for C-staged
  // waves on NON-proposer replicas (EV_LEDGER) — batch ids derive
  // deterministically from (block_id, shard), core/blocks.py
  uint8_t block_id[16] = {0};
  int has_block_id = 0;
};

// One shard-group worker: a dedicated io/tick thread owning the commit
// path for shards [lo, hi) end-to-end — its own rk tick context, frame
// inbox (per-group transport routing), command/event SPSC rings (the
// Python-facing rtm_cmd_push/rtm_ev_drain entry points route/merge so
// the control plane still sees ONE ring pair), result-staging lane into
// the shared statekernel plane, WAL staging lane into the shared
// group-commit flush, and its own observability blocks (counters, stage
// profiler, SLO histograms, flight ring) summed at scrape. With one
// worker this is exactly the round-8 runtime, byte for byte.
struct RtmWorker {
  int32_t gid = 0;
  int64_t lo = 0, hi = 0;  // owned shard range
  void* rk = nullptr;      // this worker's rk tick context

  std::map<int64_t, CBlk> blocks;
  int64_t next_blk = 1;

  // open scratch (S-wide planes handed to rk_tick; only [lo,hi) used)
  std::vector<uint8_t> open_mask;
  std::vector<int32_t> open_slots;
  std::vector<int8_t> open_init;

  // outbound tick buffer
  std::vector<uint8_t> out;

  // mailboxes (SPSC: Python thread <-> this worker)
  ByteRing cmd, ev;
  std::vector<uint8_t> cmd_scratch;

  // stale-vote repair
  std::vector<int64_t> st_rows, st_shards, st_slots;
  std::vector<double> last_repair;  // per row
  uint64_t msg_counter = 0;

  std::atomic<int32_t> state{RTM_RUNNING};
  std::thread th;
  // start at 1: anything the control plane pre-ingested into the rk
  // ledger before rtm_start (frames the detached Python reader had
  // already pulled) gets its tick on the first iteration
  int restep = 1;
  double last_timers = 0.0;

  uint64_t ctrs[RTM_COUNT];
  uint64_t stg[RTS_COUNT];                   // stage profiler (ns)
  uint64_t hist[RTH_STAGE_COUNT * RTH_STRIDE];  // SLO histogram block
  std::vector<FrEvent> fr;
  // relaxed atomic: single-writer (this worker) but read by the Python
  // scrape path via rtm_flight_head while the loop runs (TSan stress
  // finding, round 13)
  std::atomic<uint64_t> fr_head{0};
};

struct RtmCtx {
  // geometry
  int32_t S, n, R, me, dec_ring;
  int32_t native_apply;  // sk plane present: decided waves apply in C
  int32_t W = 1;         // worker (= shard group) count
  int64_t chunk = 0;     // contiguous group width: group = s / chunk
  int64_t max_cmds, max_cmd_size;
  double max_future_skew, max_age, phase_timeout, grace;

  // handles + foreign entry points
  void* tr;
  void* sk;
  void* wal = nullptr;  // durability plane (walkernel.cpp), or null
  void* fns[FN_COUNT];

  // engine columns (borrowed; single-writer of shard s = the worker
  // owning s's group, while RUNNING)
  int64_t* next_slot;
  int64_t* applied;
  uint8_t* in_flight;
  int64_t* votes_seen;
  int64_t* tainted;
  double* last_progress;
  double* opened_at;
  int64_t* ring_slot;  // [S, dec_ring]
  int8_t* ring_val;
  // kernel views (borrowed)
  int32_t* kslot;
  int8_t* kdecided;
  uint8_t* kdone;
  uint8_t* knewly;

  std::vector<uint8_t> uuids;  // R * 16

  // per-shard runtime state (disjoint per-worker access by shard range)
  std::vector<int64_t> blk_pend_ref, blk_pend_pos, blk_pend_slot;
  std::vector<int64_t> blk_cur_ref, blk_cur_pos;
  std::vector<int64_t> sp_slot;          // pending scalar open slot (-1)
  std::vector<int8_t> sp_init;
  std::vector<std::vector<uint8_t>> sp_frame;  // propose frame to emit
  std::vector<double> stall_ev_at;       // EV_STALL rate limit per shard
  std::vector<double> votes_wait_at;     // kind-2 escalation rate limit
  // vote-barrier write-ahead (durability plane): a shard whose next
  // open outran the durable barrier parks here until the group-commit
  // fsync covers the barrier record's LSN
  std::vector<int64_t> bar_wait;

  int event_fd = -1;
  std::atomic<int32_t> stop_req{0};
  std::atomic<int32_t> pause_req{0};  // pause = a barrier across workers

  std::vector<std::unique_ptr<RtmWorker>> workers;

  int32_t group_of(int64_t s) const {
    if (W <= 1 || chunk <= 0) return 0;
    int64_t g = s / chunk;
    return (int32_t)(g >= W ? W - 1 : g);
  }
};

static inline void rth_observe(RtmWorker* w, int32_t stage, uint64_t ns)
    RABIA_REQUIRES(rtm_io_role) {
  uint64_t* h = w->hist + (size_t)stage * RTH_STRIDE;
  int32_t idx = 0;
  if (ns >= (1ull << RTH_MIN_EXP)) {
    const int32_t exp = 63 - __builtin_clzll(ns);
    const int32_t sub =
        (int32_t)((ns >> (exp - RTH_SUB_BITS)) & ((1 << RTH_SUB_BITS) - 1));
    idx = ((exp - RTH_MIN_EXP) << RTH_SUB_BITS) + sub;
    if (idx >= RTH_BUCKETS) idx = RTH_BUCKETS - 1;
  }
  h[idx]++;
  h[RTH_BUCKETS]++;
  h[RTH_BUCKETS + 1] += ns;
}

static inline void fr_rec(RtmWorker* w, uint8_t kind, uint8_t arg,
                          uint32_t shard, int64_t slot)
    RABIA_REQUIRES(rtm_io_role) {
  const uint64_t head = w->fr_head.load(std::memory_order_relaxed);
  FrEvent& e = w->fr[head & (RTM_FLIGHT_CAP - 1)];
  e.t_ns = mono_ns();
  e.slot = (uint64_t)slot;
  e.batch = 0;
  e.shard = shard;
  e.peer = 0xFFFF;
  e.kind = kind;
  e.arg = arg;
  w->fr_head.store(head + 1, std::memory_order_relaxed);
}

// Append one event record; spins (bounded sleeps) when the mailbox is
// full — backpressure on the commit path, exactly like the transport's
// bounded inbox, except nothing is dropped (Python's drain is
// eventfd-driven, so the stall resolves in microseconds).
static void ev_push(RtmCtx* c, RtmWorker* w, const std::vector<uint8_t>& rec)
    RABIA_REQUIRES(rtm_io_role) {
  if (ByteRing::need((int64_t)rec.size()) > w->ev.cap()) {
    // a record larger than the whole mailbox can never be delivered:
    // drop it (counted) instead of spinning the commit path forever.
    // The ring default is sized above the transport's 16 MiB frame cap,
    // so only pathological wave-result sections can land here; the
    // protocol's retransmit/sync machinery owns recovery.
    w->ctrs[RTM_EV_DROPPED]++;
    return;
  }
  while (!w->ev.push(rec.data(), (int64_t)rec.size(), nullptr, 0)) {
    w->ctrs[RTM_EV_STALLS]++;
    uint64_t one = 1;
    (void)!write(c->event_fd, &one, 8);
    usleep(500);
    if (c->stop_req.load(std::memory_order_relaxed)) {
      // shutdown with the mailbox STILL full after the stall loop:
      // nothing will drain it before the thread joins, so this record
      // is lost — count it so the drop is visible in /metrics instead
      // of silently violating the drain-on-shutdown contract (only
      // reachable when shutdown races a full 20 MB mailbox)
      w->ctrs[RTM_EV_DROPPED]++;
      return;
    }
  }
  w->ctrs[RTM_EV_RECORDS]++;
  fr_rec(w, FRE_RT_HANDOFF, rec.empty() ? 0 : rec[0], 0, 0);
  uint64_t one = 1;
  (void)!write(c->event_fd, &one, 8);
}

static int32_t row_of(RtmCtx* c, const uint8_t sender[16]) {
  for (int32_t r = 0; r < c->R; r++) {
    if (memcmp(c->uuids.data() + (size_t)r * 16, sender, 16) == 0) return r;
  }
  return -1;
}

// --- outbound framing (v3 wire header, mirrors hostkernel rk_msg_id) --------

static inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x21F0AAADu;
  h ^= h >> 15;
  h *= 0x735A2D97u;
  h ^= h >> 15;
  return h;
}

static void rtm_msg_id(RtmCtx* c, RtmWorker* w, uint8_t* out)
    RABIA_REQUIRES(rtm_io_role) {
  const uint64_t ctr = ++w->msg_counter;
  // gid-salted stream so sibling workers never collide; gid 0 (and the
  // single-worker path) reproduces the historical ids bit for bit
  uint32_t h = mix32(0x52544D00u ^ (uint32_t)(c->me * 0x85EBCA6Bu) ^
                     (uint32_t)(w->gid * 0x9E3779B1u));
  for (int w = 0; w < 4; w++) {
    h = mix32(h ^ (uint32_t)(ctr >> (16 * (w & 1))) ^ 0x9E3779B9u * (w + 1));
    memcpy(out + 4 * w, &h, 4);
  }
  out[6] = (out[6] & 0x0F) | 0x40;
  out[8] = (out[8] & 0x3F) | 0x80;
}

// Build a bid-free Decision frame for explicit (shard, slot, value)
// entries (the native stale-vote repair; rk_emit_frame only frames the
// kernel's CURRENT slots). Returns frame length.
static int64_t build_decision_frame(RtmCtx* c, RtmWorker* w,
                                    std::vector<uint8_t>& f, double now,
                                    const int64_t* shards,
                                    const int64_t* slots, const int8_t* vals,
                                    int32_t count)
    RABIA_REQUIRES(rtm_io_role) {
  f.clear();
  const uint32_t body_len = 4 + (uint32_t)count * 14;
  f.resize(47 + body_len);
  uint8_t* p = f.data();
  p[0] = 3;
  p[1] = MT_DECISION;
  p[2] = 0;
  rtm_msg_id(c, w, p + 3);
  memcpy(p + 19, c->uuids.data() + (size_t)c->me * 16, 16);
  memcpy(p + 35, &now, 8);
  memcpy(p + 43, &body_len, 4);
  uint8_t* body = p + 47;
  const uint32_t cnt = (uint32_t)count;
  memcpy(body, &cnt, 4);
  uint8_t* e = body + 4;
  for (int32_t k = 0; k < count; k++) {
    const uint32_t su = (uint32_t)shards[k];
    const uint64_t ph = ((uint64_t)slots[k]) << 16;
    memcpy(e, &su, 4);
    memcpy(e + 4, &ph, 8);
    e[12] = (uint8_t)vals[k];
    e[13] = 0;
    e += 14;
  }
  return (int64_t)f.size();
}

// --- ProposeBlock native parse ----------------------------------------------

// Wire: v3 header | body: 16B block id | u32 k | k*u32 shards | k*u64
// slots | k*u32 counts | u32 total | total*u32 cmd_sizes | u32 blob_len
// | blob | u32 crc32(blob). Binding acceptance mirrors
// engine._on_propose_block element-for-element: proposer row must own
// each (shard, slot), slot >= applied, binding slot free, slot >= head.
// Returns 1 bound-something, 0 nothing-bound (still consumed), -1 not a
// parseable block (caller escalates), -2 drop (bad checksum/limits).
static int parse_propose_block(RtmCtx* c, RtmWorker* w, const uint8_t* data,
                               int64_t len, int32_t row, double now)
    RABIA_REQUIRES(rtm_io_role) {
  if (len < 47) return -1;
  if (data[0] != 3 || data[1] != MT_PROPOSE_BLOCK) return -1;
  const uint8_t flags = data[2];
  if (flags & FLAG_COMPRESSED) return -1;
  if (memcmp(data + 19, c->uuids.data() + (size_t)row * 16, 16) != 0) {
    w->ctrs[RTM_FRAMES_DROPPED]++;
    return -2;  // spoofed envelope
  }
  int64_t base = 35 + ((flags & FLAG_RECIPIENT) ? 16 : 0);
  if (len < base + 12) return -1;
  const double ts = rd_f64(data + base);
  if (ts > now + c->max_future_skew || ts < now - c->max_age) {
    w->ctrs[RTM_FRAMES_DROPPED]++;
    return -2;
  }
  const uint32_t body_len = rd_u32(data + base + 8);
  const uint8_t* body = data + base + 12;
  if ((int64_t)body_len > len - (base + 12)) return -1;
  if (body_len < 16 + 4) return -1;
  const uint32_t k = rd_u32(body + 16);
  if (k == 0 || k > (uint32_t)c->n) return -1;
  // fixed-section bounds before any pointer arithmetic (wire fields are
  // attacker-controlled; everything is 64-bit so the sums cannot wrap)
  uint64_t off = 16 + 4 + (uint64_t)k * 16;
  if (off + 4 > body_len) return -1;
  const uint8_t* sh_arr = body + 20;
  const uint8_t* sl_arr = sh_arr + (size_t)k * 4;
  const uint8_t* cnt_arr = sl_arr + (size_t)k * 8;
  const uint32_t total = rd_u32(body + off);
  off += 4;
  if (off + (uint64_t)total * 4 + 4 > body_len) return -1;
  const uint8_t* sz_arr = body + off;
  off += (uint64_t)total * 4;
  const uint32_t blob_len = rd_u32(body + off);
  off += 4;
  if (off + (uint64_t)blob_len + 4 > body_len) return -1;
  const uint8_t* blob = body + off;
  const uint32_t crc_wire = rd_u32(body + off + blob_len);
  if ((uint32_t)crc32(0, blob, blob_len) != crc_wire) {
    w->ctrs[RTM_FRAMES_DROPPED]++;
    return -2;
  }
  // validator-parity limits + structural sums
  uint64_t cnt_sum = 0;
  for (uint32_t i = 0; i < k; i++) {
    const uint32_t cc = rd_u32(cnt_arr + (size_t)i * 4);
    if ((int64_t)cc > c->max_cmds) return -2;
    cnt_sum += cc;
  }
  if (cnt_sum != total) return -1;
  uint64_t sz_sum = 0;
  for (uint32_t i = 0; i < total; i++) {
    const uint32_t sz = rd_u32(sz_arr + (size_t)i * 4);
    if ((int64_t)sz > c->max_cmd_size) return -2;
    sz_sum += sz;
  }
  if (sz_sum != blob_len) return -1;

  // binding pass (first binding wins; in-bounds shards of THIS worker's
  // group only — sibling workers bind their own entries from their copy)
  std::vector<uint32_t> acc;
  acc.reserve(k);
  std::vector<uint32_t> repair;
  for (uint32_t i = 0; i < k; i++) {
    const int64_t s = (int64_t)rd_u32(sh_arr + (size_t)i * 4);
    const int64_t slot = (int64_t)rd_u64(sl_arr + (size_t)i * 8);
    if (s < 0 || s >= c->n) continue;
    if (s < w->lo || s >= w->hi) continue;  // another group's entry
    if ((s + slot) % c->R != row) continue;  // slot_proposer parity
    if (slot < c->applied[s]) continue;
    const int64_t head =
        c->next_slot[s] > c->applied[s] ? c->next_slot[s] : c->applied[s];
    if (slot < head) {
      // decided here before this announce arrived (a peer's Decision
      // overtook it) and not applied yet: the scalar record waits for
      // this payload
      repair.push_back(i);
      continue;
    }
    // one pending binding a shard; behind a current binding only for a
    // later slot (the next slot's announce can arrive while this replica
    // still decides the current one)
    if (c->blk_pend_ref[s] != -1 ||
        (c->blk_cur_ref[s] != -1 && slot <= head)) {
      // unbound: without its payload the slot would decide here with
      // nothing to apply
      repair.push_back(i);
      continue;
    }
    acc.push_back(i);
  }
  if (!repair.empty()) {
    std::vector<uint8_t> rec;
    rec.push_back(EV_REPAIR);
    rec.push_back((uint8_t)(row & 0xFF));
    rec.push_back((uint8_t)((row >> 8) & 0xFF));
    wr_u32(rec, (uint32_t)repair.size());
    for (uint32_t i : repair) wr_u32(rec, i);
    rec.insert(rec.end(), data, data + len);
    ev_push(c, w, rec);
  }
  if (acc.empty()) return 0;
  const int64_t ref = w->next_blk++;
  CBlk& b = w->blocks[ref];
  b.token = 0;
  b.want = 0;
  b.has_data = 1;
  b.bound_at = now;
  memcpy(b.block_id, body, 16);
  b.has_block_id = 1;
  b.data.assign(blob, blob + blob_len);
  b.cmd_offsets.resize((size_t)total + 1);
  b.cmd_offsets[0] = 0;
  for (uint32_t i = 0; i < total; i++)
    b.cmd_offsets[i + 1] =
        b.cmd_offsets[i] + (int64_t)rd_u32(sz_arr + (size_t)i * 4);
  b.starts.resize((size_t)k + 1);
  b.starts[0] = 0;
  for (uint32_t i = 0; i < k; i++)
    b.starts[i + 1] = b.starts[i] + (int64_t)rd_u32(cnt_arr + (size_t)i * 4);
  b.shards.resize(k);
  b.slots.resize(k);
  b.bidx.resize(k);
  for (uint32_t i = 0; i < k; i++) {
    b.shards[i] = (int64_t)rd_u32(sh_arr + (size_t)i * 4);
    b.slots[i] = (int64_t)rd_u64(sl_arr + (size_t)i * 8);
    b.bidx[i] = i;
  }
  b.remaining = (int64_t)acc.size();
  for (uint32_t i : acc) {
    const int64_t s = b.shards[i];
    c->blk_pend_ref[s] = ref;
    c->blk_pend_pos[s] = i;
    c->blk_pend_slot[s] = b.slots[i];
  }
  w->ctrs[RTM_FRAMES_BLOCK]++;
  return 1;
}

static void blk_unref(RtmWorker* w, int64_t ref, int64_t n)
    RABIA_REQUIRES(rtm_io_role) {
  auto it = w->blocks.find(ref);
  if (it == w->blocks.end()) return;
  it->second.remaining -= n;
  if (it->second.remaining <= 0) w->blocks.erase(it);
}

// A decided slot voids any pending binding it overtook (asyncio parity:
// _record_decision -> _void_pending_block); Python demotes/settles the
// owner through the reject event.
static void void_stale_pend(RtmCtx* c, RtmWorker* w, int64_t s, int64_t slot)
    RABIA_REQUIRES(rtm_io_role) {
  if (c->blk_pend_ref[s] != -1 && c->blk_pend_slot[s] <= slot) {
    auto it = w->blocks.find(c->blk_pend_ref[s]);
    if (it != w->blocks.end()) {
      std::vector<uint8_t> rec;
      rec.push_back(EV_REJECT);
      wr_u64(rec, it->second.token);
      wr_u32(rec, it->second.bidx[c->blk_pend_pos[s]]);
      wr_u32(rec, (uint32_t)s);
      wr_u64(rec, (uint64_t)c->blk_pend_slot[s]);
      rec.push_back(2);
      ev_push(c, w, rec);
    }
    blk_unref(w, c->blk_pend_ref[s], 1);
    c->blk_pend_ref[s] = -1;
    c->blk_pend_slot[s] = -1;
  }
  if (c->sp_slot[s] != -1 && c->sp_slot[s] <= slot) {
    c->sp_slot[s] = -1;
    c->sp_frame[s].clear();
  }
}

}  // extern "C" (reopened below; internal linkage helpers end here)

extern "C" {

// --- command processing -----------------------------------------------------

static void handle_cmd(RtmCtx* c, RtmWorker* w, const uint8_t* p,
                       int64_t len, double now)
    RABIA_REQUIRES(rtm_io_role) {
  if (len < 1) return;
  const uint8_t type = p[0];
  const uint8_t* q = p + 1;
  w->ctrs[RTM_CMDS]++;
  if (type == CMD_OPEN_SCALAR) {
    if (len < 1 + 4 + 8 + 1 + 4) return;
    const int64_t s = (int64_t)rd_u32(q);
    const int64_t slot = (int64_t)rd_u64(q + 4);
    const int8_t init = (int8_t)q[12];
    const uint32_t flen = rd_u32(q + 13);
    if (s < w->lo || s >= w->hi) return;
    if (slot < c->applied[s] || c->in_flight[s] ||
        (c->blk_pend_ref[s] != -1 && c->blk_pend_slot[s] <= slot)) {
      std::vector<uint8_t> rec;
      rec.push_back(EV_REJECT);
      wr_u64(rec, 0);
      wr_u32(rec, 0);
      wr_u32(rec, (uint32_t)s);
      wr_u64(rec, (uint64_t)slot);
      rec.push_back(1);
      ev_push(c, w, rec);
      return;
    }
    c->sp_slot[s] = slot;
    c->sp_init[s] = init;
    c->sp_frame[s].assign(q + 17, q + 17 + flen);
  } else if (type == CMD_OPEN_WAVE) {
    if (len < 1 + 8 + 1 + 4 + 4 + 4) return;
    const uint64_t token = rd_u64(q);
    const uint8_t want = q[8];
    const uint32_t k = rd_u32(q + 9);
    const uint32_t announce_len = rd_u32(q + 13);
    const uint32_t blob_len = rd_u32(q + 17);
    const uint32_t total = rd_u32(q + 21);
    const uint8_t* ent = q + 25;
    const uint8_t* ops = ent + (size_t)k * 20;
    const uint8_t* announce = ops + (size_t)total * 4;
    const uint8_t* blob = announce + announce_len;
    const int64_t ref = w->next_blk++;
    CBlk& b = w->blocks[ref];
    b.token = token;
    b.want = want;
    b.has_data = blob_len > 0;
    b.bound_at = now;
    if (blob_len) b.data.assign(blob, blob + blob_len);
    b.shards.resize(k);
    b.slots.resize(k);
    b.bidx.resize(k);
    b.starts.resize((size_t)k + 1);
    b.starts[0] = 0;
    uint64_t op_at = 0;
    for (uint32_t i = 0; i < k; i++) {
      const uint8_t* e = ent + (size_t)i * 20;
      b.shards[i] = (int64_t)rd_u32(e);
      b.slots[i] = (int64_t)rd_u64(e + 4);
      b.bidx[i] = rd_u32(e + 12);
      const uint32_t nops = rd_u32(e + 16);
      op_at += nops;
      b.starts[i + 1] = (int64_t)op_at;
    }
    b.cmd_offsets.resize((size_t)total + 1);
    b.cmd_offsets[0] = 0;
    for (uint32_t i = 0; i < total; i++)
      b.cmd_offsets[i + 1] =
          b.cmd_offsets[i] + (int64_t)rd_u32(ops + (size_t)i * 4);
    b.remaining = 0;
    for (uint32_t i = 0; i < k; i++) {
      const int64_t s = b.shards[i];
      const int64_t slot = b.slots[i];
      bool ok = s >= w->lo && s < w->hi && slot >= c->applied[s] &&
                c->blk_pend_ref[s] == -1 && c->blk_cur_ref[s] == -1;
      if (ok) {
        const int64_t head =
            c->next_slot[s] > c->applied[s] ? c->next_slot[s] : c->applied[s];
        ok = slot >= head && c->tainted[s] <= slot;
      }
      if (!ok) {
        std::vector<uint8_t> rec;
        rec.push_back(EV_REJECT);
        wr_u64(rec, token);
        wr_u32(rec, b.bidx[i]);
        wr_u32(rec, (uint32_t)s);
        wr_u64(rec, (uint64_t)slot);
        rec.push_back(1);
        ev_push(c, w, rec);
        continue;
      }
      c->blk_pend_ref[s] = ref;
      c->blk_pend_pos[s] = i;
      c->blk_pend_slot[s] = slot;
      b.remaining++;
    }
    if (b.remaining == 0) {
      w->blocks.erase(ref);
      return;
    }
    if (announce_len) {
      // broadcast the ProposeBlock announce BEFORE any open/vote frame
      // (asyncio parity: announces flush ahead of the kernel round)
      std::vector<uint8_t> one(4 + announce_len);
      memcpy(one.data(), &announce_len, 4);
      memcpy(one.data() + 4, announce, announce_len);
      ((fn_bcast_frames_t)c->fns[FN_BCAST_FRAMES])(c->tr, one.data(),
                                                   (int64_t)one.size());
    }
  } else if (type == CMD_ADVANCE) {
    if (len < 1 + 4) return;
    const uint32_t count = rd_u32(q);
    const uint8_t* e = q + 4;
    for (uint32_t i = 0; i < count && 1 + 4 + (int64_t)(i + 1) * 12 <= len;
         i++) {
      const int64_t s = (int64_t)rd_u32(e + (size_t)i * 12);
      const int64_t upto = (int64_t)rd_u64(e + (size_t)i * 12 + 4);
      if (s >= w->lo && s < w->hi && upto > c->applied[s])
        c->applied[s] = upto;
    }
  } else if (type == CMD_DECIDE) {
    if (len < 1 + 4 + 8 + 1) return;
    const int64_t s = (int64_t)rd_u32(q);
    const int64_t slot = (int64_t)rd_u64(q + 4);
    const int8_t val = (int8_t)q[12];
    if (s < w->lo || s >= w->hi || c->in_flight[s]) return;
    const int64_t head =
        c->next_slot[s] > c->applied[s] ? c->next_slot[s] : c->applied[s];
    if (slot != head) return;
    if (c->blk_pend_ref[s] != -1 && c->blk_pend_slot[s] == slot) {
      // a block binding holds this slot's payload: let it open and
      // decide through consensus/adoption instead — adopting here
      // would strand a payload-less V1 record on the control plane
      return;
    }
    // adopt: bookkeeping here, record/apply in Python — but ONLY off
    // the confirming event below (a silently-rejected adopt must not
    // leave Python with a record C never made)
    if (slot + 1 > c->next_slot[s]) c->next_slot[s] = slot + 1;
    const int64_t ring = slot & (c->dec_ring - 1);
    c->ring_slot[s * c->dec_ring + ring] = slot;
    c->ring_val[s * c->dec_ring + ring] = val;
    c->sp_slot[s] = -1;
    c->sp_frame[s].clear();
    std::vector<uint8_t> rec;
    rec.push_back(EV_DECIDE);
    wr_u32(rec, (uint32_t)s);
    wr_u64(rec, (uint64_t)slot);
    rec.push_back((uint8_t)val);
    wr_f64(rec, 0.0);
    ev_push(c, w, rec);
  } else if (type == CMD_STOP) {
    c->stop_req.store(1, std::memory_order_relaxed);
  }
}

static void drain_cmds(RtmCtx* c, RtmWorker* w, double now)
    RABIA_REQUIRES(rtm_io_role) {
  for (;;) {
    int64_t got = w->cmd.drain(w->cmd_scratch.data(),
                               (int64_t)w->cmd_scratch.size());
    if (got <= 0) break;
    int64_t at = 0;
    while (at + 4 <= got) {
      const uint32_t len = rd_u32(w->cmd_scratch.data() + at);
      handle_cmd(c, w, w->cmd_scratch.data() + at + 4, (int64_t)len, now);
      at += 4 + len;
    }
  }
}

// --- decided-slot processing ------------------------------------------------

static void process_decided(RtmCtx* c, RtmWorker* w, double now)
    RABIA_REQUIRES(rtm_io_role) {
  // group decided block-bound shards by ref; scalars stream directly
  std::map<int64_t, std::vector<int64_t>> waves;  // ref -> shard list
  for (int64_t s = w->lo; s < w->hi; s++) {
    if (!(c->kdone[s] && c->in_flight[s])) continue;
    const int64_t slot = (int64_t)c->kslot[s];
    const int8_t val = c->kdecided[s];
    c->knewly[s] = 0;
    if (c->blk_cur_ref[s] != -1) {
      // validate the binding still describes THIS slot: a sync adoption
      // (Python, under pause) can overtake an in-flight shard and leave
      // a stale cur binding — routing a later decide through it would
      // apply the wrong entry's ops
      auto bit = w->blocks.find(c->blk_cur_ref[s]);
      if (bit != w->blocks.end() &&
          bit->second.slots[c->blk_cur_pos[s]] == slot) {
        waves[c->blk_cur_ref[s]].push_back(s);
        continue;
      }
      blk_unref(w, c->blk_cur_ref[s], 1);
      c->blk_cur_ref[s] = -1;
    }
    if (c->blk_pend_ref[s] != -1 && c->blk_pend_slot[s] == slot &&
        val == V1c) {
      // a V1 decide adopted into a slot whose block binding never
      // OPENED here (we grace-opened V0, peers decided V1): the bound
      // payload still applies — promote the pending binding and route
      // through the wave path (asyncio parity: _process_decided's
      // blk_pending branch)
      c->blk_cur_ref[s] = c->blk_pend_ref[s];
      c->blk_cur_pos[s] = c->blk_pend_pos[s];
      c->blk_pend_ref[s] = -1;
      c->blk_pend_slot[s] = -1;
      waves[c->blk_cur_ref[s]].push_back(s);
      continue;
    }
    // scalar decide: consensus bookkeeping here, record/apply in Python
    c->in_flight[s] = 0;
    if (slot + 1 > c->next_slot[s]) c->next_slot[s] = slot + 1;
    const int64_t ring = slot & (c->dec_ring - 1);
    c->ring_slot[s * c->dec_ring + ring] = slot;
    c->ring_val[s * c->dec_ring + ring] = val;
    const double opened = c->opened_at[s];
    c->opened_at[s] = 0.0;
    void_stale_pend(c, w, s, slot);
    std::vector<uint8_t> rec;
    rec.push_back(EV_DECIDE);
    wr_u32(rec, (uint32_t)s);
    wr_u64(rec, (uint64_t)slot);
    rec.push_back((uint8_t)val);
    wr_f64(rec, opened);
    ev_push(c, w, rec);
    w->ctrs[RTM_DECIDED_SCALAR]++;
    w->ctrs[RTM_GIL_HANDOFFS]++;
  }

  for (auto& [ref, shards] : waves) {
    auto bit = w->blocks.find(ref);
    if (bit == w->blocks.end()) {
      // registry raced empty (should not happen: refs release at decide)
      for (int64_t s : shards) {
        c->in_flight[s] = 0;
        c->blk_cur_ref[s] = -1;
      }
      continue;
    }
    CBlk& b = bit->second;
    // classify entries; only in-order V1 entries of a data-bearing block
    // apply natively (asyncio parity: _finish_block_slots)
    std::vector<int64_t> idxs;  // block positions to apply (V1, in order)
    std::vector<int64_t> ent_shard, ent_slot, ent_pos;
    std::vector<uint32_t> ent_bidx;
    std::vector<int8_t> ent_val;
    std::vector<uint8_t> ent_in_order;
    const bool native = b.has_data && c->native_apply;
    for (int64_t s : shards) {
      const int64_t pos = c->blk_cur_pos[s];
      const int64_t slot = (int64_t)c->kslot[s];
      const int8_t val = c->kdecided[s];
      const bool in_order = c->applied[s] == slot;
      ent_shard.push_back(s);
      ent_slot.push_back(slot);
      ent_pos.push_back(pos);
      ent_bidx.push_back(b.bidx[pos]);
      ent_val.push_back(val);
      ent_in_order.push_back(in_order ? 1 : 0);
      if (val == V1c && in_order && native) idxs.push_back(pos);
    }
    int64_t staged = -1;
    const int32_t want = (b.token != 0 && b.want) ? 1 : 0;
    // per-entry staged-result slices, captured below while the plane
    // lock is still held (slice i of res_bytes has length res_len[i],
    // concatenated in entry order)
    std::vector<int64_t> res_len(ent_shard.size(), 0);
    std::vector<uint8_t> res_bytes;
    if (native && !idxs.empty()) {
      // Single-worker path: hold the store-plane lock across the apply
      // AND the result read-out — the asyncio thread's scalar applies
      // (sk_apply_ops) clear and regrow the SAME out_buf, so reading it
      // after sk_apply_wave's internal lock is released races a
      // concurrent clear/realloc. The plane mutex is recursive, so
      // bracketing the call is safe — but the bracket must end before
      // any ev_push (a full mailbox blocks until Python drains, and
      // Python's drain paths take this lock: holding it there would
      // deadlock).
      //
      // Multi-worker path: the wave is group-pure, so it applies through
      // this worker's PRIVATE statekernel lane (sk_apply_wave_lane) —
      // the group mutex is taken inside the call and the lane's staging
      // buffers have a single owner thread, so neither the apply nor the
      // read-out needs the plane-wide bracket. N workers' applies stop
      // serializing on the recursive plane mutex.
      const bool lane_apply = c->W > 1 &&
                              c->fns[FN_SK_APPLY_WAVE_LANE] != nullptr;
      const bool plane_held =
          !lane_apply && c->fns[FN_SK_PLANE_LOCK] != nullptr;
      if (plane_held)
        ((fn_sk_plane_lk_t)c->fns[FN_SK_PLANE_LOCK])(c->sk);
      const uint64_t ap0 = mono_ns();
      if (lane_apply) {
        staged = ((fn_sk_apply_lane_t)c->fns[FN_SK_APPLY_WAVE_LANE])(
            c->sk, w->gid, b.data.data(), b.cmd_offsets.data(),
            b.shards.data(), b.starts.data(), idxs.data(),
            (int64_t)idxs.size(), now, want);
      } else {
        staged = ((fn_sk_apply_wave_t)c->fns[FN_SK_APPLY_WAVE])(
            c->sk, b.data.data(), b.cmd_offsets.data(), b.shards.data(),
            b.starts.data(), idxs.data(), (int64_t)idxs.size(), now, want);
      }
      const uint64_t ap_ns = mono_ns() - ap0;
      w->stg[RTS_APPLY] += ap_ns;
      rth_observe(w, RTH_DECIDE_APPLY, ap_ns);
      if (want && staged >= 0) {
        const uint8_t* ob;
        const int64_t* offs;
        if (lane_apply) {
          ob = (const uint8_t*)((fn_sk_lane_ptr_t)
                                    c->fns[FN_SK_OUT_BUF_LANE])(c->sk,
                                                                w->gid);
          offs = (const int64_t*)((fn_sk_lane_ptr_t)
                                      c->fns[FN_SK_OUT_OFFS_LANE])(c->sk,
                                                                   w->gid);
        } else {
          ob = (const uint8_t*)((fn_sk_ptr_t)c->fns[FN_SK_OUT_BUF])(c->sk);
          offs =
              (const int64_t*)((fn_sk_ptr_t)c->fns[FN_SK_OUT_OFFS])(c->sk);
        }
        std::map<int64_t, std::pair<int64_t, int64_t>> ranges;  // pos->ops
        int64_t op_at = 0;
        for (int64_t pos : idxs) {
          const int64_t nops = b.starts[pos + 1] - b.starts[pos];
          ranges.emplace(pos, std::make_pair(op_at, op_at + nops));
          op_at += nops;
        }
        for (size_t i = 0; i < ent_shard.size(); i++) {
          auto rit = ranges.find(ent_pos[i]);
          if (rit == ranges.end()) continue;
          const int64_t lo = offs[rit->second.first];
          const int64_t hi = offs[rit->second.second];
          res_len[i] = hi - lo;
          if (hi > lo) {
            size_t wb = res_bytes.size();
            res_bytes.resize(wb + (size_t)(hi - lo));
            memcpy(res_bytes.data() + wb, ob + lo, (size_t)(hi - lo));
          }
        }
      }
      if (plane_held)
        ((fn_sk_plane_lk_t)c->fns[FN_SK_PLANE_UNLOCK])(c->sk);
      w->ctrs[RTM_SLOTS_APPLIED] += (uint64_t)idxs.size();
    }
    if (c->wal && native) {
      // durability plane: stage each in-order entry of the wave into
      // the WAL's group-commit lane BEFORE its EV_WAVE record reaches
      // Python — the gateway's result barrier then only has to wait on
      // the watermark. Payload layout = native_wal.encode_wave (the
      // Python twin is the semantics owner; keep byte-identical). The
      // batch id field is zeros here — the control plane backfills it
      // with a K_LEDGER record off the commit path (C never derives
      // deterministic batch ids).
      const uint64_t w0 = mono_ns();
      std::vector<uint8_t> pay;
      for (size_t i = 0; i < ent_shard.size(); i++) {
        if (!ent_in_order[i]) continue;  // py lane stages sync-overtaken
        const bool with_ops = ent_val[i] == V1c;
        pay.clear();
        pay.push_back(1);  // K_WAVE
        wr_u32(pay, (uint32_t)ent_shard[i]);
        wr_u64(pay, (uint64_t)ent_slot[i]);
        pay.push_back((uint8_t)ent_val[i]);
        pay.push_back(with_ops ? 1 : 0);
        if (with_ops) {
          pay.resize(pay.size() + 16, 0);  // bid: K_LEDGER backfills
          const int64_t pos = ent_pos[i];
          const int64_t lo = b.starts[pos], hi = b.starts[pos + 1];
          wr_u32(pay, (uint32_t)(hi - lo));
          for (int64_t j = lo; j < hi; j++) {
            const int64_t o0 = b.cmd_offsets[j], o1 = b.cmd_offsets[j + 1];
            wr_u32(pay, (uint32_t)(o1 - o0));
            size_t wb = pay.size();
            pay.resize(wb + (size_t)(o1 - o0));
            memcpy(pay.data() + wb, b.data.data() + o0, (size_t)(o1 - o0));
          }
        }
        ((fn_wal_append_t)c->fns[FN_WAL_APPEND])(c->wal, pay.data(),
                                                 (int64_t)pay.size());
      }
      w->stg[RTS_APPLY] += mono_ns() - w0;  // staging rides the apply stage
      if (b.token == 0 && b.has_block_id) {
        // receiver-side ledger completeness: hand the (block id, shard,
        // slot) tuples of the zero-bid K_WAVE records just staged to
        // Python, which backfills K_LEDGER off the commit path (the
        // proposer path backfills from its block registry in _on_wave)
        std::vector<uint8_t> lrec;
        uint32_t n_led = 0;
        for (size_t i = 0; i < ent_shard.size(); i++)
          if (ent_in_order[i] && ent_val[i] == V1c) n_led++;
        if (n_led) {
          lrec.push_back(EV_LEDGER);
          size_t wb = lrec.size();
          lrec.resize(wb + 16);
          memcpy(lrec.data() + wb, b.block_id, 16);
          wr_u32(lrec, n_led);
          for (size_t i = 0; i < ent_shard.size(); i++) {
            if (!ent_in_order[i] || ent_val[i] != V1c) continue;
            wr_u32(lrec, (uint32_t)ent_shard[i]);
            wr_u64(lrec, (uint64_t)ent_slot[i]);
          }
          ev_push(c, w, lrec);
        }
      }
    }
    // bookkeeping for every decided entry
    for (size_t i = 0; i < ent_shard.size(); i++) {
      const int64_t s = ent_shard[i];
      const int64_t slot = ent_slot[i];
      c->in_flight[s] = 0;
      c->opened_at[s] = 0.0;
      if (slot + 1 > c->next_slot[s]) c->next_slot[s] = slot + 1;
      const int64_t ring = slot & (c->dec_ring - 1);
      c->ring_slot[s * c->dec_ring + ring] = slot;
      c->ring_val[s * c->dec_ring + ring] = ent_val[i];
      if (native && ent_in_order[i]) c->applied[s] = slot + 1;
      c->blk_cur_ref[s] = -1;
      void_stale_pend(c, w, s, slot);
    }

    // one EV_WAVE per (ref, tick-batch)
    std::vector<uint8_t> rec;
    const uint8_t applied_flag = native ? 1 : 0;
    const uint8_t has_results = (native && want && staged >= 0) ? 1 : 0;
    rec.push_back(EV_WAVE);
    wr_u64(rec, b.token);
    rec.push_back(applied_flag);
    rec.push_back(has_results);
    wr_u32(rec, (uint32_t)ent_shard.size());
    for (size_t i = 0; i < ent_shard.size(); i++) {
      wr_u32(rec, (uint32_t)ent_shard[i]);
      wr_u64(rec, (uint64_t)ent_slot[i]);
      wr_u32(rec, ent_bidx[i]);
      // value bits 0-1; bit 2 flags out-of-order (sync-overtaken)
      // entries Python must route through its scalar ledger
      rec.push_back((uint8_t)ent_val[i] | (ent_in_order[i] ? 0 : 4));
    }
    if (has_results) {
      // results section: count * u32 rlen, then ONE concatenated payload
      // blob (entry order) — the Python side slices lazily with numpy
      // instead of a per-entry parse loop. Per-entry [u32 len][payload]
      // result records stay inside each entry's slice (the
      // rt_broadcast_frames staging format the plane emits). The slices
      // themselves were copied out of the plane's out_buf above, under
      // the plane lock.
      for (size_t i = 0; i < ent_shard.size(); i++)
        wr_u32(rec, (uint32_t)res_len[i]);
      if (!res_bytes.empty()) {
        size_t wb = rec.size();
        rec.resize(wb + res_bytes.size());
        memcpy(rec.data() + wb, res_bytes.data(), res_bytes.size());
        w->ctrs[RTM_RESULT_BYTES] += (uint64_t)res_bytes.size();
      }
    }
    blk_unref(w, ref, (int64_t)ent_shard.size());
    ev_push(c, w, rec);
    if (native) {
      // proposer-side future settle is Python bookkeeping but OFF the
      // commit path (peers already progressed) — not a GIL handoff
      w->ctrs[RTM_WAVES_NATIVE]++;
    } else {
      w->ctrs[RTM_WAVES_PY]++;
      w->ctrs[RTM_GIL_HANDOFFS]++;
    }
  }
}

// --- open collection --------------------------------------------------------

static int32_t collect_opens(RtmCtx* c, RtmWorker* w)
    RABIA_REQUIRES(rtm_io_role) {
  int32_t n_open = 0;
  // durability plane: the watermark read once per pass (an atomic load)
  const uint64_t wal_durable =
      c->wal ? ((fn_wal_durable_t)c->fns[FN_WAL_DURABLE])(c->wal) : 0;
  memset(w->open_mask.data() + w->lo, 0, (size_t)(w->hi - w->lo));
  for (int64_t s = w->lo; s < w->hi; s++) {
    if (c->in_flight[s]) continue;
    if (c->blk_cur_ref[s] != -1) {
      // idle shard with a cur binding = a sync adoption overtook the
      // open (Python cleared in_flight under pause): release it before
      // anything re-opens the shard
      blk_unref(w, c->blk_cur_ref[s], 1);
      c->blk_cur_ref[s] = -1;
    }
    if (c->blk_pend_ref[s] == -1 && c->sp_slot[s] == -1) continue;
    const int64_t head =
        c->next_slot[s] > c->applied[s] ? c->next_slot[s] : c->applied[s];
    if (c->wal) {
      // vote-barrier write-ahead: this replica's FIRST vote in any slot
      // >= the persisted barrier must not reach the wire until the
      // barrier record advancing past it is DURABLE — otherwise a
      // restart could re-vote differently in the same (slot, phase)
      // (equivocation). wal_barrier_covered is stride-amortized: the
      // common case returns 0 (covered) without touching the log, and
      // a shard that does advance it parks un-armed for the next loop
      // pass or two while the group-commit fsync lands (other shards
      // and the frame pump keep running — the io/tick thread NEVER
      // blocks on disk).
      if (c->bar_wait[s] > 0) {
        if (wal_durable < (uint64_t)c->bar_wait[s]) {
          w->restep = 1;  // stay hot: the fsync is typically ~100us out
          continue;
        }
        c->bar_wait[s] = 0;
      }
      const int64_t blsn = ((fn_wal_barrier_t)c->fns[FN_WAL_BARRIER])(
          c->wal, s, head);
      if (blsn > 0 && wal_durable < (uint64_t)blsn) {
        c->bar_wait[s] = blsn;
        w->restep = 1;
        continue;
      }
    }
    void_stale_pend(c, w, s, head - 1);  // drop bindings the head overtook
    // block binding at head wins (asyncio parity: bulk open runs first)
    if (c->blk_pend_ref[s] != -1 && c->blk_pend_slot[s] == head &&
        c->tainted[s] <= head) {
      c->blk_cur_ref[s] = c->blk_pend_ref[s];
      c->blk_cur_pos[s] = c->blk_pend_pos[s];
      c->blk_pend_ref[s] = -1;
      c->blk_pend_slot[s] = -1;
      w->open_mask[s] = 1;
      w->open_slots[s] = (int32_t)head;
      w->open_init[s] = V1c;
      n_open++;
      w->ctrs[RTM_OPENS_BLOCK]++;
      continue;
    }
    if (c->sp_slot[s] == head && c->tainted[s] <= head) {
      w->open_mask[s] = 1;
      w->open_slots[s] = (int32_t)head;
      w->open_init[s] = c->sp_init[s];
      n_open++;
      w->ctrs[RTM_OPENS_SCALAR]++;
      if (!c->sp_frame[s].empty()) {
        // Propose rides ahead of the open's R1 frame (asyncio parity)
        std::vector<uint8_t> one;
        const uint32_t flen = (uint32_t)c->sp_frame[s].size();
        wr_u32(one, flen);
        size_t wb = one.size();
        one.resize(wb + flen);
        memcpy(one.data() + wb, c->sp_frame[s].data(), flen);
        ((fn_bcast_frames_t)c->fns[FN_BCAST_FRAMES])(c->tr, one.data(),
                                                     (int64_t)one.size());
        c->sp_frame[s].clear();
      }
      c->sp_slot[s] = -1;
    }
  }
  if (n_open) {
    const double now = wall_s();
    for (int64_t s = w->lo; s < w->hi; s++) {
      if (!w->open_mask[s]) continue;
      c->in_flight[s] = 1;
      // next_slot = max(next_slot, slot) — np.maximum.at parity; the
      // +1 advance happens at decide
      if ((int64_t)w->open_slots[s] > c->next_slot[s])
        c->next_slot[s] = (int64_t)w->open_slots[s];
      c->opened_at[s] = now;
      c->last_progress[s] = now;
    }
  }
  return n_open;
}

// --- timers: retransmit, stale repair, stall escalation ---------------------

static void run_timers(RtmCtx* c, RtmWorker* w, double now)
    RABIA_REQUIRES(rtm_io_role) {
  // vote retransmits for stalled shards (pure C)
  int64_t res[4] = {0, 0, 0, 0};
  ((fn_rk_retransmit_t)c->fns[FN_RK_RETRANSMIT])(
      w->rk, now, c->phase_timeout, w->out.data(), (int64_t)w->out.size(),
      res);
  if (res[0] > 0) {
    ((fn_bcast_frames_t)c->fns[FN_BCAST_FRAMES])(c->tr, w->out.data(), res[0]);
    w->ctrs[RTM_RETRANSMITS]++;
  }
  if (res[1] > 0) {
    // payload retransmission is Python's (it owns the propose bytes):
    // escalate stalled shards' bindings, rate-limited per shard
    for (int64_t s = w->lo; s < w->hi; s++) {
      if (!c->in_flight[s]) continue;
      if (now - c->opened_at[s] < c->phase_timeout) continue;
      if (now - c->stall_ev_at[s] < c->phase_timeout) continue;
      c->stall_ev_at[s] = now;
      std::vector<uint8_t> rec;
      if (c->blk_cur_ref[s] != -1) {
        auto it = w->blocks.find(c->blk_cur_ref[s]);
        const uint64_t token = it != w->blocks.end() ? it->second.token : 0;
        rec.push_back(EV_STALL);
        rec.push_back(1);
        wr_u32(rec, (uint32_t)s);
        wr_u64(rec, token);
      } else {
        rec.push_back(EV_STALL);
        rec.push_back(0);
        wr_u32(rec, (uint32_t)s);
        wr_u64(rec, (uint64_t)c->kslot[s]);
      }
      ev_push(c, w, rec);
    }
  }
  // peer-votes-waiting escalation (the V0 grace path stays in Python).
  // Bounded per pass: at wide shard counts an unthrottled scan would
  // flood the mailbox with stall events faster than the control plane
  // can bind payloads, turning a transient binding lag into a V0-open
  // cascade (measured: ~1M stall events in one config-5 run).
  int32_t stall_budget = 128;
  for (int64_t s = w->lo; s < w->hi && stall_budget > 0; s++) {
    if (c->in_flight[s]) continue;
    const int64_t head =
        c->next_slot[s] > c->applied[s] ? c->next_slot[s] : c->applied[s];
    if (c->votes_seen[s] < head) continue;
    if (c->blk_pend_ref[s] != -1 || c->sp_slot[s] != -1) continue;
    if (now - c->votes_wait_at[s] < c->grace) continue;
    c->votes_wait_at[s] = now;
    stall_budget--;
    std::vector<uint8_t> rec;
    rec.push_back(EV_STALL);
    rec.push_back(2);
    wr_u32(rec, (uint32_t)s);
    wr_u64(rec, (uint64_t)head);
    ev_push(c, w, rec);
  }
  // native stale-vote repair from the decided-value ring (bid-free
  // Decisions, unicast, per-row rate limit — _repair_stale_sender parity)
  const int64_t k = ((fn_rk_drain_stale_t)c->fns[FN_RK_DRAIN_STALE])(
      w->rk, w->st_rows.data(), w->st_shards.data(), w->st_slots.data(),
      (int64_t)w->st_rows.size());
  if (k > 0) {
    const double limit =
        c->phase_timeout / 4 > 0.05 ? c->phase_timeout / 4 : 0.05;
    std::vector<int64_t> shards, slots;
    std::vector<int8_t> vals;
    for (int32_t row = 0; row < c->R; row++) {
      if (row == c->me) continue;
      shards.clear();
      slots.clear();
      vals.clear();
      for (int64_t i = 0; i < k && (int64_t)shards.size() < 256; i++) {
        if (w->st_rows[i] != row) continue;
        const int64_t s = w->st_shards[i];
        const int64_t slot = w->st_slots[i];
        const int64_t ring = slot & (c->dec_ring - 1);
        if (c->ring_slot[s * c->dec_ring + ring] != slot) continue;
        shards.push_back(s);
        slots.push_back(slot);
        vals.push_back(c->ring_val[s * c->dec_ring + ring]);
      }
      if (shards.empty()) continue;
      if (now - w->last_repair[row] < limit) continue;
      w->last_repair[row] = now;
      std::vector<uint8_t> f;
      build_decision_frame(c, w, f, now, shards.data(), slots.data(),
                           vals.data(), (int32_t)shards.size());
      ((fn_send_t)c->fns[FN_SEND])(c->tr,
                                   c->uuids.data() + (size_t)row * 16,
                                   f.data(), (uint32_t)f.size());
      w->ctrs[RTM_STALE_REPAIRS]++;
    }
  }
}

// --- frame classification (per-group transport routing) ---------------------

// Which shard groups must see this frame? Vote/Decision/ProposeBlock
// frames map their entry shards to groups (a workers=1 peer's mixed
// batch fans out — each worker's rk ctx ingests only its own range);
// everything else (Propose, sync, admin, malformed, non-v3) lands in
// group 0, whose worker owns control-plane escalation. Pure + read-only:
// the transport's io thread calls this through rt_set_groups, and
// workers recompute it for escalation dedup — same bytes, same mask.
static uint64_t group_mask_of(const RtmCtx* c, const uint8_t* data,
                              uint32_t len) {
  if (c->W <= 1) return 1;
  if (len < 47 || data[0] != 3) return 1;
  const uint8_t mt = data[1];
  const uint8_t flags = data[2];
  if (flags & FLAG_COMPRESSED) return 1;
  const uint32_t base = 35 + ((flags & FLAG_RECIPIENT) ? 16 : 0);
  if (len < base + 12) return 1;
  const uint32_t body_len = rd_u32(data + base + 8);
  if ((uint64_t)body_len > (uint64_t)len - (base + 12)) return 1;
  const uint8_t* body = data + base + 12;
  uint64_t mask = 0;
  if (mt == MT_VOTE1 || mt == MT_VOTE2 || mt == MT_DECISION) {
    if (body_len < 4) return 1;
    const uint32_t count = rd_u32(body);
    const uint32_t esz = (mt == MT_DECISION) ? 14u : 13u;
    if (4ull + (uint64_t)count * esz > body_len) return 1;
    const uint8_t* e = body + 4;
    for (uint32_t k = 0; k < count; k++, e += esz) {
      const uint32_t s = rd_u32(e);
      if (s < (uint32_t)c->n) mask |= 1ull << c->group_of((int64_t)s);
    }
    return mask ? mask : 1;
  }
  if (mt == MT_PROPOSE_BLOCK) {
    if (body_len < 20) return 1;
    const uint32_t k = rd_u32(body + 16);
    if (k == 0 || k > (uint32_t)c->n) return 1;
    if (20ull + (uint64_t)k * 16 > body_len) return 1;
    const uint8_t* sh = body + 20;
    for (uint32_t i = 0; i < k; i++) {
      const uint32_t s = rd_u32(sh + (size_t)i * 4);
      if (s < (uint32_t)c->n) mask |= 1ull << c->group_of((int64_t)s);
    }
    return mask ? mask : 1;
  }
  return 1;
}

// --- the io/tick loop -------------------------------------------------------

// One inbound frame through the native path: rk_ingest (votes/decisions),
// the native ProposeBlock binder, or escalation to the Python mailbox.
// Returns 1 when the frame had ledger/binding effects (a tick is due).
static int32_t handle_frame(RtmCtx* c, RtmWorker* w, int32_t row,
                            const uint8_t* fp, uint32_t flen, double now)
    RABIA_REQUIRES(rtm_io_role) {
  const int32_t rc =
      ((fn_rk_ingest_t)c->fns[FN_RK_INGEST])(w->rk, fp, (int64_t)flen, row,
                                             now);
  if (rc == RK_HANDLED) {
    w->ctrs[RTM_FRAMES_NATIVE]++;
    return 1;
  }
  if (rc == RK_NOOP) {
    w->ctrs[RTM_FRAMES_NATIVE]++;
    return 0;
  }
  if (rc == RK_DROP) {
    w->ctrs[RTM_FRAMES_DROPPED]++;
    return 0;
  }
  // RK_PY: bind blocks natively when the apply plane is native —
  // otherwise the frame goes up (Python owns binding AND apply there)
  if (flen >= 2 && fp[1] == MT_PROPOSE_BLOCK && c->native_apply) {
    const int brc = parse_propose_block(c, w, fp, (int64_t)flen, row, now);
    if (brc >= 0) return brc;
    if (brc == -2) return 0;  // dropped (spoof/skew/checksum/limits)
  }
  if (c->W > 1 && flen >= 2 && fp[1] == MT_PROPOSE_BLOCK) {
    // escalation dedup: a multi-group ProposeBlock was delivered to
    // every group it binds — exactly ONE worker (the lowest group in
    // the recomputed mask) hands it to Python, or _on_propose_block
    // would register duplicate block entries. Vote/Decision escalations
    // stay per-worker: their Python handlers are idempotent per entry.
    const uint64_t mask = group_mask_of(c, fp, flen);
    if (w->gid != __builtin_ctzll(mask ? mask : 1)) return 0;
  }
  std::vector<uint8_t> rec;
  rec.push_back(EV_FRAME);
  rec.push_back((uint8_t)(row & 0xFF));
  rec.push_back((uint8_t)((row >> 8) & 0xFF));
  size_t wat = rec.size();
  rec.resize(wat + flen);
  memcpy(rec.data() + wat, fp, flen);
  ev_push(c, w, rec);
  w->ctrs[RTM_FRAMES_ESCALATED]++;
  return 0;
}

// Stage bracket: add a measured duration to one RTS_* stage and to the
// iteration accumulator (the RTS_OTHER remainder computation needs every
// attributed nanosecond counted exactly once).
#define RTS_ADD(stage, dur)   \
  do {                        \
    const uint64_t _d = (dur); \
    w->stg[stage] += _d;      \
    acc += _d;                \
  } while (0)

static void rtm_loop(RtmCtx* c, RtmWorker* w) {
  // this thread IS the io role for its shard group: assert_capability
  // informs the analysis without emitting code (rtm_start spawns one
  // such thread per group; shard ranges are disjoint)
  rtm_io_role.assert_held();
  fn_recv_borrow_t recv_borrow = (fn_recv_borrow_t)c->fns[FN_RECV_BORROW];
  fn_recv_borrow_grp_t recv_borrow_grp =
      (fn_recv_borrow_grp_t)c->fns[FN_RECV_BORROW_GROUP];
  fn_recv_release_t recv_release = (fn_recv_release_t)c->fns[FN_RECV_RELEASE];
  fn_rk_tick_t rk_tick = (fn_rk_tick_t)c->fns[FN_RK_TICK];
  fn_bcast_frames_t bcast = (fn_bcast_frames_t)c->fns[FN_BCAST_FRAMES];
  const bool grouped = c->W > 1;
  uint8_t sender[16];
  const uint8_t* fp = nullptr;
  uint32_t flen = 0;
  int64_t res[8];
  const double timer_every =
      c->phase_timeout / 4 < 0.05 ? c->phase_timeout / 4 : 0.05;

  while (!c->stop_req.load(std::memory_order_relaxed)) {
    w->ctrs[RTM_LOOPS]++;
    const uint64_t it0 = mono_ns();
    uint64_t acc = 0, t0 = 0;
    double now = wall_s();
    t0 = mono_ns();
    drain_cmds(c, w, now);
    RTS_ADD(RTS_CMD, mono_ns() - t0);
    if (c->pause_req.load(std::memory_order_acquire)) {
      // the pause is a BARRIER handshake: every worker parks itself and
      // rtm_state reports PAUSED only once all of them have (the
      // round-13 release/acquire handshake, multiplied per worker)
      w->state.store(RTM_PAUSED, std::memory_order_release);
      w->ctrs[RTM_PAUSES]++;
      t0 = mono_ns();
      // acquire pairs with rtm_resume's release store: the control
      // plane's while-PAUSED mutations of the shared arrays must be
      // visible before the loop reads them again
      while (c->pause_req.load(std::memory_order_acquire) &&
             !c->stop_req.load(std::memory_order_relaxed))
        usleep(200);
      RTS_ADD(RTS_IDLE, mono_ns() - t0);
      w->state.store(RTM_RUNNING, std::memory_order_release);
      w->stg[RTS_OTHER] += (mono_ns() - it0) - acc;
      continue;
    }

    // nonblocking frame pump: rk_ingest consumes vote/decision frames in
    // place; ProposeBlock binds natively; everything else escalates
    int32_t got = 0, consumed = 0;
    t0 = mono_ns();
    while (consumed < 512) {
      const int64_t tok =
          grouped ? recv_borrow_grp(c->tr, w->gid, sender, &fp, &flen, 0)
                  : recv_borrow(c->tr, sender, &fp, &flen, 0);
      if (tok < 0) break;
      consumed++;
      const int32_t row = row_of(c, sender);
      if (row >= 0) got += handle_frame(c, w, row, fp, flen, now);
      recv_release(c->tr, tok);
    }
    RTS_ADD(RTS_INGEST, mono_ns() - t0);

    t0 = mono_ns();
    const int32_t n_open = collect_opens(c, w);
    RTS_ADD(RTS_TICK, mono_ns() - t0);
    if (got || n_open || w->restep) {
      w->restep = 0;
      now = wall_s();
      t0 = mono_ns();
      rk_tick(w->rk, now, w->out.data(), (int64_t)w->out.size(), 4,
              n_open ? w->open_mask.data() : nullptr,
              n_open ? w->open_slots.data() : nullptr,
              n_open ? w->open_init.data() : nullptr, res);
      RTS_ADD(RTS_TICK, mono_ns() - t0);
      w->ctrs[RTM_TICKS]++;
      if (res[0] > 0) {
        t0 = mono_ns();
        bcast(c->tr, w->out.data(), res[0]);
        const uint64_t bc_ns = mono_ns() - t0;
        RTS_ADD(RTS_BROADCAST, bc_ns);
        rth_observe(w, RTH_BROADCAST, bc_ns);
      }
      if (res[2]) w->restep = 1;
      if (res[1]) {
        // process_decided brackets its own sk_apply_wave sections into
        // RTS_APPLY; everything else it does (decision bookkeeping,
        // result copy-out, event-record staging) is result staging
        const uint64_t a0 = w->stg[RTS_APPLY];
        t0 = mono_ns();
        process_decided(c, w, now);
        const uint64_t pd = mono_ns() - t0;
        const uint64_t ap = w->stg[RTS_APPLY] - a0;
        w->stg[RTS_RESULT_STAGING] += pd > ap ? pd - ap : 0;
        acc += pd;
      }
    }

    if (now - w->last_timers >= timer_every) {
      w->last_timers = now;
      t0 = mono_ns();
      run_timers(c, w, now);
      RTS_ADD(RTS_TIMERS, mono_ns() - t0);
    }

    if (w->restep) {
      w->stg[RTS_OTHER] += (mono_ns() - it0) - acc;
      continue;
    }
    if (consumed) {
      fr_rec(w, FRE_RT_WAKE, 1, 0, 0);
      w->ctrs[RTM_WAKES_FRAME]++;
      w->stg[RTS_OTHER] += (mono_ns() - it0) - acc;
      continue;  // stay hot while traffic flows
    }
    // idle: block on the transport inbox (frames and rt_inbox_kick both
    // wake it). Capped at 5ms — rt_inbox_kick is lock-free, so a kick
    // can (rarely) lose its wakeup; the cap bounds that race AND keeps
    // timer latency tight without burning idle CPU.
    int timeout_ms = (int)(timer_every * 1000.0);
    if (timeout_ms > 5) timeout_ms = 5;
    if (timeout_ms < 1) timeout_ms = 1;
    t0 = mono_ns();
    const int64_t tok =
        grouped
            ? recv_borrow_grp(c->tr, w->gid, sender, &fp, &flen, timeout_ms)
            : recv_borrow(c->tr, sender, &fp, &flen, timeout_ms);
    if (tok >= 0) {
      RTS_ADD(RTS_RECV_WAIT, mono_ns() - t0);
      t0 = mono_ns();
      const int32_t row = row_of(c, sender);
      if (row >= 0 && handle_frame(c, w, row, fp, flen, wall_s()))
        w->restep = 1;  // force a tick next iteration
      recv_release(c->tr, tok);
      RTS_ADD(RTS_INGEST, mono_ns() - t0);
      fr_rec(w, FRE_RT_WAKE, 1, 0, 0);
      w->ctrs[RTM_WAKES_FRAME]++;
    } else {
      RTS_ADD(RTS_IDLE, mono_ns() - t0);
      fr_rec(w, FRE_RT_WAKE, 2, 0, 0);
      w->ctrs[RTM_WAKES_IDLE]++;
    }
    w->stg[RTS_OTHER] += (mono_ns() - it0) - acc;
  }
  w->state.store(RTM_STOPPED, std::memory_order_release);
  uint64_t one = 1;
  (void)!write(c->event_fd, &one, 8);
}

// --- lifecycle / ABI --------------------------------------------------------

// dims: [S, n, R, me, dec_ring, native_apply, cmd_ring_cap, ev_ring_cap,
//        max_cmds_per_batch, max_cmd_size, workers]
//        (workers: shard-group worker threads; <= 1 or absent = the
//         single-thread runtime, byte-for-byte the round-8 behavior)
// ptrs: [rk_ctx, transport, sk_plane, next_slot, applied, in_flight,
//        votes_seen, tainted, last_progress, opened_at, ring_slot,
//        ring_val, kslot, kdecided, kdone, knewly, wal_ctx,
//        rk_ctx_1 .. rk_ctx_{workers-1}]
//        (wal_ctx: walkernel handle or 0 — the durability plane; the
//         extra rk handles are the per-worker tick contexts, already
//         range-restricted via rk_set_range by the bridge)
// fns:  FN_* order above
// fparams: [max_future_skew, max_age, phase_timeout, grace]
void* rtm_create(const int64_t* dims, const int64_t* ptrs, const int64_t* fns,
                 const uint8_t* uuids, const double* fparams) {
  RtmCtx* c = new RtmCtx();
  c->S = (int32_t)dims[0];
  c->n = (int32_t)dims[1];
  c->R = (int32_t)dims[2];
  c->me = (int32_t)dims[3];
  c->dec_ring = (int32_t)dims[4];
  c->native_apply = (int32_t)dims[5];
  const int64_t cmd_cap = dims[6] > 0 ? dims[6] : (8 << 20);
  const int64_t ev_cap = dims[7] > 0 ? dims[7] : (20 << 20);
  c->max_cmds = dims[8];
  c->max_cmd_size = dims[9];
  int32_t W = (int32_t)dims[10];
  if (W < 1) W = 1;
  if (W > 64) W = 64;
  if (W > c->n) W = c->n > 0 ? c->n : 1;
  c->chunk = (c->n + W - 1) / W;
  // every group non-empty: with chunk = ceil(n / W), W groups of chunk
  // shards can overrun n by more than one chunk (8 shards, W = 7: chunk
  // 2, groups 4..6 start at or past 8), and an empty group's lo > hi
  // makes collect_opens memset a negative length. W = ceil(n / chunk)
  // keeps the chunk and drops the groups that would start past n; the
  // bridge's resolve_runtime_workers computes the same W.
  if (c->n > 0) W = (int32_t)((c->n + c->chunk - 1) / c->chunk);
  c->W = W;
  int i = 0;
  void* rk0 = (void*)ptrs[i++];
  c->tr = (void*)ptrs[i++];
  c->sk = (void*)ptrs[i++];
  c->next_slot = (int64_t*)ptrs[i++];
  c->applied = (int64_t*)ptrs[i++];
  c->in_flight = (uint8_t*)ptrs[i++];
  c->votes_seen = (int64_t*)ptrs[i++];
  c->tainted = (int64_t*)ptrs[i++];
  c->last_progress = (double*)ptrs[i++];
  c->opened_at = (double*)ptrs[i++];
  c->ring_slot = (int64_t*)ptrs[i++];
  c->ring_val = (int8_t*)ptrs[i++];
  c->kslot = (int32_t*)ptrs[i++];
  c->kdecided = (int8_t*)ptrs[i++];
  c->kdone = (uint8_t*)ptrs[i++];
  c->knewly = (uint8_t*)ptrs[i++];
  c->wal = (void*)ptrs[i++];
  for (int j = 0; j < FN_COUNT; j++) c->fns[j] = (void*)fns[j];
  if (!c->fns[FN_WAL_APPEND] || !c->fns[FN_WAL_BARRIER] ||
      !c->fns[FN_WAL_DURABLE])
    c->wal = nullptr;
  c->uuids.assign(uuids, uuids + (size_t)c->R * 16);
  c->max_future_skew = fparams[0];
  c->max_age = fparams[1];
  c->phase_timeout = fparams[2];
  c->grace = fparams[3];
  if (!c->native_apply) c->sk = nullptr;

  c->blk_pend_ref.assign(c->S, -1);
  c->blk_pend_pos.assign(c->S, 0);
  c->blk_pend_slot.assign(c->S, -1);
  c->blk_cur_ref.assign(c->S, -1);
  c->blk_cur_pos.assign(c->S, 0);
  c->sp_slot.assign(c->S, -1);
  c->sp_init.assign(c->S, 0);
  c->sp_frame.resize(c->S);
  c->stall_ev_at.assign(c->S, 0.0);
  c->votes_wait_at.assign(c->S, 0.0);
  c->bar_wait.assign(c->S, 0);
  c->event_fd = eventfd(0, EFD_NONBLOCK);

  for (int32_t g = 0; g < W; g++) {
    auto w = std::make_unique<RtmWorker>();
    w->gid = g;
    w->lo = (int64_t)g * c->chunk;
    w->hi = g == W - 1 ? (int64_t)c->n : (int64_t)(g + 1) * c->chunk;
    if (w->hi > c->n) w->hi = c->n;
    w->rk = g == 0 ? rk0 : (void*)ptrs[17 + (g - 1)];
    w->open_mask.assign(c->S, 0);
    w->open_slots.assign(c->S, 0);
    w->open_init.assign(c->S, 0);
    // outbound buffer: same sizing rule as NativeTick, with headroom
    w->out.resize((size_t)(4096 + 72 + 13 * (int64_t)c->n +
                           4 * (3 * 72 + 40 * (int64_t)c->n)));
    w->cmd.buf.resize((size_t)cmd_cap);
    w->ev.buf.resize((size_t)ev_cap);
    // scratch covers the whole ring: a record the push accepted must
    // always drain (a smaller scratch would wedge the command plane
    // behind the first oversized record)
    w->cmd_scratch.resize((size_t)cmd_cap);
    w->st_rows.assign(1024, 0);
    w->st_shards.assign(1024, 0);
    w->st_slots.assign(1024, 0);
    w->last_repair.assign(c->R, 0.0);
    memset(w->ctrs, 0, sizeof(w->ctrs));
    memset(w->stg, 0, sizeof(w->stg));
    memset(w->hist, 0, sizeof(w->hist));
    w->fr.resize(RTM_FLIGHT_CAP);
    c->workers.push_back(std::move(w));
  }
  return c;
}

// The transport classifier (rt_set_groups): pure, read-only, safe from
// the io thread while workers run.
uint64_t rtm_frame_group_mask(void* ctx, const uint8_t* data, uint32_t len) {
  return group_mask_of((const RtmCtx*)ctx, data, len);
}

int32_t rtm_workers(void* ctx) { return ((RtmCtx*)ctx)->W; }

// Shard-group geometry for the control plane: contiguous chunks of
// rtm_group_chunk(ctx) shards; group of shard s = min(s / chunk, W-1).
int64_t rtm_group_chunk(void* ctx) { return ((RtmCtx*)ctx)->chunk; }

int32_t rtm_start(void* ctx) {
  RtmCtx* c = (RtmCtx*)ctx;
  for (auto& w : c->workers) {
    RtmWorker* wp = w.get();
    wp->th = std::thread([c, wp] { rtm_loop(c, wp); });
  }
  return 0;
}

// Request a stop and join every worker. Each loop finishes its current
// iteration — decided waves already ingested complete their apply +
// event staging before the thread exits (mid-wave shutdown never loses
// staged result frames; the bridge drains the mailbox after this
// returns).
void rtm_stop(void* ctx) {
  RtmCtx* c = (RtmCtx*)ctx;
  c->stop_req.store(1, std::memory_order_relaxed);
  for (auto& w : c->workers)
    if (w->th.joinable()) w->th.join();
}

void rtm_destroy(void* ctx) {
  RtmCtx* c = (RtmCtx*)ctx;
  rtm_stop(c);
  if (c->event_fd >= 0) close(c->event_fd);
  delete c;
}

// Aggregate run state: STOPPED once every worker stopped, PAUSED once
// every worker parked (the pause barrier's completion signal — the
// bridge's pause() polls this), RUNNING otherwise.
int32_t rtm_state(void* ctx) {
  RtmCtx* c = (RtmCtx*)ctx;
  int32_t n_stop = 0, n_parked = 0;
  for (auto& w : c->workers) {
    const int32_t st = w->state.load(std::memory_order_acquire);
    if (st == RTM_STOPPED) {
      n_stop++;
      n_parked++;
    } else if (st == RTM_PAUSED) {
      n_parked++;
    }
  }
  const int32_t W = (int32_t)c->workers.size();
  if (n_stop == W) return RTM_STOPPED;
  if (n_parked == W) return RTM_PAUSED;
  return RTM_RUNNING;
}

void rtm_pause(void* ctx) {
  ((RtmCtx*)ctx)->pause_req.store(1, std::memory_order_release);
}

// release: the control plane mutates the shared consensus arrays
// (next_slot/applied/tainted/...) while every worker is parked in
// PAUSED; each worker's acquire load of pause_req in its park loop is
// the other half of the edge that makes those writes visible before it
// resumes ticking. (Was relaxed/relaxed — a real ordering bug the TSan
// stress cell flags on weakly-ordered machines.)
void rtm_resume(void* ctx) {
  ((RtmCtx*)ctx)->pause_req.store(0, std::memory_order_release);
}

int rtm_event_fd(void* ctx) { return ((RtmCtx*)ctx)->event_fd; }

// Producer half of the command rings, called from the Python control
// plane thread (the only producer). The control plane sees ONE command
// ring: records route to the owning worker's SPSC ring by the shard
// they carry (the bridge splits multi-shard records per group first).
// Returns 0 staged, -1 full.
int32_t rtm_cmd_push(void* ctx, const uint8_t* rec, int64_t len) {
  RtmCtx* c = (RtmCtx*)ctx;
  int32_t g = 0;
  if (c->W > 1 && len >= 1) {
    const uint8_t type = rec[0];
    int64_t s = -1;
    if (type == CMD_OPEN_SCALAR && len >= 5) {
      s = (int64_t)rd_u32(rec + 1);
    } else if (type == CMD_OPEN_WAVE && len >= 30) {
      s = (int64_t)rd_u32(rec + 26);  // first entry's shard
    } else if (type == CMD_ADVANCE && len >= 9) {
      s = (int64_t)rd_u32(rec + 5);  // first entry's shard
    } else if (type == CMD_DECIDE && len >= 5) {
      s = (int64_t)rd_u32(rec + 1);
    } else if (type == CMD_STOP) {
      // fan the stop out so every parked/blocked worker wakes
      c->stop_req.store(1, std::memory_order_relaxed);
      for (auto& w : c->workers)
        (void)w->cmd.push(rec, len, nullptr, 0);
      return 0;
    }
    if (s >= 0 && s < c->n) g = c->group_of(s);
  }
  return c->workers[(size_t)g]->cmd.push(rec, len, nullptr, 0) ? 0 : -1;
}

// Consumer half of the event mailboxes, called from the Python control
// plane thread (the only consumer). Drains every worker's ring into
// `out` ([u32 len][payload]... records back to back) — per-shard event
// order is per-worker order, which each SPSC ring preserves. Returns
// bytes written.
int64_t rtm_ev_drain(void* ctx, uint8_t* out, int64_t cap) {
  RtmCtx* c = (RtmCtx*)ctx;
  int64_t total = 0;
  for (auto& w : c->workers) {
    if (total >= cap) break;
    total += w->ev.drain(out + total, cap - total);
  }
  return total;
}

int32_t rtm_counters_version(void) { return RTM_COUNTERS_VERSION; }
int32_t rtm_counters_count(void) { return RTM_COUNT; }
void* rtm_counters(void* ctx) { return ((RtmCtx*)ctx)->workers[0]->ctrs; }
// per-worker counter blocks (same RTM_* geometry; the bridge sums at
// scrape and labels per-worker series)
void* rtm_counters_w(void* ctx, int32_t g) {
  RtmCtx* c = (RtmCtx*)ctx;
  if (g < 0 || (size_t)g >= c->workers.size()) return nullptr;
  return c->workers[(size_t)g]->ctrs;
}

// stage profiler block: RTS_COUNT u64 cumulative ns, index order RTS_*
int32_t rtm_stages_version(void) { return RTS_VERSION; }
int32_t rtm_stages_count(void) { return RTS_COUNT; }
void* rtm_stages(void* ctx) { return ((RtmCtx*)ctx)->workers[0]->stg; }
void* rtm_stages_w(void* ctx, int32_t g) {
  RtmCtx* c = (RtmCtx*)ctx;
  if (g < 0 || (size_t)g >= c->workers.size()) return nullptr;
  return c->workers[(size_t)g]->stg;
}

// SLO histogram block: RTH_STAGE_COUNT rows of RTH_BUCKETS bucket
// counts + total count + sum_ns (stride RTH_BUCKETS + 2), index order
// RTH_*. Bucket-geometry params are exported so the Python twin
// (obs.registry.SLO_BUCKETS) can be verified against the ABI.
int32_t rtm_hist_version(void) { return RTH_VERSION; }
int32_t rtm_hist_stages(void) { return RTH_STAGE_COUNT; }
int32_t rtm_hist_buckets(void) { return RTH_BUCKETS; }
int32_t rtm_hist_sub_bits(void) { return RTH_SUB_BITS; }
int32_t rtm_hist_min_exp(void) { return RTH_MIN_EXP; }
void* rtm_hist(void* ctx) { return ((RtmCtx*)ctx)->workers[0]->hist; }
void* rtm_hist_w(void* ctx, int32_t g) {
  RtmCtx* c = (RtmCtx*)ctx;
  if (g < 0 || (size_t)g >= c->workers.size()) return nullptr;
  return c->workers[(size_t)g]->hist;
}

int32_t rtm_flight_version(void) { return RTM_FLIGHT_VERSION; }
int32_t rtm_flight_cap(void) { return (int32_t)RTM_FLIGHT_CAP; }
int32_t rtm_flight_record_size(void) { return (int32_t)sizeof(FrEvent); }
void* rtm_flight(void* ctx) {
  return ((RtmCtx*)ctx)->workers[0]->fr.data();
}
uint64_t rtm_flight_head(void* ctx) {
  return ((RtmCtx*)ctx)->workers[0]->fr_head.load(std::memory_order_relaxed);
}
void* rtm_flight_w(void* ctx, int32_t g) {
  RtmCtx* c = (RtmCtx*)ctx;
  if (g < 0 || (size_t)g >= c->workers.size()) return nullptr;
  return c->workers[(size_t)g]->fr.data();
}
uint64_t rtm_flight_head_w(void* ctx, int32_t g) {
  RtmCtx* c = (RtmCtx*)ctx;
  if (g < 0 || (size_t)g >= c->workers.size()) return 0;
  return c->workers[(size_t)g]->fr_head.load(std::memory_order_relaxed);
}

}  // extern "C"
