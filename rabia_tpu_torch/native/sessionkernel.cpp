// Native gateway plane: the C twin of the client session/dedup table in
// rabia_tpu_torch/gateway/session.py, which stays the semantics owner
// (RABIA_PY_GATEWAY=1 forces it; testing/conformance.py's
// run_gateway_ops_on_both_tables pins byte-identical decisions, cached
// payloads and GC behavior between the two).
//
// Why: the r09 stage-profiler finding (docs/PERFORMANCE.md) attributed
// 55.5% of a loaded replica's wall to the Python control plane — the
// gateway/session/serialization work the profiler lumped as `other` —
// while the native consensus stages totalled ~8%. The session table is
// the gateway's per-request state: every Submit pays a dedup lookup, a
// window check and an ack advance, and the per-second GC sweep walks
// EVERY session on the asyncio loop (a 10^5-session table is a 10^5
// iteration Python loop per second). This kernel holds the whole table
// in C — statekernel-style open addressing keyed by the 16-byte client
// id — and runs the submit hot path (dedup + window + ack + reserve) as
// ONE C call, the GC sweep as one C call, and serves cached dedup
// replies from C-resident payload blobs.
//
// Semantics mirrored element-for-element from session.py:
//   - hello: open-or-resume; granted window = min(default, requested)
//     when requested > 0 (renegotiable on resume, never above default);
//   - submit_check: ensure+touch, ack_upto advance, then classify:
//     DUP_CACHED (raw cached status + payload) / DUP_INFLIGHT /
//     SHED_WINDOW / FRESH (seq reserved in the inflight window);
//   - complete: drop the reservation, cache (status, payload,
//     frontier_mark), bump highest_completed; a no-op returning 0 when
//     the session lease-expired mid-flight;
//   - gc: evict results with seq <= ack_upto AND frontier_mark <
//     state_version; per-session cache cap evicts lowest seqs first;
//     idle sessions (no inflight) expire after session_ttl; the HARD
//     LEASE drops a session regardless of inflight after lease_ttl —
//     frontier-independent, so a stalled frontier cannot pin dead
//     sessions. Evicted counts include a dead session's cached results.
//
// Payload blob ABI (cached result payloads, borrowed pointers valid
// until the next mutating call):
//   [u32 LE nparts][u32 LE len_0]...[u32 LE len_{n-1}][part bytes...]
//
// Layout contract: one GwPlane per gateway, one versioned append-only
// GWC_* counter block (read zero-copy via ctypes like RKC_*/SKC_*).
//
// Threading: every entry point takes the plane mutex internally, so the
// table is safe under concurrent callers (the thread-per-shard-group
// runtime multiplies the gateway's callers — ROADMAP item 1; the
// gws_gc-vs-gws_submit seam is stress-checked under TSan in
// native/stress/stress_session.cpp). Counter cells are relaxed atomics
// read zero-copy by scrape threads (the RKC torn-read contract).
// BORROWED pointers (gws_submit / gws_get_result blob_out) remain valid
// only until the next mutating call ON ANY THREAD — a caller that reads
// them must serialize against mutators itself (the gateway's asyncio
// loop does; the stress harness pins its sessions hot so GC cannot free
// what a submit thread is reading).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "annotations.h"

extern "C" {

// ---------------------------------------------------------------------------
// counter block (versioned, append-only — docs/OBSERVABILITY.md)
// ---------------------------------------------------------------------------

enum {
  GWC_HELLOS = 0,        // hello (open/resume) calls
  GWC_SUBMITS,           // submit_check calls
  GWC_DEDUP_CACHED,      // duplicate submits answered from cache
  GWC_DEDUP_INFLIGHT,    // duplicate submits attached to the original
  GWC_SHED_WINDOW,       // submits shed: inflight window full
  GWC_FRESH,             // fresh seqs reserved
  GWC_COMPLETES,         // results cached (complete calls that stored)
  GWC_ABORTS,            // reservations released without a result
  GWC_GC_RUNS,           // gc sweeps
  GWC_SESSIONS_OPENED,   // sessions created
  GWC_SESSIONS_EXPIRED,  // sessions dropped by gc (idle + lease)
  GWC_LEASES_EXPIRED,    // subset of expired: hard-lease drops
  GWC_RESULTS_CACHED,    // cached results stored (== GWC_COMPLETES)
  GWC_RESULTS_EVICTED,   // cached results evicted by gc
  GWC_RESULT_BYTES,      // cumulative payload bytes cached
  GWC_REHASHES,          // session-table growth events
  GWC_COUNT
};

static const int32_t GWS_COUNTERS_VERSION = 1;

// submit_check decisions — must match gateway/session.py SUBMIT_*
enum : int32_t {
  SUBMIT_FRESH = 0,
  SUBMIT_DUP_CACHED = 1,
  SUBMIT_DUP_INFLIGHT = 2,
  SUBMIT_SHED_WINDOW = 3,
};

// ---------------------------------------------------------------------------
// table
// ---------------------------------------------------------------------------

struct CachedRec {
  uint64_t seq;
  uint64_t frontier_mark;
  int32_t status;
  std::vector<uint8_t> blob;  // payload blob (ABI above)
};

struct Session {
  uint8_t cid[16];
  int64_t window;
  uint64_t ack_upto = 0;
  uint64_t highest_completed = 0;
  double last_active = 0.0;
  std::vector<uint64_t> inflight;   // window-bounded; linear scan is fine
  std::vector<CachedRec> results;   // sorted by seq
};

enum : uint8_t { SLOT_EMPTY = 0, SLOT_FULL = 1, SLOT_TOMB = 2 };

struct Slot {
  Session* s = nullptr;
  uint64_t hash = 0;
  uint8_t state = SLOT_EMPTY;
};

static inline uint64_t cid_hash(const uint8_t* p) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < 16; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1;
}

struct GwPlane {
  rabia::Mutex mu{"sessionkernel.mu"};
  std::vector<Slot> table RABIA_GUARDED_BY(mu);  // power-of-two capacity
  int64_t live RABIA_GUARDED_BY(mu) = 0;   // SLOT_FULL count
  int64_t used RABIA_GUARDED_BY(mu) = 0;   // FULL + TOMB (probe bound)
  int64_t default_window;
  double session_ttl;
  double lease_ttl;
  int64_t result_cache_cap;
  // relaxed atomics, read zero-copy as plain u64s by the scrape path
  std::atomic<uint64_t> counters[GWC_COUNT];
  static_assert(sizeof(std::atomic<uint64_t>) == sizeof(uint64_t),
                "counter block must read as a plain uint64 array");
  void bump(int i, uint64_t n = 1) {
    counters[i].fetch_add(n, std::memory_order_relaxed);
  }
};

static void plane_rehash(GwPlane* p, int64_t want_cap)
    RABIA_REQUIRES(p->mu) {
  int64_t cap = 256;
  while (cap < want_cap) cap <<= 1;
  std::vector<Slot> old;
  old.swap(p->table);
  p->table.assign((size_t)cap, Slot{});
  p->used = 0;
  const uint64_t mask = (uint64_t)cap - 1;
  for (auto& e : old) {
    if (e.state != SLOT_FULL) continue;
    uint64_t i = e.hash & mask;
    while (p->table[i].state == SLOT_FULL) i = (i + 1) & mask;
    p->table[i] = e;
    p->used++;
  }
  p->bump(GWC_REHASHES);
}

// find the slot for cid; returns index or -1. `free_out` (when non-null)
// receives the first insertable slot (tombstone or empty).
static int64_t plane_find(GwPlane* p, uint64_t h, const uint8_t* cid,
                          int64_t* free_out) RABIA_REQUIRES(p->mu) {
  const uint64_t mask = (uint64_t)p->table.size() - 1;
  uint64_t i = h & mask;
  int64_t free_slot = -1;
  for (;;) {
    Slot& e = p->table[i];
    if (e.state == SLOT_EMPTY) {
      if (free_out) *free_out = free_slot >= 0 ? free_slot : (int64_t)i;
      return -1;
    }
    if (e.state == SLOT_TOMB) {
      if (free_slot < 0) free_slot = (int64_t)i;
    } else if (e.hash == h && memcmp(e.s->cid, cid, 16) == 0) {
      if (free_out) *free_out = -1;
      return (int64_t)i;
    }
    i = (i + 1) & mask;
  }
}

static Session* plane_get(GwPlane* p, const uint8_t* cid)
    RABIA_REQUIRES(p->mu) {
  int64_t at = plane_find(p, cid_hash(cid), cid, nullptr);
  return at < 0 ? nullptr : p->table[(size_t)at].s;
}

// open-or-resume (session.py SessionTable.ensure)
static Session* plane_ensure(GwPlane* p, const uint8_t* cid,
                             int64_t requested_window, double now)
    RABIA_REQUIRES(p->mu) {
  uint64_t h = cid_hash(cid);
  int64_t free_slot = -1;
  int64_t at = plane_find(p, h, cid, &free_slot);
  Session* s;
  if (at >= 0) {
    s = p->table[(size_t)at].s;
  } else {
    s = new (std::nothrow) Session();
    if (!s) return nullptr;
    memcpy(s->cid, cid, 16);
    s->window = p->default_window;
    Slot& e = p->table[(size_t)free_slot];
    if (e.state != SLOT_TOMB) p->used++;
    e.state = SLOT_FULL;
    e.s = s;
    e.hash = h;
    p->live++;
    p->bump(GWC_SESSIONS_OPENED);
    if (p->used * 4 >= (int64_t)p->table.size() * 3) {
      // size from LIVE sessions, not the current capacity: the rehash
      // drops every tombstone, and under steady session churn (clients
      // come and go, GC tombstoning as it sweeps) it is usually tombs
      // that tripped the 75% trigger — doubling unconditionally would
      // grow the table with the total sessions EVER seen and never
      // shrink it back to the live set.
      plane_rehash(p, p->live * 4);
    }
  }
  if (requested_window > 0) {
    s->window = std::min(p->default_window, requested_window);
  }
  s->last_active = now;
  return s;
}

static CachedRec* session_result(Session* s, uint64_t seq) {
  auto it = std::lower_bound(
      s->results.begin(), s->results.end(), seq,
      [](const CachedRec& r, uint64_t q) { return r.seq < q; });
  if (it == s->results.end() || it->seq != seq) return nullptr;
  return &*it;
}

static bool session_inflight_has(Session* s, uint64_t seq) {
  for (uint64_t q : s->inflight)
    if (q == seq) return true;
  return false;
}

static void session_inflight_drop(Session* s, uint64_t seq) {
  for (size_t i = 0; i < s->inflight.size(); i++) {
    if (s->inflight[i] == seq) {
      s->inflight.erase(s->inflight.begin() + (ptrdiff_t)i);
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// lifecycle
// ---------------------------------------------------------------------------

void* gws_create(int64_t default_window, double session_ttl,
                 int64_t result_cache_cap, double lease_ttl) {
  GwPlane* p = new (std::nothrow) GwPlane();
  if (!p) return nullptr;
  {
    rabia::MutexLock lk(p->mu);  // no other thread yet; analysis only
    p->table.assign(256, Slot{});
  }
  p->default_window = default_window < 1 ? 1 : default_window;
  p->session_ttl = session_ttl;
  p->lease_ttl = lease_ttl;
  p->result_cache_cap = result_cache_cap < 1 ? 1 : result_cache_cap;
  for (auto& c : p->counters) c.store(0, std::memory_order_relaxed);
  return p;
}

static void plane_drop_all(GwPlane* p) RABIA_REQUIRES(p->mu) {
  for (auto& e : p->table)
    if (e.state == SLOT_FULL) delete e.s;
  p->table.assign(256, Slot{});
  p->live = p->used = 0;
}

void gws_destroy(void* h) {
  GwPlane* p = (GwPlane*)h;
  if (!p) return;
  {
    rabia::MutexLock lk(p->mu);  // last reference; analysis only
    for (auto& e : p->table)
      if (e.state == SLOT_FULL) delete e.s;
  }
  delete p;
}

int32_t gws_counters_version() { return GWS_COUNTERS_VERSION; }
int32_t gws_counters_count() { return GWC_COUNT; }
void* gws_counters(void* h) { return ((GwPlane*)h)->counters; }

int64_t gws_len(void* h) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  return p->live;
}

// total session-state loss (tests; the restart-wipe chaos shape)
void gws_clear(void* h) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  plane_drop_all(p);
}

// SessionStats parity: out[0..5] = sessions_opened, duplicate_submits,
// results_cached, results_evicted, sessions_expired, leases_expired
void gws_stats(void* h, uint64_t* out) {
  GwPlane* p = (GwPlane*)h;
  const auto rd = [](const std::atomic<uint64_t>& c) {
    return c.load(std::memory_order_relaxed);
  };
  out[0] = rd(p->counters[GWC_SESSIONS_OPENED]);
  out[1] = rd(p->counters[GWC_DEDUP_CACHED]) +
           rd(p->counters[GWC_DEDUP_INFLIGHT]);
  out[2] = rd(p->counters[GWC_RESULTS_CACHED]);
  out[3] = rd(p->counters[GWC_RESULTS_EVICTED]);
  out[4] = rd(p->counters[GWC_SESSIONS_EXPIRED]);
  out[5] = rd(p->counters[GWC_LEASES_EXPIRED]);
}

// ---------------------------------------------------------------------------
// the hot path
// ---------------------------------------------------------------------------

// hello: open/resume; returns the granted window, fills *last_seq_out.
int64_t gws_hello(void* h, const uint8_t* cid, int64_t req_window,
                  double now, uint64_t* last_seq_out) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  p->bump(GWC_HELLOS);
  Session* s = plane_ensure(p, cid, req_window, now);
  if (!s) return -1;
  if (last_seq_out) *last_seq_out = s->highest_completed;
  return s->window;
}

// submit_check in one call (see module doc). On SUBMIT_DUP_CACHED,
// *status_out / *blob_out / *blob_len_out describe the cached result
// (borrowed until the next mutating call).
int32_t gws_submit(void* h, const uint8_t* cid, uint64_t seq,
                   uint64_t ack_upto, double now, int32_t* status_out,
                   const uint8_t** blob_out, int64_t* blob_len_out) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  p->bump(GWC_SUBMITS);
  Session* s = plane_ensure(p, cid, 0, now);
  if (!s) return -1;
  if (ack_upto > s->ack_upto) s->ack_upto = ack_upto;
  CachedRec* r = session_result(s, seq);
  if (r) {
    p->bump(GWC_DEDUP_CACHED);
    if (status_out) *status_out = r->status;
    if (blob_out) *blob_out = r->blob.data();
    if (blob_len_out) *blob_len_out = (int64_t)r->blob.size();
    return SUBMIT_DUP_CACHED;
  }
  if (session_inflight_has(s, seq)) {
    p->bump(GWC_DEDUP_INFLIGHT);
    return SUBMIT_DUP_INFLIGHT;
  }
  if ((int64_t)s->inflight.size() >= s->window) {
    p->bump(GWC_SHED_WINDOW);
    return SUBMIT_SHED_WINDOW;
  }
  s->inflight.push_back(seq);
  p->bump(GWC_FRESH);
  return SUBMIT_FRESH;
}

// complete: returns 1 when stored, 0 when the session is gone
// (lease-expired mid-flight — the Python twin's complete_op contract).
int32_t gws_complete(void* h, const uint8_t* cid, uint64_t seq,
                     int32_t status, uint64_t frontier_mark,
                     const uint8_t* blob, int64_t blob_len, double now) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return 0;
  session_inflight_drop(s, seq);
  auto it = std::lower_bound(
      s->results.begin(), s->results.end(), seq,
      [](const CachedRec& r, uint64_t q) { return r.seq < q; });
  if (it != s->results.end() && it->seq == seq) {
    it->status = status;
    it->frontier_mark = frontier_mark;
    it->blob.assign(blob, blob + blob_len);
  } else {
    CachedRec rec;
    rec.seq = seq;
    rec.status = status;
    rec.frontier_mark = frontier_mark;
    rec.blob.assign(blob, blob + blob_len);
    s->results.insert(it, std::move(rec));
  }
  if (seq > s->highest_completed) s->highest_completed = seq;
  s->last_active = now;
  p->bump(GWC_COMPLETES);
  p->bump(GWC_RESULTS_CACHED);
  p->bump(GWC_RESULT_BYTES, (uint64_t)blob_len);
  return 1;
}

void gws_abort(void* h, const uint8_t* cid, uint64_t seq) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return;
  session_inflight_drop(s, seq);
  p->bump(GWC_ABORTS);
}

// ---------------------------------------------------------------------------
// GC (one C call per sweep — the 10^5-session walk the Python loop paid)
// ---------------------------------------------------------------------------

int64_t gws_gc(void* h, uint64_t state_version, double now) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  p->bump(GWC_GC_RUNS);
  int64_t evicted = 0;
  for (auto& e : p->table) {
    if (e.state != SLOT_FULL) continue;
    Session* s = e.s;
    if (!s->results.empty()) {
      // frontier-tied eviction: acked AND frontier moved past the mark
      size_t w = 0;
      for (size_t i = 0; i < s->results.size(); i++) {
        CachedRec& r = s->results[i];
        if (r.seq <= s->ack_upto && r.frontier_mark < state_version) {
          evicted++;
          continue;
        }
        if (w != i) s->results[w] = std::move(s->results[i]);
        w++;
      }
      s->results.resize(w);
      // hard cap: evict lowest seqs first (results are seq-sorted)
      if ((int64_t)s->results.size() > p->result_cache_cap) {
        int64_t over = (int64_t)s->results.size() - p->result_cache_cap;
        s->results.erase(s->results.begin(), s->results.begin() + over);
        evicted += over;
      }
    }
    double idle = now - s->last_active;
    if (idle > p->lease_ttl) {
      // hard lease: drop regardless of inflight (frontier-independent)
      evicted += (int64_t)s->results.size();
      delete s;
      e.s = nullptr;
      e.state = SLOT_TOMB;
      p->live--;
      p->bump(GWC_LEASES_EXPIRED);
      p->bump(GWC_SESSIONS_EXPIRED);
    } else if (s->inflight.empty() && idle > p->session_ttl) {
      evicted += (int64_t)s->results.size();
      delete s;
      e.s = nullptr;
      e.state = SLOT_TOMB;
      p->live--;
      p->bump(GWC_SESSIONS_EXPIRED);
    }
  }
  p->bump(GWC_RESULTS_EVICTED, (uint64_t)evicted);
  return evicted;
}

// ---------------------------------------------------------------------------
// introspection (facades, tests, the conformance gate)
// ---------------------------------------------------------------------------

// returns 1 when the session exists and fills the out params
int32_t gws_session_info(void* h, const uint8_t* cid, int64_t* window,
                         uint64_t* ack_upto, uint64_t* highest,
                         int64_t* n_inflight, int64_t* n_results) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return 0;
  if (window) *window = s->window;
  if (ack_upto) *ack_upto = s->ack_upto;
  if (highest) *highest = s->highest_completed;
  if (n_inflight) *n_inflight = (int64_t)s->inflight.size();
  if (n_results) *n_results = (int64_t)s->results.size();
  return 1;
}

// cached-result peek WITHOUT the dedup side effects of gws_submit
// (no counters, no touch). 1 = found.
int32_t gws_get_result(void* h, const uint8_t* cid, uint64_t seq,
                       int32_t* status_out, uint64_t* frontier_out,
                       const uint8_t** blob_out, int64_t* blob_len_out) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return 0;
  CachedRec* r = session_result(s, seq);
  if (!r) return 0;
  if (status_out) *status_out = r->status;
  if (frontier_out) *frontier_out = r->frontier_mark;
  if (blob_out) *blob_out = r->blob.data();
  if (blob_len_out) *blob_len_out = (int64_t)r->blob.size();
  return 1;
}

// write up to cap 16-byte client ids; returns the count (table order —
// callers sort; the conformance gate compares as sets)
int64_t gws_session_ids(void* h, uint8_t* out, int64_t cap) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  int64_t n = 0;
  for (auto& e : p->table) {
    if (e.state != SLOT_FULL) continue;
    if (n >= cap) break;
    memcpy(out + 16 * n, e.s->cid, 16);
    n++;
  }
  return n;
}

// write up to cap cached seqs (ascending); returns count, or -1 when the
// session does not exist
int64_t gws_result_seqs(void* h, const uint8_t* cid, uint64_t* out,
                        int64_t cap) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return -1;
  int64_t n = 0;
  for (auto& r : s->results) {
    if (n >= cap) break;
    out[n++] = r.seq;
  }
  return n;
}

int64_t gws_inflight_seqs(void* h, const uint8_t* cid, uint64_t* out,
                          int64_t cap) {
  GwPlane* p = (GwPlane*)h;
  rabia::MutexLock lk(p->mu);
  Session* s = plane_get(p, cid);
  if (!s) return -1;
  int64_t n = 0;
  for (uint64_t q : s->inflight) {
    if (n >= cap) break;
    out[n++] = q;
  }
  return n;
}

}  // extern "C"
