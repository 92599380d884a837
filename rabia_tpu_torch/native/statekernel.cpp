// Native apply plane: the C twin of the binary-op KV apply path in
// rabia_tpu_torch/apps/kvstore.py (apply_op_bin / apply_ops_bin), which stays
// the semantics owner (RABIA_PY_APPLY=1 forces it; the conformance gate
// in rabia_tpu_torch/testing/conformance.py pins byte-identical results and
// state hashes between the two).
//
// Why: once the per-tick consensus path moved into C, the sweep wall
// moved to per-op CPython apply (docs/PERFORMANCE.md, transport tier).
// This kernel consumes a DECIDED WAVE of binary ops — the same records
// the wire already carries (gateway Submit -> ledger -> decide) — in one
// call per wave: route each op to its shard's open-addressing byte-key/
// byte-value table, mutate in place, and emit result frames packed as
// [u32 LE len][payload] records, the exact staging format
// rt_broadcast_frames (transport.cpp) consumes, so results can be handed
// to the transport out-pool without re-framing.
//
// Semantics mirrored element-for-element from kvstore.py:
//   - op encoding: u8 opcode (1=SET 2=GET 3=DEL 4=EXISTS 5=CLEAR 6=CAS)
//     | u16 LE keylen | key utf8 | (SET: value utf8)
//     | (CAS: u64 LE expected_version | value utf8)
//   - result: u8 kind (0 ok, 1 not_found, 2 error) | u32 LE version
//     | u8 has_value | value utf8
//   - validation: UTF-8 strict (overlongs/surrogates rejected, like
//     Python's strict codec), key length in CODE POINTS vs
//     max_key_length, value length in BYTES vs max_value_size; error
//     texts byte-identical to StoreError/str formats.
//   - stats: per-store total_operations/reads/writes increment exactly
//     where KVStore does (e.g. DEL of an absent key still counts a
//     write; a malformed op counts nothing; StoreFull counts before it
//     errors).
//
// Layout contract: one SkPlane owns all shard stores of a replica, one
// versioned append-only SKC_* counter block (observability, read
// zero-copy via ctypes like RKC_*), and one FrEvent flight ring (ABI of
// hostkernel.cpp / obs/flight.FR_DTYPE) written once per apply wave on
// the C path. Single-threaded: the engine loop is the only caller.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <memory>
#include <mutex>
#include <new>
#include <vector>

#include "annotations.h"

extern "C" {

// ---------------------------------------------------------------------------
// counter block (versioned, append-only — docs/OBSERVABILITY.md)
// ---------------------------------------------------------------------------

enum {
  SKC_WAVES = 0,       // sk_apply_wave calls
  SKC_OPS,             // binary ops consumed
  SKC_SETS,            // successful SETs
  SKC_GETS,            // GET lookups (hit or miss)
  SKC_DELS,            // DEL attempts
  SKC_EXISTS,          // EXISTS probes
  SKC_CLEARS,          // CLEAR ops
  SKC_CAS_HITS,        // CAS applied (create or version match)
  SKC_CAS_MISSES,      // CAS not_found / version_conflict
  SKC_ERRORS,          // error result frames emitted
  SKC_BYTES_IN,        // op bytes consumed
  SKC_BYTES_OUT,       // result bytes emitted (framing included)
  SKC_REHASHES,        // table growth events
  SKC_DELTA_SNAPSHOTS, // sk_snapshot_delta emissions (durability plane)
  SKC_DELTA_ENTRIES,   // dirty entries exported by delta snapshots
  SKC_COUNT
};

static const int32_t SK_COUNTERS_VERSION = 2;

// flight ring: FrEvent ABI shared with hostkernel.cpp / obs/flight.py
static const int32_t SK_FLIGHT_VERSION = 1;
static const int32_t SK_FLIGHT_CAP = 1024;
static const uint8_t FRE_APPLY = 15;  // obs/flight.FRE_APPLY

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

static inline uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// open-addressing store
// ---------------------------------------------------------------------------

enum : uint8_t { SLOT_EMPTY = 0, SLOT_FULL = 1, SLOT_TOMB = 2 };

struct Entry {
  uint8_t* kv;        // key bytes then value bytes (one allocation)
  uint64_t hash;
  uint64_t version;   // entry version (KVStore ValueEntry.version)
  uint64_t epoch;     // store mut_epoch at last mutation (delta tracking)
  double created;
  double updated;
  uint32_t klen;
  uint32_t vlen;
  uint32_t vcap;      // value capacity in kv after the key
  uint8_t state;
};

static inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1;  // 0 is reserved so hash comparison can short-cut
}

struct Store {
  std::vector<Entry> table;  // power-of-two capacity
  int64_t live = 0;          // SLOT_FULL count
  int64_t used = 0;          // FULL + TOMB (probe-length bound)
  uint64_t version = 0;      // store version (KVStore._version)
  // stats (KVStore.StoreStats parity)
  uint64_t total_operations = 0;
  uint64_t reads = 0;
  uint64_t writes = 0;
  // incremental-snapshot tracking (durability plane): entries stamped
  // with mut_epoch at mutation; sk_snapshot_mark bumps it, so "dirty" =
  // epoch == mut_epoch. Deletions since the last mark are logged by key
  // ([u16 LE klen][key] concatenated, bounded); CLEAR sets `cleared`
  // (the delta then clears-and-reinserts, which is complete because
  // every survivor postdates the clear).
  uint64_t mut_epoch = 1;
  std::vector<uint8_t> dels;
  uint32_t n_dels = 0;
  bool cleared = false;
  bool dels_overflow = false;  // log bound hit: next delta must be full

  void reset_table(int64_t cap) {
    table.assign((size_t)cap, Entry{});
    live = used = 0;
  }
};

// deletion-log bound: past this the delta degrades to a full snapshot
// (sk_snapshot_delta returns -3) instead of growing without limit
static const size_t SK_DELS_CAP = 1 << 20;

static inline void log_del(Store& st, const uint8_t* key, uint32_t klen) {
  if (st.cleared || st.dels_overflow) return;  // clear supersedes dels
  if (st.dels.size() + 2 + klen > SK_DELS_CAP) {
    st.dels_overflow = true;
    st.dels.clear();
    st.n_dels = 0;
    return;
  }
  const uint16_t kl = (uint16_t)klen;
  size_t w = st.dels.size();
  st.dels.resize(w + 2 + klen);
  memcpy(st.dels.data() + w, &kl, 2);
  memcpy(st.dels.data() + w + 2, key, klen);
  st.n_dels++;
}

// One result-staging lane: a growable [u32 len][payload] record buffer
// plus its offset index. lane0 is the legacy plane-owned staging (the
// asyncio runtime + Python scalar applies); the thread-per-shard-group
// runtime gives each worker its OWN lane (sk_apply_wave_lane), so N
// workers stage results without sharing a buffer.
struct SkLane {
  std::vector<uint8_t> out_buf;
  std::vector<int64_t> out_offs;
  bool staging = true;  // false while want=0: followers skip result frames
};

struct SkPlane {
  std::vector<Store> stores RABIA_GUARDED_BY(mu);
  int64_t max_keys;
  int64_t max_key_len;    // CODE POINTS (KVStoreConfig.max_key_length)
  int64_t max_value_size; // BYTES (KVStoreConfig.max_value_size)
  // relaxed atomics: multi-writer once apply lanes are configured (N
  // worker threads + the Python plane); layout-identical to uint64 for
  // the zero-copy sk_counters scrape
  std::atomic<uint64_t> counters[SKC_COUNT];
  static_assert(sizeof(std::atomic<uint64_t>) == sizeof(uint64_t),
                "counter block must read as a plain uint64 array");
  FrEvent flight[SK_FLIGHT_CAP];
  // relaxed atomic: written on the apply paths (possibly several lanes
  // at once — each writer claims a slot via fetch_add; a torn record is
  // metrics-grade noise), read lock-free via sk_flight_head
  std::atomic<uint64_t> flight_head{0};
  std::atomic<uint64_t> waves{0};
  // Plane lock (native-runtime hook): the GIL-free runtime thread owns
  // the apply path while the Python control plane still serves reads
  // (gateway read-index GETs, snapshot export). Mutating entry points
  // take it internally; read-side critical sections bracket themselves
  // with sk_plane_lock/sk_plane_unlock so borrowed pointers (sk_get's
  // value view) stay valid across the copy-out. Recursive, so a locked
  // reader can call helpers that lock internally (snapshot restore's
  // insert_raw loop). Uncontended cost is nanoseconds — invisible next
  // to a wave apply.
  rabia::RecursiveMutex mu{"statekernel.mu"};
  // wave result staging (plane-owned, reused and grown across waves so
  // a large wave can never overflow mid-apply): [u32 LE len][payload]
  // records in PROCESS order, with out_offs[i] = record i's start and a
  // final total — read zero-copy by the bridge via sk_out_buf/sk_out_offs
  SkLane lane0;
  // thread-per-shard-group apply lanes (sk_set_groups): lanes[g] is
  // worker g's private staging, lane_mus[g] its shard group's store
  // lock. A lane apply takes ONLY its group mutex; every plane-wide
  // entry point takes `mu` plus ALL group mutexes in index order (lock
  // order: mu -> lane_mus[0] -> lane_mus[1] -> …), so readers/snapshots
  // exclude every concurrently-applying worker while workers never
  // serialize against EACH OTHER. Vectors are stable while workers run
  // (sk_set_groups only executes with the runtime quiesced).
  std::vector<std::unique_ptr<SkLane>> lanes;
  std::vector<std::unique_ptr<rabia::RecursiveMutex>> lane_mus;
};

// Plane-wide critical section: `mu` + every configured group mutex.
// With no groups configured this is exactly the historical RecursiveLock
// on `mu` — the workers=1 path stays byte-identical.
struct PlaneGuard {
  SkPlane* p;
  size_t n_lanes;  // lanes locked at construction — sk_set_groups can
                   // GROW lane_mus inside a guard; the destructor must
                   // unlock exactly what the constructor locked
  explicit PlaneGuard(SkPlane* pp) RABIA_NO_TSA : p(pp) {
    p->mu.lock();
    n_lanes = p->lane_mus.size();
    for (size_t i = 0; i < n_lanes; i++) p->lane_mus[i]->lock();
  }
  ~PlaneGuard() RABIA_NO_TSA {
    for (size_t i = n_lanes; i-- > 0;) p->lane_mus[i]->unlock();
    p->mu.unlock();
  }
  PlaneGuard(const PlaneGuard&) = delete;
  PlaneGuard& operator=(const PlaneGuard&) = delete;
};

static void store_free_entries(Store& st) {
  for (auto& e : st.table)
    if (e.state == SLOT_FULL && e.kv) free(e.kv);
}

static bool store_rehash(Store& st, int64_t want_cap) {
  int64_t cap = 64;
  while (cap < want_cap) cap <<= 1;
  std::vector<Entry> old;
  old.swap(st.table);
  st.table.assign((size_t)cap, Entry{});
  st.used = 0;
  const uint64_t mask = (uint64_t)cap - 1;
  for (auto& e : old) {
    if (e.state != SLOT_FULL) continue;
    uint64_t i = e.hash & mask;
    while (st.table[i].state == SLOT_FULL) i = (i + 1) & mask;
    st.table[i] = e;
    st.used++;
  }
  return true;
}

// find the entry for (key, klen); returns index or -1. `free_out` (when
// non-null) receives the first insertable slot (tombstone or empty).
static int64_t store_find(Store& st, uint64_t h, const uint8_t* key,
                          int64_t klen, int64_t* free_out) {
  const uint64_t mask = (uint64_t)st.table.size() - 1;
  uint64_t i = h & mask;
  int64_t free_slot = -1;
  for (;;) {
    Entry& e = st.table[i];
    if (e.state == SLOT_EMPTY) {
      if (free_out) *free_out = free_slot >= 0 ? free_slot : (int64_t)i;
      return -1;
    }
    if (e.state == SLOT_TOMB) {
      if (free_slot < 0) free_slot = (int64_t)i;
    } else if (e.hash == h && e.klen == (uint32_t)klen &&
               memcmp(e.kv, key, (size_t)klen) == 0) {
      if (free_out) *free_out = -1;
      return (int64_t)i;
    }
    i = (i + 1) & mask;
  }
}

// strict UTF-8 validation; returns the code-point count or -1 on any
// invalid sequence (overlong forms and surrogates rejected — Python's
// strict codec parity)
static int64_t utf8_points(const uint8_t* p, int64_t n) {
  int64_t cp = 0, i = 0;
  while (i < n) {
    uint8_t c = p[i];
    if (c < 0x80) {
      i++;
      cp++;
      continue;
    }
    int len;
    uint32_t min, code;
    if ((c & 0xE0) == 0xC0) {
      len = 2;
      min = 0x80;
      code = c & 0x1F;
    } else if ((c & 0xF0) == 0xE0) {
      len = 3;
      min = 0x800;
      code = c & 0x0F;
    } else if ((c & 0xF8) == 0xF0) {
      len = 4;
      min = 0x10000;
      code = c & 0x07;
    } else {
      return -1;
    }
    if (i + len > n) return -1;
    for (int k = 1; k < len; k++) {
      uint8_t cc = p[i + k];
      if ((cc & 0xC0) != 0x80) return -1;
      code = (code << 6) | (cc & 0x3F);
    }
    if (code < min || code > 0x10FFFF ||
        (code >= 0xD800 && code <= 0xDFFF))
      return -1;
    i += len;
    cp++;
  }
  return cp;
}

// ---------------------------------------------------------------------------
// lifecycle
// ---------------------------------------------------------------------------

void* sk_plane_create(int64_t n_stores, int64_t max_keys,
                      int64_t max_key_len, int64_t max_value_size) {
  if (n_stores <= 0) return nullptr;
  SkPlane* p = new (std::nothrow) SkPlane();
  if (!p) return nullptr;
  {
    PlaneGuard lk(p);  // no other thread yet; analysis only
    p->stores.resize((size_t)n_stores);
    for (auto& st : p->stores) st.reset_table(64);
  }
  p->max_keys = max_keys;
  p->max_key_len = max_key_len;
  p->max_value_size = max_value_size;
  for (auto& c : p->counters) c.store(0, std::memory_order_relaxed);
  memset(p->flight, 0, sizeof(p->flight));
  return p;
}

void sk_plane_destroy(void* h) {
  SkPlane* p = (SkPlane*)h;
  if (!p) return;
  {
    PlaneGuard lk(p);  // last reference; analysis only
    for (auto& st : p->stores) store_free_entries(st);
  }
  delete p;
}

int32_t sk_counters_version() { return SK_COUNTERS_VERSION; }
int32_t sk_counters_count() { return SKC_COUNT; }
void* sk_counters(void* h) { return ((SkPlane*)h)->counters; }

int32_t sk_flight_version() { return SK_FLIGHT_VERSION; }
int32_t sk_flight_cap() { return SK_FLIGHT_CAP; }
int32_t sk_flight_record_size() { return (int32_t)sizeof(FrEvent); }
void* sk_flight(void* h) { return ((SkPlane*)h)->flight; }
uint64_t sk_flight_head(void* h) {
  return ((SkPlane*)h)->flight_head.load(std::memory_order_relaxed);
}

// Read-side critical-section brackets (native-runtime hook): hold the
// plane lock across sk_get + the value copy-out (or an export walk) so
// the GIL-free runtime thread's concurrent wave applies cannot free or
// rehash the borrowed bytes mid-read. Recursive with the internal
// mutator locks above.
// NO_TSA: a deliberately unbalanced C-API bracket over an opaque handle
// (the analysis cannot follow the caller's pairing; the debug lock-order
// checker and the TSan stress cell validate it at runtime instead)
void sk_plane_lock(void* h) RABIA_NO_TSA {
  SkPlane* p = (SkPlane*)h;
  p->mu.lock();
  // group lanes configured: the bracket must exclude every lane apply
  // too (a borrowed sk_get pointer must survive a worker's concurrent
  // wave into the same store) — same order as PlaneGuard
  for (auto& m : p->lane_mus) m->lock();
}
void sk_plane_unlock(void* h) RABIA_NO_TSA {
  SkPlane* p = (SkPlane*)h;
  for (auto it = p->lane_mus.rbegin(); it != p->lane_mus.rend(); ++it)
    (*it)->unlock();
  p->mu.unlock();
}

int64_t sk_store_count(void* h) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  return (int64_t)p->stores.size();
}

int64_t sk_store_size(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  return p->stores[(size_t)idx].live;
}

uint64_t sk_store_version(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return 0;
  return p->stores[(size_t)idx].version;
}

void sk_set_version(void* h, int64_t idx, uint64_t v) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return;
  p->stores[(size_t)idx].version = v;
}

// out[0..2] = total_operations, reads, writes (StoreStats parity)
void sk_store_stats(void* h, int64_t idx, uint64_t* out) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return;
  Store& st = p->stores[(size_t)idx];
  out[0] = st.total_operations;
  out[1] = st.reads;
  out[2] = st.writes;
}

void sk_add_stats(void* h, int64_t idx, uint64_t ops, uint64_t reads,
                  uint64_t writes) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return;
  Store& st = p->stores[(size_t)idx];
  st.total_operations += ops;
  st.reads += reads;
  st.writes += writes;
}

// ---------------------------------------------------------------------------
// direct access (reads / snapshot / restore)
// ---------------------------------------------------------------------------

// borrow the value bytes for `key`; returns vlen and fills *val_addr /
// *version_out, or -1 when absent. The pointer is valid until the next
// mutation of this store (single-threaded engine loop contract).
int64_t sk_get(void* h, int64_t idx, const uint8_t* key, int64_t klen,
               const uint8_t** val_addr, uint64_t* version_out) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  int64_t at = store_find(st, fnv1a(key, klen), key, klen, nullptr);
  if (at < 0) return -1;
  Entry& e = st.table[(size_t)at];
  if (val_addr) *val_addr = e.kv + e.klen;
  if (version_out) *version_out = e.version;
  return (int64_t)e.vlen;
}

// bytes needed by sk_export for this store
int64_t sk_export_size(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  int64_t total = 0;
  for (auto& e : st.table)
    if (e.state == SLOT_FULL) total += 32 + e.klen + e.vlen;
  return total;
}

// export packed entries (arbitrary order; the Python side sorts):
// [u32 klen][u32 vlen][u64 version][f64 created][f64 updated][key][val]
// returns bytes written, or -(bytes needed) when cap is insufficient.
int64_t sk_export(void* h, int64_t idx, uint8_t* out, int64_t cap) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  int64_t need = sk_export_size(h, idx);
  if (need > cap) return -need;
  uint8_t* w = out;
  for (auto& e : st.table) {
    if (e.state != SLOT_FULL) continue;
    memcpy(w, &e.klen, 4);
    memcpy(w + 4, &e.vlen, 4);
    memcpy(w + 8, &e.version, 8);
    memcpy(w + 16, &e.created, 8);
    memcpy(w + 24, &e.updated, 8);
    memcpy(w + 32, e.kv, e.klen);
    memcpy(w + 32 + e.klen, e.kv + e.klen, e.vlen);
    w += 32 + e.klen + e.vlen;
  }
  return w - out;
}

void sk_clear_store(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return;
  Store& st = p->stores[(size_t)idx];
  store_free_entries(st);
  st.reset_table(64);
  st.cleared = true;
  st.dels.clear();
  st.n_dels = 0;
  st.dels_overflow = false;
}

// restore-path delete (no stats, no version bump, no deletion-log entry:
// the chain frame being restored already records this deletion, and the
// restored state simply lacks the key — nothing for the next delta to
// re-record). Returns 1 removed, 0 absent, -1 bad index.
int32_t sk_delete_raw(void* h, int64_t idx, const uint8_t* key,
                      int64_t klen) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  int64_t at = store_find(st, fnv1a(key, klen), key, klen, nullptr);
  if (at < 0) return 0;
  Entry& e = st.table[(size_t)at];
  free(e.kv);
  e.kv = nullptr;
  e.state = SLOT_TOMB;
  st.live--;
  return 1;
}

// restore-path insert (no validation, no stats, no version bump — the
// caller sets the store version explicitly after loading)
int32_t sk_insert_raw(void* h, int64_t idx, const uint8_t* key,
                      int64_t klen, const uint8_t* val, int64_t vlen,
                      uint64_t version, double created, double updated) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  if (st.used * 4 >= (int64_t)st.table.size() * 3)
    store_rehash(st, (int64_t)st.table.size() * 2);
  uint64_t hsh = fnv1a(key, klen);
  int64_t free_slot = -1;
  int64_t at = store_find(st, hsh, key, klen, &free_slot);
  uint8_t* kv = (uint8_t*)malloc((size_t)(klen + vlen) + 1);
  if (!kv) return -2;
  memcpy(kv, key, (size_t)klen);
  memcpy(kv + klen, val, (size_t)vlen);
  if (at >= 0) {
    Entry& e = st.table[(size_t)at];
    free(e.kv);
    e.kv = kv;
    e.vlen = e.vcap = (uint32_t)vlen;
    e.version = version;
    e.epoch = st.mut_epoch;
    e.created = created;
    e.updated = updated;
    return 0;
  }
  Entry& e = st.table[(size_t)free_slot];
  if (e.state != SLOT_TOMB) st.used++;
  e.state = SLOT_FULL;
  e.kv = kv;
  e.hash = hsh;
  e.klen = (uint32_t)klen;
  e.vlen = e.vcap = (uint32_t)vlen;
  e.version = version;
  e.epoch = st.mut_epoch;
  e.created = created;
  e.updated = updated;
  st.live++;
  return 0;
}

// ---------------------------------------------------------------------------
// the apply wave
// ---------------------------------------------------------------------------

// result framing: [u32 LE len][payload] records — the rt_broadcast_frames
// staging format — appended to the plane-owned growable buffer (state
// mutations can therefore never be lost to an output-capacity error).

static inline void res_head(SkLane& L, uint8_t kind, uint64_t version,
                            int32_t has_value, int64_t value_len) {
  if (!L.staging) return;
  int64_t payload = 6 + (has_value ? value_len : 0);
  size_t w = L.out_buf.size();
  L.out_buf.resize(w + 4 + (size_t)payload);
  uint8_t* out = L.out_buf.data() + w;
  uint32_t plen = (uint32_t)payload;
  memcpy(out, &plen, 4);
  out[4] = kind;
  uint32_t v32 = (uint32_t)(version & 0xFFFFFFFFull);
  memcpy(out + 5, &v32, 4);
  out[9] = has_value ? 1 : 0;
}

static inline void res_simple(SkLane& L, uint8_t kind, uint64_t version) {
  res_head(L, kind, version, 0, 0);
}

static inline void res_value(SkLane& L, uint8_t kind, uint64_t version,
                             const uint8_t* val, int64_t vlen) {
  if (!L.staging) return;
  res_head(L, kind, version, 1, vlen);
  memcpy(L.out_buf.data() + L.out_buf.size() - vlen, val, (size_t)vlen);
}

static inline void res_text(SkLane& L, uint8_t kind, uint64_t version,
                            const char* text) {
  res_value(L, kind, version, (const uint8_t*)text,
            (int64_t)strlen(text));
}

// Apply ops data[offs[j]..offs[j+1]] for j in [op_lo, op_hi) against
// store st; results + record offsets appended to lane L's buffers.
// Caller holds a lock covering `st` (the plane guard, or the store's
// group mutex on a worker lane).
static void apply_ops_store(SkPlane* p, SkLane& L, Store& st,
                            const uint8_t* data, const int64_t* offs,
                            int64_t op_lo, int64_t op_hi,
                            double now) RABIA_NO_TSA {
  char tmp[128];
  for (int64_t j = op_lo; j < op_hi; j++) {
    const uint8_t* op = data + offs[j];
    const int64_t n = offs[j + 1] - offs[j];
    if (L.staging) L.out_offs.push_back((int64_t)L.out_buf.size());
    p->counters[SKC_OPS]++;
    p->counters[SKC_BYTES_IN] += (uint64_t)n;

    if (n < 1) {
      // Python: data[0] raises IndexError -> "malformed op: index out
      // of range"
      p->counters[SKC_ERRORS]++;
      res_text(L, 2, 0, "malformed op: index out of range");
      continue;
    }
    const uint8_t opcode = op[0];
    // int.from_bytes(data[1:3]) parity on short buffers: missing bytes
    // read as absent (little-endian of the available slice)
    int64_t klen = 0;
    if (n >= 2) klen = op[1];
    if (n >= 3) klen |= ((int64_t)op[2]) << 8;
    if (3 + klen > n) {
      p->counters[SKC_ERRORS]++;
      snprintf(tmp, sizeof(tmp),
               "malformed op: key length %lld exceeds payload",
               (long long)klen);
      res_text(L, 2, 0, tmp);
      continue;
    }
    const uint8_t* key = op + 3;
    const int64_t key_points = utf8_points(key, klen);
    if (key_points < 0) {
      p->counters[SKC_ERRORS]++;
      res_text(L, 2, 0, "malformed op: invalid utf-8");
      continue;
    }

    switch (opcode) {
      case 1: {  // SET
        const uint8_t* val = op + 3 + klen;
        const int64_t vlen = n - 3 - klen;
        if (utf8_points(val, vlen) < 0) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "malformed op: invalid utf-8");
          break;
        }
        // _validate_key / _validate_value run BEFORE stats (KVStore.set)
        if (klen == 0) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "StoreError: key_empty");
          break;
        }
        if (key_points > p->max_key_len) {
          p->counters[SKC_ERRORS]++;
          snprintf(tmp, sizeof(tmp), "StoreError: key_too_long: %lld > %lld",
                   (long long)key_points, (long long)p->max_key_len);
          res_text(L, 2, 0, tmp);
          break;
        }
        if (vlen > p->max_value_size) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "StoreError: value_too_large");
          break;
        }
        st.total_operations++;
        st.writes++;
        uint64_t hsh = fnv1a(key, klen);
        int64_t free_slot = -1;
        int64_t at = store_find(st, hsh, key, klen, &free_slot);
        if (at < 0) {
          if (st.live >= p->max_keys) {
            p->counters[SKC_ERRORS]++;
            res_text(L, 2, 0, "StoreError: store_full");
            break;
          }
          uint8_t* kv = (uint8_t*)malloc((size_t)(klen + vlen) + 1);
          if (!kv) {
            p->counters[SKC_ERRORS]++;
            res_text(L, 2, 0, "internal: oom");
            break;
          }
          memcpy(kv, key, (size_t)klen);
          memcpy(kv + klen, val, (size_t)vlen);
          st.version++;
          Entry& e = st.table[(size_t)free_slot];
          if (e.state != SLOT_TOMB) st.used++;
          e.state = SLOT_FULL;
          e.kv = kv;
          e.hash = hsh;
          e.klen = (uint32_t)klen;
          e.vlen = e.vcap = (uint32_t)vlen;
          e.version = st.version;
          e.epoch = st.mut_epoch;
          e.created = e.updated = now;
          st.live++;
          if (st.used * 4 >= (int64_t)st.table.size() * 3) {
            store_rehash(st, (int64_t)st.table.size() * 2);
            p->counters[SKC_REHASHES]++;
          }
        } else {
          Entry& e = st.table[(size_t)at];
          if ((uint32_t)vlen > e.vcap) {
            uint8_t* kv = (uint8_t*)realloc(e.kv, (size_t)(klen + vlen) + 1);
            if (!kv) {
              p->counters[SKC_ERRORS]++;
              res_text(L, 2, 0, "internal: oom");
              break;
            }
            e.kv = kv;
            e.vcap = (uint32_t)vlen;
          }
          memcpy(e.kv + klen, val, (size_t)vlen);
          e.vlen = (uint32_t)vlen;
          st.version++;
          e.version = st.version;
          e.epoch = st.mut_epoch;
          e.updated = now;
        }
        p->counters[SKC_SETS]++;
        res_simple(L, 0, st.version);
        break;
      }
      case 2: {  // GET
        st.total_operations++;
        st.reads++;
        p->counters[SKC_GETS]++;
        int64_t at = store_find(st, fnv1a(key, klen), key, klen, nullptr);
        if (at < 0) {
          res_simple(L, 1, 0);
        } else {
          Entry& e = st.table[(size_t)at];
          res_value(L, 0, e.version, e.kv + e.klen, e.vlen);
        }
        break;
      }
      case 3: {  // DEL
        st.total_operations++;
        st.writes++;
        p->counters[SKC_DELS]++;
        uint64_t hsh = fnv1a(key, klen);
        int64_t at = store_find(st, hsh, key, klen, nullptr);
        if (at < 0) {
          res_simple(L, 1, 0);
        } else {
          Entry& e = st.table[(size_t)at];
          st.version++;
          // result carries the OLD value and the NEW store version
          res_value(L, 0, st.version, e.kv + e.klen, e.vlen);
          log_del(st, key, (uint32_t)klen);
          free(e.kv);
          e.kv = nullptr;
          e.state = SLOT_TOMB;
          st.live--;
        }
        break;
      }
      case 4: {  // EXISTS
        st.total_operations++;
        st.reads++;
        p->counters[SKC_EXISTS]++;
        int64_t at = store_find(st, fnv1a(key, klen), key, klen, nullptr);
        res_text(L, 0, 0, at >= 0 ? "true" : "false");
        break;
      }
      case 5: {  // CLEAR
        st.total_operations++;
        st.writes++;
        p->counters[SKC_CLEARS]++;
        int64_t count = st.live;
        store_free_entries(st);
        st.reset_table(64);
        st.cleared = true;
        st.dels.clear();
        st.n_dels = 0;
        st.dels_overflow = false;
        st.version++;
        snprintf(tmp, sizeof(tmp), "%lld", (long long)count);
        res_text(L, 0, 0, tmp);
        break;
      }
      case 6: {  // CAS
        if (3 + klen + 8 > n) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0,
                   "malformed op: cas payload shorter than its "
                   "version field");
          break;
        }
        uint64_t expected;
        memcpy(&expected, op + 3 + klen, 8);
        const uint8_t* val = op + 3 + klen + 8;
        const int64_t vlen = n - 3 - klen - 8;
        if (utf8_points(val, vlen) < 0) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "malformed op: invalid utf-8");
          break;
        }
        if (klen == 0) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "StoreError: key_empty");
          break;
        }
        if (key_points > p->max_key_len) {
          p->counters[SKC_ERRORS]++;
          snprintf(tmp, sizeof(tmp), "StoreError: key_too_long: %lld > %lld",
                   (long long)key_points, (long long)p->max_key_len);
          res_text(L, 2, 0, tmp);
          break;
        }
        if (vlen > p->max_value_size) {
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, 0, "StoreError: value_too_large");
          break;
        }
        st.total_operations++;
        st.writes++;
        uint64_t hsh = fnv1a(key, klen);
        int64_t free_slot = -1;
        int64_t at = store_find(st, hsh, key, klen, &free_slot);
        if (at < 0) {
          if (expected != 0) {
            p->counters[SKC_CAS_MISSES]++;
            res_simple(L, 1, 0);  // not_found
            break;
          }
          if (st.live >= p->max_keys) {
            p->counters[SKC_ERRORS]++;
            res_text(L, 2, 0, "StoreError: store_full");
            break;
          }
          uint8_t* kv = (uint8_t*)malloc((size_t)(klen + vlen) + 1);
          if (!kv) {
            p->counters[SKC_ERRORS]++;
            res_text(L, 2, 0, "internal: oom");
            break;
          }
          memcpy(kv, key, (size_t)klen);
          memcpy(kv + klen, val, (size_t)vlen);
          st.version++;
          Entry& e = st.table[(size_t)free_slot];
          if (e.state != SLOT_TOMB) st.used++;
          e.state = SLOT_FULL;
          e.kv = kv;
          e.hash = hsh;
          e.klen = (uint32_t)klen;
          e.vlen = e.vcap = (uint32_t)vlen;
          e.version = st.version;
          e.epoch = st.mut_epoch;
          e.created = e.updated = now;
          st.live++;
          if (st.used * 4 >= (int64_t)st.table.size() * 3) {
            store_rehash(st, (int64_t)st.table.size() * 2);
            p->counters[SKC_REHASHES]++;
          }
          p->counters[SKC_CAS_HITS]++;
          res_simple(L, 0, st.version);
          break;
        }
        Entry& e = st.table[(size_t)at];
        if (e.version != expected) {
          p->counters[SKC_CAS_MISSES]++;
          p->counters[SKC_ERRORS]++;
          res_text(L, 2, e.version, "version_conflict");
          break;
        }
        if ((uint32_t)vlen > e.vcap) {
          uint8_t* kv = (uint8_t*)realloc(e.kv, (size_t)(klen + vlen) + 1);
          if (!kv) {
            p->counters[SKC_ERRORS]++;
            res_text(L, 2, 0, "internal: oom");
            break;
          }
          e.kv = kv;
          e.vcap = (uint32_t)vlen;
        }
        memcpy(e.kv + klen, val, (size_t)vlen);
        e.vlen = (uint32_t)vlen;
        st.version++;
        e.version = st.version;
        e.epoch = st.mut_epoch;
        e.updated = now;
        p->counters[SKC_CAS_HITS]++;
        res_simple(L, 0, st.version);
        break;
      }
      default: {
        p->counters[SKC_ERRORS]++;
        snprintf(tmp, sizeof(tmp), "unknown opcode %d", (int)opcode);
        res_text(L, 2, 0, tmp);
        break;
      }
    }
  }
}

static void flight_wave(SkPlane* p, int64_t first_shard, int64_t total_ops) {
  // one FRE_APPLY record per wave on the C path (the engine's per-slot
  // Python records stay the lifecycle source on both tick paths)
  // fetch_add slot claim: several apply lanes may record concurrently;
  // each writer owns its claimed slot (a reader racing a write sees one
  // torn record — metrics-grade, documented in OBSERVABILITY.md)
  const uint64_t head = p->flight_head.fetch_add(1, std::memory_order_relaxed);
  FrEvent& ev = p->flight[head % SK_FLIGHT_CAP];
  ev.t_ns = mono_ns();
  ev.slot = p->waves.fetch_add(1, std::memory_order_relaxed);
  ev.batch = (uint64_t)total_ops;
  ev.shard = (uint32_t)(first_shard < 0 ? 0 : first_shard);
  ev.peer = 0xFFFF;
  ev.kind = FRE_APPLY;
  ev.arg = (uint8_t)(total_ops > 255 ? 255 : total_ops);
}

// wave result staging accessors (valid until the next apply call)
void* sk_out_buf(void* h) { return ((SkPlane*)h)->lane0.out_buf.data(); }
void* sk_out_offs(void* h) { return ((SkPlane*)h)->lane0.out_offs.data(); }
int64_t sk_out_count(void* h) {
  return (int64_t)((SkPlane*)h)->lane0.out_offs.size();
}

// Per-worker-lane staging accessors (sk_apply_wave_lane results).
void* sk_out_buf_lane(void* h, int32_t lane) {
  SkPlane* p = (SkPlane*)h;
  if (lane < 0 || (size_t)lane >= p->lanes.size()) return nullptr;
  return p->lanes[(size_t)lane]->out_buf.data();
}
void* sk_out_offs_lane(void* h, int32_t lane) {
  SkPlane* p = (SkPlane*)h;
  if (lane < 0 || (size_t)lane >= p->lanes.size()) return nullptr;
  return p->lanes[(size_t)lane]->out_offs.data();
}

// Configure per-shard-group apply lanes: ngroups worker lanes, each with
// its own staging buffers and group mutex (the runtime's shard→group
// partition is contiguous; group membership only matters to the CALLER —
// the plane just guarantees lane g's applies exclude plane-wide entry
// points and nothing else). ngroups=0 clears. MUST be called while no
// worker is inside a lane apply (the runtime bridge configures before
// rtm_start). Returns 0, or -1 on a bad count.
int32_t sk_set_groups(void* h, int32_t ngroups) {
  SkPlane* p = (SkPlane*)h;
  if (!p || ngroups < 0 || ngroups > 64) return -1;
  PlaneGuard lk(p);
  if (ngroups == 0) {
    // lanes retained (stable addresses for stragglers); mutexes too
    return 0;
  }
  static const struct LaneNames {
    char n[64][24];
    LaneNames() {
      for (int i = 0; i < 64; i++)
        snprintf(n[i], sizeof(n[i]), "statekernel.lane%02d", i);
    }
  } kLaneNames;
  while ((int32_t)p->lanes.size() < ngroups) {
    const size_t i = p->lanes.size();
    p->lanes.push_back(std::make_unique<SkLane>());
    p->lane_mus.push_back(
        std::make_unique<rabia::RecursiveMutex>(kLaneNames.n[i & 63]));
  }
  return 0;
}

// The lane-parameterized wave apply core. Caller holds a lock covering
// every store the wave touches (PlaneGuard, or one group mutex when the
// wave is group-pure).
static int64_t apply_wave_into(SkPlane* p, SkLane& L, const uint8_t* data,
                               const int64_t* cmd_offsets,
                               const int64_t* shards, const int64_t* starts,
                               const int64_t* idxs, int64_t n_idx,
                               double now, int32_t want) RABIA_NO_TSA {
  L.staging = want != 0;
  L.out_buf.clear();
  L.out_offs.clear();
  int64_t first_shard = -1;
  int64_t total_ops = 0;
  const int64_t n_stores = (int64_t)p->stores.size();
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t idx = idxs[i];
    int64_t s = shards[idx] % n_stores;
    if (s < 0) s += n_stores;
    if (first_shard < 0) first_shard = s;
    Store& st = p->stores[(size_t)s];
    const int64_t lo = starts[idx], hi = starts[idx + 1];
    total_ops += hi - lo;
    apply_ops_store(p, L, st, data, cmd_offsets, lo, hi, now);
  }
  if (L.staging) L.out_offs.push_back((int64_t)L.out_buf.size());
  p->counters[SKC_WAVES]++;
  p->counters[SKC_BYTES_OUT] += (uint64_t)L.out_buf.size();
  flight_wave(p, first_shard, total_ops);
  return (int64_t)L.out_buf.size();
}

// Apply one decided wave: for each selected covered-index `idxs[i]` the
// ops are commands [starts[idx], starts[idx+1]) of the block, each op
// being data[cmd_offsets[j] .. cmd_offsets[j+1]], routed to store
// shards[idx]. Results are staged into the plane's growable out buffer
// as [u32 LE len][payload] records in process order (sk_out_buf /
// sk_out_offs; the final out_offs entry is the total byte count), the
// exact record format rt_broadcast_frames consumes. Returns bytes
// staged, or -2 on a bad handle.
int64_t sk_apply_wave(void* h, const uint8_t* data,
                      const int64_t* cmd_offsets, const int64_t* shards,
                      const int64_t* starts, const int64_t* idxs,
                      int64_t n_idx, double now, int32_t want) {
  SkPlane* p = (SkPlane*)h;
  if (!p || n_idx < 0) return -2;
  PlaneGuard lk(p);
  return apply_wave_into(p, p->lane0, data, cmd_offsets, shards, starts,
                         idxs, n_idx, now, want);
}

// Thread-per-shard-group wave apply: worker `lane`'s GROUP-PURE wave
// (every shard in the wave belongs to the lane's group) applies under
// ONLY that group's mutex, staging results into the lane's private
// buffers (sk_out_buf_lane / sk_out_offs_lane — no further lock needed
// to read them: the lane has a single owner thread). N workers applying
// to different groups no longer serialize on the plane mutex; plane-wide
// readers (sk_get, exports, snapshots) exclude every lane by taking all
// group mutexes through the PlaneGuard.
int64_t sk_apply_wave_lane(void* h, int32_t lane, const uint8_t* data,
                           const int64_t* cmd_offsets, const int64_t* shards,
                           const int64_t* starts, const int64_t* idxs,
                           int64_t n_idx, double now, int32_t want) {
  SkPlane* p = (SkPlane*)h;
  if (!p || n_idx < 0) return -2;
  if (lane < 0 || (size_t)lane >= p->lanes.size()) return -2;
  rabia::RecursiveLock lg(*p->lane_mus[(size_t)lane]);
  return apply_wave_into(p, *p->lanes[(size_t)lane], data, cmd_offsets,
                         shards, starts, idxs, n_idx, now, want);
}

// ---------------------------------------------------------------------------
// incremental snapshots (durability plane — docs/DURABILITY.md)
// ---------------------------------------------------------------------------
//
// Delta frame for one store (emitted by sk_snapshot_delta, decoded by
// persistence/native_wal.py, which is the semantics owner of the
// surrounding file format):
//   u8 flags (bit0: cleared — restore must clear the store first)
//   u32 LE n_del  | n_del * (u16 LE klen | key)
//   u32 LE n_ent  | n_ent * sk_export entry
//                   ([u32 klen][u32 vlen][u64 version][f64 created]
//                    [f64 updated][key][val])
// where n_ent covers exactly the entries mutated since the last
// sk_snapshot_mark. Restore applies dels BEFORE entries (a deleted-then-
// reset key appears in both; the insert must win).

// bytes a delta frame needs, or -3 when the deletion log overflowed and
// only a FULL snapshot is faithful, or -1 on a bad store index.
int64_t sk_snapshot_delta_size(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  if (st.dels_overflow) return -3;
  int64_t total = 1 + 4 + (int64_t)st.dels.size() + 4;
  for (auto& e : st.table)
    if (e.state == SLOT_FULL && e.epoch == st.mut_epoch)
      total += 32 + e.klen + e.vlen;
  return total;
}

// emit the delta frame; returns bytes written, -(bytes needed) when cap
// is insufficient, -3 on deletion-log overflow (caller does a full
// snapshot instead), -1 on a bad index. Does NOT advance the mark —
// call sk_snapshot_mark once the frame is durably on disk, so a failed
// checkpoint write never loses dirty state.
int64_t sk_snapshot_delta(void* h, int64_t idx, uint8_t* out, int64_t cap) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return -1;
  Store& st = p->stores[(size_t)idx];
  if (st.dels_overflow) return -3;
  const int64_t need = sk_snapshot_delta_size(h, idx);
  if (need > cap) return -need;
  uint8_t* w = out;
  *w++ = st.cleared ? 1 : 0;
  memcpy(w, &st.n_dels, 4);
  w += 4;
  if (!st.dels.empty()) {
    // empty-log guard: memcpy's src is declared nonnull and an empty
    // vector's data() may be null (UBSan stress finding, round 13)
    memcpy(w, st.dels.data(), st.dels.size());
  }
  w += st.dels.size();
  uint32_t n_ent = 0;
  uint8_t* ent_count_at = w;
  w += 4;
  for (auto& e : st.table) {
    if (e.state != SLOT_FULL || e.epoch != st.mut_epoch) continue;
    memcpy(w, &e.klen, 4);
    memcpy(w + 4, &e.vlen, 4);
    memcpy(w + 8, &e.version, 8);
    memcpy(w + 16, &e.created, 8);
    memcpy(w + 24, &e.updated, 8);
    memcpy(w + 32, e.kv, e.klen);
    memcpy(w + 32 + e.klen, e.kv + e.klen, e.vlen);
    w += 32 + e.klen + e.vlen;
    n_ent++;
  }
  memcpy(ent_count_at, &n_ent, 4);
  p->counters[SKC_DELTA_SNAPSHOTS]++;
  p->counters[SKC_DELTA_ENTRIES] += n_ent;
  return w - out;
}

// advance the snapshot mark: everything emitted by the delta just
// written is now "clean"; future mutations stamp the new epoch.
void sk_snapshot_mark(void* h, int64_t idx) {
  SkPlane* p = (SkPlane*)h;
  PlaneGuard lk(p);
  if (idx < 0 || (size_t)idx >= p->stores.size()) return;
  Store& st = p->stores[(size_t)idx];
  st.mut_epoch++;
  st.dels.clear();
  st.n_dels = 0;
  st.cleared = false;
  st.dels_overflow = false;
}

// Scalar-lane convenience: apply `n_ops` ops (offsets over `data`)
// against ONE store. Same staging contract as sk_apply_wave.
int64_t sk_apply_ops(void* h, int64_t store_idx, const uint8_t* data,
                     const int64_t* cmd_offsets, int64_t n_ops, double now,
                     int32_t want) {
  SkPlane* p = (SkPlane*)h;
  if (!p) return -2;
  PlaneGuard lk(p);
  if (store_idx < 0 || (size_t)store_idx >= p->stores.size()) return -2;
  SkLane& L = p->lane0;
  L.staging = want != 0;
  L.out_buf.clear();
  L.out_offs.clear();
  Store& st = p->stores[(size_t)store_idx];
  apply_ops_store(p, L, st, data, cmd_offsets, 0, n_ops, now);
  if (L.staging) L.out_offs.push_back((int64_t)L.out_buf.size());
  p->counters[SKC_WAVES]++;
  p->counters[SKC_BYTES_OUT] += (uint64_t)L.out_buf.size();
  flight_wave(p, store_idx, n_ops);
  return (int64_t)L.out_buf.size();
}

}  // extern "C"
