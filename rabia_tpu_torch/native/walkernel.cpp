// Native durability plane: the C write-ahead log of decided waves.
//
// The engine's apply paths (runtime.cpp's decide->apply stage and the
// asyncio apply plane) stage CRC-framed records into an in-memory buffer
// with one cheap mutex-protected append per record; a DEDICATED flush
// thread drains the buffer to the current segment file and fsyncs — one
// fsync covers every record staged while the previous fsync ran
// (group commit), so neither the GIL-free io/tick thread nor the asyncio
// loop ever blocks on disk. Callers that need a durability barrier
// (vote write-ahead, gateway result frames) compare wal_durable() to the
// LSN their append returned and wait on the eventfd.
//
// The Python twin (rabia_tpu_torch/persistence/native_wal.py `_PyWalWriter`,
// forced by RABIA_PY_WAL=1) is the SEMANTICS OWNER of the byte format:
// given the same record sequence and segment limit, both writers must
// produce byte-identical segment files (testing/conformance.py
// run_waves_on_both_wal_paths pins this; scripts/fuzz_conformance.py
// --wal fuzzes it in CI). Keep every format decision here mirrored
// there, and vice versa.
//
// On-disk format (docs/DURABILITY.md):
//   segment file  wal-XXXXXXXX.seg (XXXXXXXX = zero-padded decimal index)
//   header (24B)  "RTWL" | u32 version=1 | u64 segment_index | u64 base_lsn
//   record frame  [u32 LE payload_len][u32 LE crc32(payload)][payload]
//   payload       u8 kind | kind-specific body (encoded by the callers;
//                 this kernel treats payloads as opaque except for the
//                 leading kind byte it counts, and the BARRIER records it
//                 emits itself from wal_barrier_covered)
//
// LSNs are 1-based record ordinals across the whole log (segments
// included); durability is a watermark: wal_durable() returns the
// highest LSN whose record (and all predecessors) survived an fsync.
// Rotation happens on RECORD boundaries at flush time, decided purely by
// accumulated segment bytes — deterministic for a given record sequence,
// independent of flush timing, which is what makes C/Python byte parity
// possible at all.
//
// Recovery (scan + torn-tail truncation + replay) lives in Python
// (native_wal.py): it is a cold path that runs once per process start,
// and keeping it in one place means both writer backends recover through
// literally the same code.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdio.h>
#include <string.h>
#include <sys/eventfd.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "annotations.h"

extern "C" {

// ---------------------------------------------------------------------------
// counter block (versioned, append-only — docs/OBSERVABILITY.md WLC_*)
// ---------------------------------------------------------------------------

enum {
  WLC_APPENDS = 0,     // records staged (all kinds)
  WLC_APPEND_BYTES,    // framed bytes staged
  WLC_WAVES,           // kind-1 (decided wave) records
  WLC_BARRIERS,        // kind-2 (vote barrier) records
  WLC_FRONTIERS,       // kind-3 (snapshot frontier) records
  WLC_LEDGERS,         // kind-4 (batch-id ledger) records
  WLC_FLUSHES,         // flush-thread drain passes
  WLC_FLUSH_BYTES,     // bytes written to segment files
  WLC_FSYNCS,          // fsync calls on segment files
  WLC_FSYNC_NS,        // cumulative fsync nanoseconds
  WLC_GROUP_RECORDS,   // records covered by fsyncs (group-commit size sum)
  WLC_ROTATIONS,       // segment rotations
  WLC_BARRIER_WAITS,   // wal_barrier_covered calls that had to append
  WLC_IO_ERRORS,       // write/fsync failures (log wedges read-only)
  WLC_COUNT
};

static const int32_t WAL_COUNTERS_VERSION = 1;

// fsync-latency SLO histogram: same log-bucket geometry as runtime.cpp's
// RTH block (2^sub_bits sub-buckets per octave from 2^min_exp ns) so the
// Python exporter reuses one bound table for every native histogram.
static const int32_t WLH_VERSION = 1;
static const int32_t WLH_SUB_BITS = 2;
static const int32_t WLH_MIN_EXP = 10;   // floor 1.024us
static const int32_t WLH_OCTAVES = 25;   // top ~34.4s
static const int32_t WLH_BUCKETS = WLH_OCTAVES << WLH_SUB_BITS;
static const int32_t WLH_STRIDE = WLH_BUCKETS + 2;  // + count + sum_ns

static const uint32_t WAL_MAGIC = 0x4C575452u;  // "RTWL" little-endian
static const uint32_t WAL_VERSION = 1;
static const int64_t WAL_HEADER = 24;

static inline uint64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

struct WalCtx {
  std::string dir;
  int dir_fd = -1;
  int seg_fd = -1;  // flush-thread-owned after wal_start (create before)
  // open-segment identity/fill, published for wal_segment_index/_bytes
  // (advisory cross-thread reads; the flush thread is the only writer
  // after start)
  std::atomic<uint64_t> seg_index{0};
  std::atomic<int64_t> seg_bytes{0};
  int64_t seg_limit = 0;     // rotation threshold (record boundaries)

  rabia::Mutex mu{"walkernel.mu"};
  rabia::CondVar cv;        // append lane -> flush thread
  rabia::CondVar cv_done;   // flush thread -> wal_sync waiters
  std::vector<uint8_t> stage RABIA_GUARDED_BY(mu);  // records to flush
  uint64_t staged_lsn RABIA_GUARDED_BY(mu) = 0;  // last staged record
  uint64_t flushed_lsn RABIA_GUARDED_BY(mu) = 0;  // last record written
  std::atomic<uint64_t> durable_lsn{0};
  std::atomic<int32_t> io_error{0};
  bool stop_req RABIA_GUARDED_BY(mu) = false;

  // vote-barrier state (native-runtime lane): barrier[s] is the first
  // slot NOT yet covered by a durable barrier record. The vector LENGTH
  // is fixed at create time — bounds checks read the immutable
  // n_shards; the slots are guarded.
  std::vector<int64_t> barrier RABIA_GUARDED_BY(mu);
  int64_t n_shards = 1;
  int64_t stride = 16;

  std::thread th;
  bool started = false;  // control-plane thread only (start/stop/destroy)
  int event_fd = -1;

  // counter block: multi-writer (append lane under mu, flush thread
  // without) — relaxed atomics, read zero-copy as plain u64s by the
  // Python scrape path (the RKC torn-read contract)
  std::atomic<uint64_t> ctrs[WLC_COUNT];
  static_assert(sizeof(std::atomic<uint64_t>) == sizeof(uint64_t),
                "counter block must read as a plain uint64 array");
  void bump(int i, uint64_t n = 1) {
    ctrs[i].fetch_add(n, std::memory_order_relaxed);
  }
  uint64_t hist[WLH_STRIDE];  // fsync latency; flush-thread-owned
};

// identical bucket math to runtime.cpp rth_observe: the Python exporter
// merges every native histogram row over ONE bound table (SLO_BUCKETS)
static void hist_observe(WalCtx* c, uint64_t ns) {
  uint64_t* h = c->hist;
  int32_t idx = 0;
  if (ns >= (1ull << WLH_MIN_EXP)) {
    const int32_t exp = 63 - __builtin_clzll(ns);
    const int32_t sub =
        (int32_t)((ns >> (exp - WLH_SUB_BITS)) & ((1 << WLH_SUB_BITS) - 1));
    idx = ((exp - WLH_MIN_EXP) << WLH_SUB_BITS) + sub;
    if (idx >= WLH_BUCKETS) idx = WLH_BUCKETS - 1;
  }
  h[idx]++;
  h[WLH_BUCKETS]++;        // count
  h[WLH_BUCKETS + 1] += ns;  // sum
}

// ---------------------------------------------------------------------------
// segment management (flush-thread only after start; create-time before)
// ---------------------------------------------------------------------------

static bool seg_open(WalCtx* c, uint64_t index, uint64_t base_lsn) {
  char name[64];
  snprintf(name, sizeof(name), "wal-%08llu.seg", (unsigned long long)index);
  std::string path = c->dir + "/" + name;
  int fd = open(path.c_str(), O_CREAT | O_TRUNC | O_WRONLY | O_CLOEXEC, 0644);
  if (fd < 0) return false;
  uint8_t head[WAL_HEADER];
  memcpy(head, &WAL_MAGIC, 4);
  memcpy(head + 4, &WAL_VERSION, 4);
  memcpy(head + 8, &index, 8);
  memcpy(head + 16, &base_lsn, 8);
  if (write(fd, head, WAL_HEADER) != WAL_HEADER) {
    close(fd);
    return false;
  }
  // header durable before any record can land after it; the directory
  // fsync makes the file's existence durable
  if (fsync(fd) != 0) {
    close(fd);
    return false;
  }
  if (c->dir_fd >= 0) fsync(c->dir_fd);
  if (c->seg_fd >= 0) {
    // records written to the OLD segment earlier in this flush batch
    // must be durable before the watermark can cover them — fsync
    // before the fd goes away (close() does not sync)
    fsync(c->seg_fd);
    close(c->seg_fd);
  }
  c->seg_fd = fd;
  c->seg_index.store(index, std::memory_order_relaxed);
  c->seg_bytes.store(WAL_HEADER, std::memory_order_relaxed);
  return true;
}

// write one span, rotating on record boundaries exactly where the Python
// twin would (deterministic in the record sequence, not the flush timing)
static bool flush_batch(WalCtx* c, const uint8_t* buf, int64_t len,
                        uint64_t first_lsn, uint64_t last_lsn) {
  int64_t at = 0;
  uint64_t lsn = first_lsn;
  while (at < len) {
    // find the largest run of whole records that fits the open segment
    int64_t run = 0;
    uint64_t run_recs = 0;
    const int64_t seg_bytes = c->seg_bytes.load(std::memory_order_relaxed);
    while (at + run < len) {
      uint32_t plen;
      memcpy(&plen, buf + at + run, 4);
      const int64_t frame = 8 + (int64_t)plen;
      if (run > 0 && seg_bytes + run + frame > c->seg_limit) break;
      // a first record never fits? it goes in alone (oversized records
      // own a segment; rotation below handles the boundary)
      if (run == 0 && seg_bytes > WAL_HEADER &&
          seg_bytes + frame > c->seg_limit)
        break;
      run += frame;
      run_recs++;
    }
    if (run == 0) {
      // rotation required before this record
      uint64_t next = c->seg_index.load(std::memory_order_relaxed) + 1;
      if (!seg_open(c, next, lsn)) return false;
      c->bump(WLC_ROTATIONS);
      continue;
    }
    int64_t done = 0;
    while (done < run) {
      ssize_t w = write(c->seg_fd, buf + at + done, (size_t)(run - done));
      if (w < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      done += w;
    }
    c->seg_bytes.fetch_add(run, std::memory_order_relaxed);
    c->bump(WLC_FLUSH_BYTES, (uint64_t)run);
    at += run;
    lsn += run_recs;
  }
  (void)last_lsn;
  return true;
}

static void wal_loop(WalCtx* c) {
  std::vector<uint8_t> local;
  for (;;) {
    uint64_t target;
    uint64_t first;
    {
      rabia::MutexLock lk(c->mu);
      while (c->stage.empty() && !c->stop_req) c->cv.wait(lk);
      if (c->stage.empty() && c->stop_req) break;
      local.clear();
      local.swap(c->stage);
      first = c->flushed_lsn + 1;
      target = c->staged_lsn;
      c->flushed_lsn = target;
    }
    c->bump(WLC_FLUSHES);
    bool ok = c->io_error.load(std::memory_order_relaxed) == 0;
    if (ok)
      ok = flush_batch(c, local.data(), (int64_t)local.size(), first, target);
    if (ok) {
      const uint64_t t0 = mono_ns();
      ok = fsync(c->seg_fd) == 0;
      const uint64_t dt = mono_ns() - t0;
      c->bump(WLC_FSYNCS);
      c->bump(WLC_FSYNC_NS, dt);
      c->bump(WLC_GROUP_RECORDS, target - first + 1);
      hist_observe(c, dt);
    }
    {
      // publish under mu: wal_sync's waiter evaluates its predicate
      // while holding mu, so a store outside the lock could land
      // between the check and the block — a lost wakeup that stalls
      // the waiter until its full timeout
      rabia::MutexLock lk(c->mu);
      if (!ok) {
        // a durability failure must never be reported as durable: the
        // watermark freezes, callers waiting on it see the wedge via
        // wal_io_error and fail loudly instead of acking lost writes
        c->io_error.store(1, std::memory_order_release);
        c->bump(WLC_IO_ERRORS);
      } else {
        c->durable_lsn.store(target, std::memory_order_release);
      }
    }
    if (c->event_fd >= 0) {
      uint64_t one = 1;
      (void)!write(c->event_fd, &one, 8);
    }
    c->cv_done.notify_all();
  }
}

// ---------------------------------------------------------------------------
// lifecycle
// ---------------------------------------------------------------------------

// start_lsn / start_segment come from the Python recovery scan: the new
// writer continues the log in a FRESH segment (start_segment) whose first
// record will be start_lsn + 1. seg_limit is the rotation threshold in
// bytes; n_shards sizes the vote-barrier vector; stride amortizes it.
void* wal_create(const char* dir, int64_t seg_limit, int64_t n_shards,
                 int64_t stride, uint64_t start_lsn,
                 uint64_t start_segment) {
  WalCtx* c = new (std::nothrow) WalCtx();
  if (!c) return nullptr;
  c->dir = dir;
  // clamp identically to the Python twin (max(limit, header+64)) — the
  // rotation threshold is part of the byte-parity contract
  c->seg_limit = seg_limit > WAL_HEADER + 64 ? seg_limit : WAL_HEADER + 64;
  c->stride = stride > 0 ? stride : 16;
  c->n_shards = n_shards > 0 ? n_shards : 1;
  for (auto& ctr : c->ctrs) ctr.store(0, std::memory_order_relaxed);
  memset(c->hist, 0, sizeof(c->hist));
  c->dir_fd = open(dir, O_RDONLY | O_DIRECTORY | O_CLOEXEC);
  if (c->dir_fd < 0) {
    delete c;
    return nullptr;
  }
  {
    // no other thread exists yet; the lock is for the analysis (and
    // free — uncontended)
    rabia::MutexLock lk(c->mu);
    c->barrier.assign((size_t)c->n_shards, 0);
    c->staged_lsn = c->flushed_lsn = start_lsn;
  }
  c->durable_lsn.store(start_lsn, std::memory_order_release);
  if (!seg_open(c, start_segment, start_lsn + 1)) {
    close(c->dir_fd);
    delete c;
    return nullptr;
  }
  c->event_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  return c;
}

int32_t wal_start(void* h) {
  WalCtx* c = (WalCtx*)h;
  if (c->started) return 0;
  c->started = true;
  c->th = std::thread([c] { wal_loop(c); });
  return 0;
}

// flush everything staged, then stop the thread. Records staged before
// this call are durable when it returns (clean-shutdown contract).
void wal_stop(void* h) {
  WalCtx* c = (WalCtx*)h;
  if (!c->started) return;
  {
    rabia::MutexLock lk(c->mu);
    c->stop_req = true;
  }
  c->cv.notify_all();
  if (c->th.joinable()) c->th.join();
  c->started = false;
}

void wal_destroy(void* h) {
  WalCtx* c = (WalCtx*)h;
  if (!c) return;
  wal_stop(c);
  if (c->seg_fd >= 0) close(c->seg_fd);
  if (c->dir_fd >= 0) close(c->dir_fd);
  if (c->event_fd >= 0) close(c->event_fd);
  delete c;
}

// ---------------------------------------------------------------------------
// the append lane (any thread; one mutex-protected buffer append)
// ---------------------------------------------------------------------------

// Stage one record; returns its LSN (>= 1), or -1 on a wedged log.
// Durability is NOT implied: compare wal_durable() or wait on the
// eventfd. The payload's leading kind byte is counted per-kind.
int64_t wal_append(void* h, const uint8_t* payload, int64_t len) {
  WalCtx* c = (WalCtx*)h;
  if (!c || len <= 0) return -1;
  if (c->io_error.load(std::memory_order_acquire)) return -1;
  const uint32_t plen = (uint32_t)len;
  const uint32_t crc = (uint32_t)crc32(0, payload, (uInt)len);
  uint64_t lsn;
  {
    rabia::MutexLock lk(c->mu);
    size_t w = c->stage.size();
    c->stage.resize(w + 8 + (size_t)len);
    memcpy(c->stage.data() + w, &plen, 4);
    memcpy(c->stage.data() + w + 4, &crc, 4);
    memcpy(c->stage.data() + w + 8, payload, (size_t)len);
    lsn = ++c->staged_lsn;
    c->bump(WLC_APPENDS);
    c->bump(WLC_APPEND_BYTES, (uint64_t)len + 8);
    switch (payload[0]) {
      case 1: c->bump(WLC_WAVES); break;
      case 2: c->bump(WLC_BARRIERS); break;
      case 3: c->bump(WLC_FRONTIERS); break;
      case 4: c->bump(WLC_LEDGERS); break;
      default: break;
    }
  }
  c->cv.notify_one();
  return (int64_t)lsn;
}

uint64_t wal_durable(void* h) {
  return ((WalCtx*)h)->durable_lsn.load(std::memory_order_acquire);
}

uint64_t wal_staged(void* h) {
  WalCtx* c = (WalCtx*)h;
  rabia::MutexLock lk(c->mu);
  return c->staged_lsn;
}

int32_t wal_io_error(void* h) {
  return ((WalCtx*)h)->io_error.load(std::memory_order_acquire);
}

int wal_event_fd(void* h) { return ((WalCtx*)h)->event_fd; }

// Block until everything staged so far is durable (shutdown, tests,
// checkpoint barriers). Returns 0 ok, -1 timeout/wedge.
int32_t wal_sync(void* h, double timeout_s) {
  WalCtx* c = (WalCtx*)h;
  uint64_t target;
  {
    rabia::MutexLock lk(c->mu);
    target = c->staged_lsn;
  }
  c->cv.notify_one();
  const timespec dl = rabia::CondVar::deadline_in(timeout_s);
  rabia::MutexLock lk(c->mu);
  for (;;) {
    if (c->io_error.load(std::memory_order_acquire)) return -1;
    if (c->durable_lsn.load(std::memory_order_acquire) >= target) return 0;
    if (!c->cv_done.wait_until(lk, dl)) {
      // timed out: one last look (the flush may have published while we
      // were timing out)
      if (c->io_error.load(std::memory_order_acquire)) return -1;
      return c->durable_lsn.load(std::memory_order_acquire) >= target
                 ? 0
                 : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// the vote-barrier lane (native-runtime write-ahead)
// ---------------------------------------------------------------------------

// Returns 0 when `slot` on `shard` is already covered by a staged
// barrier record (the common, stride-amortized case). Otherwise advances
// the barrier to slot + stride, stages a kind-2 record carrying the FULL
// barrier vector (byte format identical to the Python twin's
// encode_barrier), and returns the record's LSN — the caller must not
// let a vote for the slot reach the wire until wal_durable() >= that.
int64_t wal_barrier_covered(void* h, int64_t shard, int64_t slot) {
  WalCtx* c = (WalCtx*)h;
  if (!c || shard < 0 || shard >= c->n_shards) return 0;
  {
    rabia::MutexLock lk(c->mu);
    if (slot < c->barrier[(size_t)shard]) return 0;
    c->barrier[(size_t)shard] = slot + c->stride;
  }
  // encode outside the lock; wal_append re-locks (cheap, uncontended)
  const uint32_t n = (uint32_t)c->n_shards;
  std::vector<uint8_t> payload(5 + 8 * (size_t)n);
  payload[0] = 2;  // K_BARRIER
  memcpy(payload.data() + 1, &n, 4);
  {
    rabia::MutexLock lk(c->mu);
    memcpy(payload.data() + 5, c->barrier.data(), 8 * (size_t)n);
  }
  c->bump(WLC_BARRIER_WAITS);
  return wal_append(h, payload.data(), (int64_t)payload.size());
}

void wal_set_barrier(void* h, const int64_t* vec, int64_t n) {
  WalCtx* c = (WalCtx*)h;
  rabia::MutexLock lk(c->mu);
  for (int64_t i = 0; i < n && i < c->n_shards; i++)
    c->barrier[(size_t)i] = vec[i];
}

void wal_get_barrier(void* h, int64_t* out, int64_t n) {
  WalCtx* c = (WalCtx*)h;
  rabia::MutexLock lk(c->mu);
  for (int64_t i = 0; i < n && i < c->n_shards; i++)
    out[i] = c->barrier[(size_t)i];
}

// ---------------------------------------------------------------------------
// observability
// ---------------------------------------------------------------------------

int32_t wal_counters_version() { return WAL_COUNTERS_VERSION; }
int32_t wal_counters_count() { return WLC_COUNT; }
void* wal_counters(void* h) { return ((WalCtx*)h)->ctrs; }  // atomics read
                                                            // as plain u64s

int32_t wal_hist_version() { return WLH_VERSION; }
int32_t wal_hist_buckets() { return WLH_BUCKETS; }
int32_t wal_hist_sub_bits() { return WLH_SUB_BITS; }
int32_t wal_hist_min_exp() { return WLH_MIN_EXP; }
void* wal_hist(void* h) { return ((WalCtx*)h)->hist; }

int64_t wal_segment_index(void* h) {
  return (int64_t)((WalCtx*)h)->seg_index.load(std::memory_order_relaxed);
}
int64_t wal_segment_bytes(void* h) {
  return ((WalCtx*)h)->seg_bytes.load(std::memory_order_relaxed);
}

}  // extern "C"
