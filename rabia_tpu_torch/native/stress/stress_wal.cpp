// WAL stress: the append lane vs the dedicated flush thread vs waiters.
//
// Seams (walkernel.cpp): multi-thread wal_append staging into the
// mutex-guarded buffer while the flush thread drains/rotates/fsyncs;
// the stride-amortized vote-barrier lane advancing + snapshotting the
// barrier vector; wal_sync waiters racing the durable-watermark publish;
// and the advisory observability reads (staged/durable/segment/
// counters) the telemetry thread performs in production. Main stops the
// writer mid-traffic once (clean-shutdown contract: everything staged
// before wal_stop is durable when it returns) and restarts a fresh ctx
// in the same dir continuing the LSN chain.
//
// Usage: stress_wal <empty-dir>

#include <sys/stat.h>

#include <string>
#include <vector>

#include "stress_common.h"

extern "C" {
void* wal_create(const char* dir, int64_t seg_limit, int64_t n_shards,
                 int64_t stride, uint64_t start_lsn, uint64_t start_segment);
int32_t wal_start(void* h);
void wal_stop(void* h);
void wal_destroy(void* h);
int64_t wal_append(void* h, const uint8_t* payload, int64_t len);
uint64_t wal_durable(void* h);
uint64_t wal_staged(void* h);
int32_t wal_io_error(void* h);
int32_t wal_sync(void* h, double timeout_s);
int64_t wal_barrier_covered(void* h, int64_t shard, int64_t slot);
void wal_set_barrier(void* h, const int64_t* vec, int64_t n);
void wal_get_barrier(void* h, int64_t* out, int64_t n);
int32_t wal_counters_count(void);
void* wal_counters(void* h);
int64_t wal_segment_index(void* h);
int64_t wal_segment_bytes(void* h);
}

static const int kShards = 8;

static long run_phase(void* w, double seconds) {
  std::atomic<bool> stop{false};
  std::atomic<long> appended{0};
  std::atomic<int> fail{0};

  auto appender = [&](uint64_t seed) {
    stress::Rng rng(seed);
    std::vector<uint8_t> pay;
    int burst = 0;
    while (!stop.load()) {
      const uint32_t n = 16 + rng.below(480);
      pay.assign(n, 0);
      pay[0] = (uint8_t)(1 + rng.below(4));  // kind 1..4
      for (uint32_t i = 1; i < n; i++) pay[i] = (uint8_t)rng.next();
      if (wal_append(w, pay.data(), (int64_t)n) > 0)
        appended.fetch_add(1);
      else if (!wal_io_error(w))
        fail.store(1);  // append refused on a healthy log: a bug
      // paced bursts: the append lane has no backpressure by design
      // (group commit absorbs it); unpaced spinners on a small box
      // would grow staged-vs-durable lag without bound and turn the
      // syncer's timeout into noise
      if (++burst % 16 == 0) stress::sleep_ms(1);
    }
  };

  std::thread a1(appender, 11), a2(appender, 22), a3(appender, 33);
  std::thread barrier([&] {
    stress::Rng rng(44);
    int64_t slot = 0;
    int64_t vec[kShards];
    int burst = 0;
    while (!stop.load()) {
      slot += 1 + rng.below(8);
      wal_barrier_covered(w, (int64_t)rng.below(kShards), slot);
      wal_get_barrier(w, vec, kShards);
      if ((slot & 63) == 0) wal_set_barrier(w, vec, kShards);
      if (++burst % 32 == 0) stress::sleep_ms(1);
    }
  });
  std::thread syncer([&] {
    while (!stop.load()) {
      const uint64_t staged = wal_staged(w);
      const uint64_t before = wal_durable(w);
      if (wal_sync(w, 10.0) == 0) {
        if (wal_durable(w) < staged) fail.store(2);  // sync lied
      } else if (!wal_io_error(w) && wal_durable(w) == before) {
        // a timeout with PROGRESS is a loaded box (sanitizer overhead
        // on a saturated CI runner); a frozen watermark on a healthy
        // log is the real lost-wakeup/stuck-flush bug
        fail.store(3);
      }
      stress::sleep_ms(2);
    }
  });
  std::thread scraper([&] {
    const uint64_t* ctrs = (const uint64_t*)wal_counters(w);
    const int n = wal_counters_count();
    volatile uint64_t sink = 0;
    while (!stop.load()) {
      sink ^= rabia_stress_advisory_read(ctrs, n);
      wal_segment_index(w);
      wal_segment_bytes(w);
      wal_durable(w);
      stress::sleep_ms(1);
    }
    (void)sink;
  });

  const double t0 = stress::now_s();
  while (stress::now_s() - t0 < seconds && !fail.load()) stress::sleep_ms(20);
  stop.store(true);
  a1.join();
  a2.join();
  a3.join();
  barrier.join();
  syncer.join();
  scraper.join();
  if (fail.load()) {
    std::fprintf(stderr, "invariant violated: code %d\n", fail.load());
    return -1;
  }
  return appended.load();
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: stress_wal <dir>\n");
    return 1;
  }
  // small segment limit: rotation happens constantly under load
  void* w = wal_create(argv[1], 32 * 1024, kShards, 4, 0, 0);
  if (!w) {
    std::fprintf(stderr, "wal_create failed\n");
    return 1;
  }
  wal_start(w);
  long n1 = run_phase(w, 0.8);
  if (n1 < 0) return 2;
  // clean shutdown mid-traffic: everything staged must be durable
  const uint64_t staged = wal_staged(w);
  wal_stop(w);
  if (wal_durable(w) < staged && !wal_io_error(w)) {
    std::fprintf(stderr, "clean-shutdown durability hole: staged=%llu "
                 "durable=%llu\n", (unsigned long long)staged,
                 (unsigned long long)wal_durable(w));
    return 3;
  }
  const int64_t seg = wal_segment_index(w);
  wal_destroy(w);

  // restart continuing the chain (the recovery scan's contract: fresh
  // segment, LSNs continue)
  void* w2 = wal_create(argv[1], 32 * 1024, kShards, 4, staged,
                        (uint64_t)seg + 1);
  if (!w2) {
    std::fprintf(stderr, "wal re-create failed\n");
    return 4;
  }
  wal_start(w2);
  long n2 = run_phase(w2, 0.5);
  wal_stop(w2);
  wal_destroy(w2);
  if (n2 < 0) return 5;

  // wedge phase: a rotation that cannot open its next segment must
  // FREEZE the watermark (io_error set, appends refused, never a false
  // durable ack) and still shut down cleanly. Forced by renaming the
  // log directory away mid-traffic (permission tricks don't work under
  // root); the tiny seg_limit makes rotation imminent.
  std::string dir3 = std::string(argv[1]) + "/wedge";
  std::string dir3_moved = std::string(argv[1]) + "/wedge-moved";
  if (mkdir(dir3.c_str(), 0755) != 0) {
    std::fprintf(stderr, "mkdir wedge dir failed\n");
    return 7;
  }
  void* w3 = wal_create(dir3.c_str(), 1, kShards, 4, 0, 0);  // min limit
  if (!w3) {
    std::fprintf(stderr, "wedge wal_create failed\n");
    return 7;
  }
  wal_start(w3);
  if (rename(dir3.c_str(), dir3_moved.c_str()) != 0) {
    std::fprintf(stderr, "rename failed\n");
    return 7;
  }
  uint8_t pay[64] = {1};
  bool wedged = false;
  for (int i = 0; i < 5000 && !wedged; i++) {
    if (wal_append(w3, pay, sizeof(pay)) < 0 && wal_io_error(w3))
      wedged = true;
    if ((i & 63) == 0) stress::sleep_ms(1);
  }
  const uint64_t frozen = wal_durable(w3);
  if (wedged) {
    // the watermark must never move again, and sync must fail fast
    if (wal_sync(w3, 0.2) == 0 || wal_durable(w3) != frozen) {
      std::fprintf(stderr, "wedged log acked a write\n");
      return 8;
    }
  }
  wal_stop(w3);
  wal_destroy(w3);
  if (!wedged) {
    std::fprintf(stderr, "wedge never engaged (rotation not reached)\n");
    return 9;
  }
  std::printf("stress ok: %ld + %ld records, wedge held at %llu\n", n1, n2,
              (unsigned long long)frozen);
  return (n1 > 0 && n2 > 0) ? 0 : 6;
}
