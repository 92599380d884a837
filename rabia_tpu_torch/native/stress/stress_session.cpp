// Sessionkernel stress: the GC sweep vs concurrent gws_submit seam.
//
// The round-13 plane mutex made the session table safe under concurrent
// callers (gateway fleet / thread-per-shard-group direction); this
// program hammers exactly the interleavings the asyncio loop used to
// serialize: a HOT submit lane (hello/submit/complete/dedup-replay,
// dereferencing cached-reply blobs) vs a CHURN lane (sessions opened
// and abandoned to expire) vs the GC sweep (tombstoning + rehash +
// eviction) vs introspection (len/stats/info/ids/seqs).
//
// Blob-borrow discipline: cached replies are borrowed-until-next-
// mutation BY ANY THREAD, so the hot lane only dereferences blobs of
// sessions GC provably cannot touch — ack_upto stays 0 (no frontier
// eviction), per-session results stay far under the cache cap, every
// call passes a FRESH timestamp (a stale `now` makes last_active lie
// to the sweeper), and the concurrent-phase ttls sit far above any
// plausible scheduler stall (an early harness draft used a 0.15s lease
// and ASan-on-a-saturated-box preemption let GC reap a session between
// a submit's return and its blob read — a real use-after-free of the
// borrow contract, caught by this very cell). The churn lane's
// abandoned sessions are the ones that expire concurrently; the hard
// LEASE path is validated deterministically post-join with a forged
// future clock (gws_gc's `now` is a parameter). That mirrors
// production: the asyncio loop owns its live sessions' replies; GC
// only frees what no caller still reads.

#include <vector>

#include "stress_common.h"

extern "C" {
void* gws_create(int64_t default_window, double session_ttl,
                 int64_t result_cache_cap, double lease_ttl);
void gws_destroy(void* h);
int32_t gws_counters_count(void);
void* gws_counters(void* h);
int64_t gws_len(void* h);
void gws_clear(void* h);
void gws_stats(void* h, uint64_t* out);
int64_t gws_hello(void* h, const uint8_t* cid, int64_t req_window,
                  double now, uint64_t* last_seq_out);
int32_t gws_submit(void* h, const uint8_t* cid, uint64_t seq,
                   uint64_t ack_upto, double now, int32_t* status_out,
                   const uint8_t** blob_out, int64_t* blob_len_out);
int32_t gws_complete(void* h, const uint8_t* cid, uint64_t seq,
                     int32_t status, uint64_t frontier_mark,
                     const uint8_t* blob, int64_t blob_len, double now);
void gws_abort(void* h, const uint8_t* cid, uint64_t seq);
int64_t gws_gc(void* h, uint64_t state_version, double now);
int32_t gws_session_info(void* h, const uint8_t* cid, int64_t* window,
                         uint64_t* ack_upto, uint64_t* highest,
                         int64_t* n_inflight, int64_t* n_results);
int32_t gws_get_result(void* h, const uint8_t* cid, uint64_t seq,
                       int32_t* status_out, uint64_t* frontier_out,
                       const uint8_t** blob_out, int64_t* blob_len_out);
int64_t gws_session_ids(void* h, uint8_t* out, int64_t cap);
int64_t gws_result_seqs(void* h, const uint8_t* cid, uint64_t* out,
                        int64_t cap);
int64_t gws_inflight_seqs(void* h, const uint8_t* cid, uint64_t* out,
                          int64_t cap);
}

static void mk_cid(uint8_t* cid, uint32_t base, uint32_t i) {
  memset(cid, 0, 16);
  memcpy(cid, &base, 4);
  memcpy(cid + 4, &i, 4);
}

int main() {
  // session_ttl low enough that ABANDONED churn sessions expire during
  // the run, but far above any plausible stall of a hot lane; the lease
  // outlives the whole run (its path is checked post-join with a forged
  // clock); generous cache cap so hot blobs are never cap-evicted
  void* h = gws_create(/*window=*/8, /*session_ttl=*/2.0,
                       /*cache_cap=*/64, /*lease_ttl=*/30.0);
  if (!h) {
    std::fprintf(stderr, "gws_create failed\n");
    return 1;
  }
  std::atomic<bool> stop{false};
  std::atomic<long> submits{0}, dedups{0};
  std::atomic<int> fail{0};
  const double t0 = stress::now_s();

  // two hot submit lanes over DISJOINT cid ranges (each lane owns its
  // sessions' borrowed blobs; GC cannot free them — see header)
  auto hot = [&](uint32_t base, uint64_t seed) {
    stress::Rng rng(seed);
    uint8_t cid[16], payload[96];
    while (!stop.load()) {
      mk_cid(cid, base, rng.below(32));
      const uint64_t seq = 1 + rng.below(24);
      if (gws_hello(h, cid, 8, stress::now_s() - t0, nullptr) < 0) {
        fail.store(1);
        return;
      }
      int32_t st = 0;
      const uint8_t* blob = nullptr;
      int64_t blen = 0;
      const int32_t rc = gws_submit(h, cid, seq, /*ack_upto=*/0,
                                    stress::now_s() - t0, &st, &blob,
                                    &blen);
      submits.fetch_add(1);
      if (rc == 0) {  // FRESH: complete with a payload blob
        memset(payload, (int)(seq & 0xFF), sizeof(payload));
        gws_complete(h, cid, seq, 0, 1, payload, sizeof(payload),
                     stress::now_s() - t0);
      } else if (rc == 1) {  // DUP_CACHED: read the borrowed reply
        volatile uint8_t sink = 0;
        for (int64_t i = 0; i < blen; i++) sink ^= blob[i];
        if (blen != sizeof(payload) || blob[0] != (uint8_t)(seq & 0xFF))
          fail.store(2);  // cached reply corrupted
        dedups.fetch_add(1);
        (void)sink;
      } else if (rc == 3) {  // window full: abort one inflight
        uint64_t seqs[16];
        const int64_t n = gws_inflight_seqs(h, cid, seqs, 16);
        if (n > 0) gws_abort(h, cid, seqs[0]);
      }
    }
  };
  std::thread h1(hot, 0x1000, 5), h2(hot, 0x2000, 6);

  std::thread churn([&] {
    stress::Rng rng(7);
    uint8_t cid[16];
    uint32_t i = 0;
    while (!stop.load()) {
      const double now = stress::now_s() - t0;
      mk_cid(cid, 0x9000, i++);
      gws_hello(h, cid, 4, now, nullptr);
      int32_t st;
      const uint8_t* b;
      int64_t bl;
      if (gws_submit(h, cid, 1, 0, now, &st, &b, &bl) == 0) {
        uint8_t pay[8] = {1};
        // half complete (idle expiry path), half stay inflight (the
        // hard-lease path must reap them despite the reservation)
        if (rng.below(2)) gws_complete(h, cid, 1, 0, 1, pay, 8, now);
      }
      stress::sleep_ms(1);
    }
  });

  std::thread gc([&] {
    while (!stop.load()) {
      gws_gc(h, /*state_version=*/1u << 20, stress::now_s() - t0);
      stress::sleep_ms(2);
    }
  });

  std::thread intro([&] {
    uint8_t ids[16 * 512];
    uint64_t seqs[64], stats[6];
    uint8_t cid[16];
    stress::Rng rng(9);
    const uint64_t* ctrs = (const uint64_t*)gws_counters(h);
    const int nctrs = gws_counters_count();
    volatile uint64_t sink = 0;
    while (!stop.load()) {
      gws_len(h);
      gws_stats(h, stats);
      gws_session_ids(h, ids, 512);
      mk_cid(cid, 0x1000, rng.below(32));
      int64_t w, ni, nr;
      uint64_t a, hi;
      if (gws_session_info(h, cid, &w, &a, &hi, &ni, &nr)) {
        gws_result_seqs(h, cid, seqs, 64);
        gws_inflight_seqs(h, cid, seqs, 64);
      }
      sink ^= rabia_stress_advisory_read(ctrs, nctrs);
      stress::sleep_ms(1);
    }
    (void)sink;
  });

  while (stress::now_s() - t0 < 3.0 && !fail.load()) stress::sleep_ms(20);
  stop.store(true);
  h1.join();
  h2.join();
  churn.join();
  gc.join();
  intro.join();

  // deterministic expiry + hard-lease checks, single-threaded (gws_gc's
  // `now` is caller time, so a forged future clock exercises both
  // paths without racing the borrow contract)
  uint8_t cid[16];
  mk_cid(cid, 0x7777, 1);
  const double now = stress::now_s() - t0;
  gws_hello(h, cid, 4, now, nullptr);
  int32_t st;
  const uint8_t* b;
  int64_t bl;
  gws_submit(h, cid, 1, 0, now, &st, &b, &bl);  // stays inflight
  gws_gc(h, 1u << 20, now + 100.0);
  int64_t w_, ni_, nr_;
  uint64_t a_, hi_;
  const bool lease_reaped =
      gws_session_info(h, cid, &w_, &a_, &hi_, &ni_, &nr_) == 0;

  uint64_t stats[6];
  gws_stats(h, stats);
  const bool expired = stats[4] > 0;  // sessions were reaped
  const bool leases = stats[5] > 0;   // incl. the inflight one (lease)
  gws_clear(h);
  gws_destroy(h);
  if (fail.load()) {
    std::fprintf(stderr, "invariant violated: code %d\n", fail.load());
    return 2;
  }
  std::printf("stress ok: %ld submits, %ld dedup replays, %llu expired\n",
              submits.load(), dedups.load(),
              (unsigned long long)stats[4]);
  return (submits.load() > 1000 && dedups.load() > 0 && expired &&
          leases && lease_reaped)
             ? 0
             : 3;
}
