// Runtime stress: the io/tick thread vs the rtm_pause/resume handshake,
// the SPSC command/event rings, and the control-plane observability
// reads — over a REAL transport pair (the loop parks in rt_recv_borrow
// exactly as in production).
//
// The consensus kernels are STUBBED at the fn-pointer boundary (rk_tick
// reports nothing to do, rk_ingest classifies frames by a type byte):
// this program's target is the runtime's OWN shared state, not the
// consensus math the conformance fuzzer owns. Seams:
//   - single-writer-while-RUNNING: the control thread rtm_pause()s,
//     waits for PAUSED, mutates the shared consensus arrays
//     (next_slot/applied/tainted/last_progress), resumes — while the
//     peer keeps blasting frames. The round-13 release/acquire fix on
//     pause_req is exactly what TSan checks here;
//   - the cmd ring (control producer -> io consumer) under no-op
//     CMD_ADVANCE records, and the ev ring (io producer -> control
//     consumer) under escalated-frame traffic;
//   - rtm_inbox kicks racing the loop's timed recv waits;
//   - advisory counter/stage/flight reads while the loop writes them.

#include <vector>

#include "stress_common.h"
#include "transport.h"

extern "C" {
void* rtm_create(const int64_t* dims, const int64_t* ptrs,
                 const int64_t* fns, const uint8_t* uuids,
                 const double* fparams);
int32_t rtm_start(void* ctx);
void rtm_stop(void* ctx);
void rtm_destroy(void* ctx);
int32_t rtm_state(void* ctx);
void rtm_pause(void* ctx);
void rtm_resume(void* ctx);
int rtm_event_fd(void* ctx);
int32_t rtm_cmd_push(void* ctx, const uint8_t* rec, int64_t len);
int64_t rtm_ev_drain(void* ctx, uint8_t* out, int64_t cap);
int32_t rtm_counters_count(void);
void* rtm_counters(void* ctx);
int32_t rtm_stages_count(void);
void* rtm_stages(void* ctx);
int32_t rtm_hist_stages(void);
int32_t rtm_hist_buckets(void);
void* rtm_hist(void* ctx);
int32_t rtm_flight_cap(void);
int32_t rtm_flight_record_size(void);
void* rtm_flight(void* ctx);
uint64_t rtm_flight_head(void* ctx);
}

// --- consensus-kernel stubs at the FN_* boundary ----------------------------

static const uint8_t kTypeNoop = 0x42;  // stub: natively consumed
// anything else (except MT_PROPOSE_BLOCK=10, unused here): escalated

extern "C" int32_t stub_rk_ingest(void*, const uint8_t* frame, int64_t len,
                                  int32_t, double) {
  if (len >= 2 && frame[1] == kTypeNoop) return 2;  // RK_NOOP
  return 0;                                         // RK_PY: escalate
}

extern "C" void stub_rk_tick(void*, double, uint8_t*, int64_t, int32_t,
                             const uint8_t*, const int32_t*,
                             const int8_t*, int64_t* res) {
  for (int i = 0; i < 8; i++) res[i] = 0;  // nothing staged/decided
}

extern "C" void stub_rk_retransmit(void*, double, double, uint8_t*, int64_t,
                                   int64_t* res) {
  if (res) res[0] = 0;
}

extern "C" int64_t stub_rk_drain_stale(void*, int64_t*, int64_t*, int64_t*,
                                       int64_t) {
  return 0;
}

static const int kS = 4;        // shards
static const int kDecRing = 64;

int main() {
  // transport pair: `a` belongs to the runtime, `b` is the peer blaster
  unsigned char id_a[16] = {0xAA};
  unsigned char id_b[16] = {0xBB};
  unsigned short pa = 0, pb = 0;
  void* a = rt_create(id_a, "127.0.0.1", 0, &pa);
  void* b = rt_create(id_b, "127.0.0.1", 0, &pb);
  if (!a || !b) {
    std::fprintf(stderr, "transport create failed\n");
    return 1;
  }
  rt_add_peer(a, id_b, "127.0.0.1", pb);
  rt_add_peer(b, id_a, "127.0.0.1", pa);
  for (int i = 0; i < 200; i++) {
    unsigned char ids[16 * 4];
    if (rt_connected(a, ids, 4) >= 1 && rt_connected(b, ids, 4) >= 1) break;
    stress::sleep_ms(10);
  }

  // shared consensus arrays (the control plane mutates these while
  // PAUSED — the single-writer handoff under test)
  std::vector<int64_t> next_slot(kS, 0), applied(kS, 0), votes_seen(kS, 0),
      tainted(kS, -1);
  std::vector<uint8_t> in_flight(kS, 0);
  std::vector<double> last_progress(kS, 0.0), opened_at(kS, 0.0);
  std::vector<int64_t> ring_slot((size_t)kS * kDecRing, -1);
  std::vector<int8_t> ring_val((size_t)kS * kDecRing, -1);
  std::vector<int32_t> kslot(kS, 0);
  std::vector<int8_t> kdecided(kS, -1);
  std::vector<uint8_t> kdone(kS, 0), knewly(kS, 0);
  uint8_t uuids[2 * 16];
  memcpy(uuids, id_a, 16);
  memcpy(uuids + 16, id_b, 16);

  const int64_t dims[11] = {kS, kS, /*R=*/2, /*me=*/0, kDecRing,
                            /*native_apply=*/0, 1 << 20, 1 << 20,
                            /*max_cmds=*/64, /*max_cmd_size=*/4096,
                            /*workers=*/1};
  const int64_t ptrs[17] = {
      /*rk_ctx*/ 1,  // opaque to the stubs
      (int64_t)a,
      /*sk_plane*/ 0,
      (int64_t)next_slot.data(), (int64_t)applied.data(),
      (int64_t)in_flight.data(), (int64_t)votes_seen.data(),
      (int64_t)tainted.data(), (int64_t)last_progress.data(),
      (int64_t)opened_at.data(), (int64_t)ring_slot.data(),
      (int64_t)ring_val.data(), (int64_t)kslot.data(),
      (int64_t)kdecided.data(), (int64_t)kdone.data(),
      (int64_t)knewly.data(), /*wal*/ 0};
  const int64_t fns[20] = {
      (int64_t)&rt_recv_borrow, (int64_t)&rt_recv_release,
      (int64_t)&rt_broadcast_frames, (int64_t)&rt_send,
      (int64_t)&stub_rk_ingest, (int64_t)&stub_rk_tick,
      (int64_t)&stub_rk_retransmit, (int64_t)&stub_rk_drain_stale,
      0, 0, 0, 0, 0,  // FN_SK_* (native_apply=0)
      0, 0, 0,        // FN_WAL_*
      0, 0, 0, 0};    // FN_RECV_BORROW_GROUP / FN_SK_*_LANE (workers=1)
  const double fparams[4] = {1.0, 30.0, 0.2, 0.05};

  void* rtm = rtm_create(dims, ptrs, fns, uuids, fparams);
  if (!rtm || rtm_start(rtm) != 0) {
    std::fprintf(stderr, "rtm create/start failed\n");
    return 1;
  }

  std::atomic<bool> stop{false};
  std::atomic<long> pauses{0}, ev_bytes{0};
  std::atomic<int> fail{0};

  // control thread: the runtime_bridge's roles — pause/mutate/resume
  // cycles, no-op command pushes, and the ev-ring drain (it is the ONE
  // ev consumer, as in production)
  std::thread control([&] {
    stress::Rng rng(3);
    std::vector<uint8_t> evbuf(1 << 18);
    uint8_t cmd[5] = {3, 0, 0, 0, 0};  // CMD_ADVANCE, count=0 (no-op)
    while (!stop.load()) {
      rtm_pause(rtm);
      const double t0 = stress::now_s();
      while (rtm_state(rtm) != 2 /*PAUSED*/) {
        if (stress::now_s() - t0 > 5.0) {
          fail.store(1);  // pause never acknowledged
          rtm_resume(rtm);
          return;
        }
      }
      // single-writer handoff: mutate the shared arrays while parked
      for (int s = 0; s < kS; s++) {
        next_slot[s] += 1 + rng.below(3);
        applied[s] = next_slot[s] - 1;
        tainted[s] = applied[s] - 1;
        last_progress[s] = stress::now_s();
      }
      rtm_resume(rtm);
      pauses.fetch_add(1);
      for (int i = 0; i < 4; i++) rtm_cmd_push(rtm, cmd, sizeof(cmd));
      const int64_t n = rtm_ev_drain(rtm, evbuf.data(),
                                     (int64_t)evbuf.size());
      if (n > 0) ev_bytes.fetch_add(n);
      stress::sleep_ms(1);
    }
  });

  // peer blaster: half natively-consumed, half escalated to the ev ring
  std::thread blaster([&] {
    stress::Rng rng(4);
    uint8_t frame[128];
    while (!stop.load()) {
      memset(frame, 0, sizeof(frame));
      frame[1] = rng.below(2) ? kTypeNoop : 0x66;  // noop | escalate
      rt_broadcast(b, frame, sizeof(frame));
      rt_inbox_kick(a);
      if ((rng.next() & 63) == 0) stress::sleep_ms(1);
    }
  });

  // advisory scrape: counters/stages/hist/flight while the loop writes
  std::thread scraper([&] {
    const uint64_t* ctrs = (const uint64_t*)rtm_counters(rtm);
    const uint64_t* stg = (const uint64_t*)rtm_stages(rtm);
    const uint64_t* hist = (const uint64_t*)rtm_hist(rtm);
    const int nc = rtm_counters_count();
    const int ns = rtm_stages_count();
    const int nh = rtm_hist_stages() * (rtm_hist_buckets() + 2);
    volatile uint64_t sink = 0;
    while (!stop.load()) {
      sink ^= rabia_stress_advisory_read(ctrs, nc);
      sink ^= rabia_stress_advisory_read(stg, ns);
      sink ^= rabia_stress_advisory_read(hist, nh);
      rtm_flight_head(rtm);
      rtm_state(rtm);
      stress::sleep_ms(1);
    }
    (void)sink;
  });

  const double t0 = stress::now_s();
  while (stress::now_s() - t0 < 1.5 && !fail.load()) stress::sleep_ms(20);
  stop.store(true);
  control.join();
  blaster.join();
  scraper.join();
  rtm_stop(rtm);

  // io thread joined: plain reads of its counters are safe now
  const uint64_t* ctrs = (const uint64_t*)rtm_counters(rtm);
  const uint64_t native = ctrs[3];     // RTM_FRAMES_NATIVE
  const uint64_t escalated = ctrs[5];  // RTM_FRAMES_ESCALATED
  const uint64_t cmds = ctrs[7];       // RTM_CMDS
  rtm_destroy(rtm);
  rt_stop(b);
  rt_close(b);
  rt_stop(a);
  rt_close(a);
  if (fail.load()) {
    std::fprintf(stderr, "invariant violated: code %d\n", fail.load());
    return 2;
  }
  std::printf(
      "stress ok: %ld pauses, %llu native, %llu escalated, %llu cmds, "
      "%ld ev bytes\n",
      pauses.load(), (unsigned long long)native,
      (unsigned long long)escalated, (unsigned long long)cmds,
      ev_bytes.load());
  return (pauses.load() > 10 && native > 0 && escalated > 0 && cmds > 0 &&
          ev_bytes.load() > 0)
             ? 0
             : 3;
}
