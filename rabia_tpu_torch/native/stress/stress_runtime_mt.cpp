// Multi-worker runtime stress (thread-per-shard-group, round 14): two
// shard-group worker threads vs every cross-worker seam the split
// introduced, over a REAL transport pair, the REAL statekernel plane
// (per-lane applies + group store locking) and the REAL walkernel
// (N staging lanes into the one group-commit flush thread). Seams:
//   - per-group inbox routing: the io loop classifies REAL v3 vote
//     frames spanning both groups (rtm_frame_group_mask) and fans them
//     out; each worker ingests only its range (stubbed rk filters by a
//     harness-side range check);
//   - shared WAL staging vs 2 append lanes: both workers stage decided
//     waves via wal_append while the flush thread fsyncs — LSNs must
//     come back monotone per worker and the durable watermark advance;
//   - cross-worker result staging vs the broadcast/control drain: each
//     worker applies through its OWN statekernel lane (want=1), the
//     control thread drains BOTH ev rings through the one rtm_ev_drain;
//   - the multi-worker pause barrier: rtm_pause must park BOTH workers
//     (rtm_state == PAUSED) before the control thread mutates the
//     shared consensus arrays, under sustained frame + wave traffic.
//
// Consensus math is STUBBED at the fn boundary (the conformance fuzzer
// owns it): the stub tick "decides V1" whatever the runtime armed, so
// every CMD_OPEN_WAVE flows decide -> lane apply -> WAL stage -> result
// staging on the worker that owns its shard.

#include <string>
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
int32_t rtm_workers(void* ctx);
int32_t rtm_cmd_push(void* ctx, const uint8_t* rec, int64_t len);
int64_t rtm_ev_drain(void* ctx, uint8_t* out, int64_t cap);
int32_t rtm_counters_count(void);
void* rtm_counters_w(void* ctx, int32_t g);
void* rtm_stages_w(void* ctx, int32_t g);
int32_t rtm_stages_count(void);
uint64_t rtm_flight_head_w(void* ctx, int32_t g);
uint64_t rtm_frame_group_mask(void* ctx, const uint8_t* data, uint32_t len);

// statekernel (real)
void* sk_plane_create(int64_t n_stores, int64_t max_keys,
                      int64_t max_key_len, int64_t max_value_size);
void sk_plane_destroy(void* h);
int32_t sk_set_groups(void* h, int32_t ngroups);
int64_t sk_apply_wave(void* h, const uint8_t* data,
                      const int64_t* cmd_offsets, const int64_t* shards,
                      const int64_t* starts, const int64_t* idxs,
                      int64_t n_idx, double now, int32_t want);
int64_t sk_apply_wave_lane(void* h, int32_t lane, const uint8_t* data,
                           const int64_t* cmd_offsets, const int64_t* shards,
                           const int64_t* starts, const int64_t* idxs,
                           int64_t n_idx, double now, int32_t want);
void* sk_out_buf(void* h);
void* sk_out_offs(void* h);
void* sk_out_buf_lane(void* h, int32_t lane);
void* sk_out_offs_lane(void* h, int32_t lane);
void sk_plane_lock(void* h);
void sk_plane_unlock(void* h);
int64_t sk_get(void* h, int64_t idx, const uint8_t* key, int64_t klen,
               const uint8_t** val_addr, uint64_t* version_out);
int64_t sk_store_size(void* h, int64_t idx);
void* sk_counters(void* h);
int32_t sk_counters_count(void);

// walkernel (real)
void* wal_create(const char* dir, int64_t seg_limit, int64_t n_shards,
                 int64_t stride, uint64_t start_lsn, uint64_t start_segment);
int32_t wal_start(void* h);
void wal_stop(void* h);
void wal_destroy(void* h);
int64_t wal_append(void* h, const uint8_t* payload, int64_t len);
uint64_t wal_durable(void* h);
int64_t wal_barrier_covered(void* h, int64_t shard, int64_t slot);
int32_t wal_sync(void* h, double timeout_s);
}

static const int kS = 8;  // shards: groups [0,4) and [4,8)
static const int kW = 2;
static const int kDecRing = 64;

// shared kernel-state arrays the stub tick "decides" through (each
// worker's tick touches only its armed shards — disjoint by group)
static std::vector<int32_t> g_kslot;
static std::vector<int8_t> g_kdecided;
static std::vector<uint8_t> g_kdone;

extern "C" int32_t stub_rk_ingest(void*, const uint8_t* frame, int64_t len,
                                  int32_t, double) {
  if (len >= 2 && frame[1] == 2) return 2;  // v3 VOTE1: consumed (noop)
  return 0;                                 // escalate
}

// "decide V1 whatever was just armed": open_mask/open_slots arrive for
// this worker's range only, so the shared-array writes stay disjoint
extern "C" void stub_rk_tick(void*, double, uint8_t*, int64_t, int32_t,
                             const uint8_t* open_mask,
                             const int32_t* open_slots, const int8_t*,
                             int64_t* res) {
  for (int i = 0; i < 8; i++) res[i] = 0;
  if (!open_mask) return;
  for (int s = 0; s < kS; s++) {
    if (!open_mask[s]) continue;
    g_kslot[s] = open_slots[s];
    g_kdecided[s] = 1;  // V1
    g_kdone[s] = 1;
    res[1] = 1;  // done_any: process_decided runs
  }
}

extern "C" void stub_rk_retransmit(void*, double, double, uint8_t*, int64_t,
                                   int64_t* res) {
  if (res) res[0] = 0;
}

extern "C" int64_t stub_rk_drain_stale(void*, int64_t*, int64_t*, int64_t*,
                                       int64_t) {
  return 0;
}

// one-shard CMD_OPEN_WAVE with a single SET op (k<shard> = v)
static std::vector<uint8_t> make_wave_cmd(uint64_t token, uint32_t shard,
                                          uint64_t slot) {
  const uint8_t key = (uint8_t)('a' + (shard & 15));
  const uint8_t op[7] = {1, 2, 0, 'k', key, 'v', (uint8_t)('0' + (slot % 10))};
  std::vector<uint8_t> r;
  auto u32 = [&](uint32_t v) {
    r.insert(r.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
  };
  auto u64 = [&](uint64_t v) {
    r.insert(r.end(), (uint8_t*)&v, (uint8_t*)&v + 8);
  };
  r.push_back(2);  // CMD_OPEN_WAVE
  u64(token);
  r.push_back(1);  // want result frames
  u32(1);          // k entries
  u32(0);          // announce_len
  u32(sizeof(op)); // blob_len
  u32(1);          // total ops
  u32(shard);
  u64(slot);
  u32(0);  // bidx
  u32(1);  // nops
  u32(sizeof(op));  // op len
  r.insert(r.end(), op, op + sizeof(op));
  return r;
}

// a REAL v3 VOTE1 frame with entries on the given shards — what the
// group classifier parses and fans out across group inboxes
static std::vector<uint8_t> make_vote_frame(const uint8_t sender[16],
                                            const int* shards, int n) {
  std::vector<uint8_t> f(47 + 4 + (size_t)n * 13, 0);
  f[0] = 3;
  f[1] = 2;  // MT_VOTE1
  f[2] = 0;
  memcpy(f.data() + 19, sender, 16);
  double ts = stress::now_s();
  memcpy(f.data() + 35, &ts, 8);
  uint32_t body_len = 4 + (uint32_t)n * 13;
  memcpy(f.data() + 43, &body_len, 4);
  uint32_t cnt = (uint32_t)n;
  memcpy(f.data() + 47, &cnt, 4);
  for (int i = 0; i < n; i++) {
    uint8_t* e = f.data() + 51 + (size_t)i * 13;
    uint32_t s = (uint32_t)shards[i];
    memcpy(e, &s, 4);
    uint64_t ph = 1ull << 16;
    memcpy(e + 4, &ph, 8);
    e[12] = 1;
  }
  return f;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <wal-dir>\n", argv[0]);
    return 1;
  }
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

  void* sk = sk_plane_create(kS, 1 << 16, 256, 1 << 20);
  if (!sk || sk_set_groups(sk, kW) != 0) {
    std::fprintf(stderr, "sk plane create/groups failed\n");
    return 1;
  }
  void* wal = wal_create(argv[1], 1 << 20, kS, 16, 0, 0);
  if (!wal || wal_start(wal) != 0) {
    std::fprintf(stderr, "wal create/start failed\n");
    return 1;
  }

  std::vector<int64_t> next_slot(kS, 0), applied(kS, 0), votes_seen(kS, 0),
      tainted(kS, -1);
  std::vector<uint8_t> in_flight(kS, 0);
  std::vector<double> last_progress(kS, 0.0), opened_at(kS, 0.0);
  std::vector<int64_t> ring_slot((size_t)kS * kDecRing, -1);
  std::vector<int8_t> ring_val((size_t)kS * kDecRing, -1);
  g_kslot.assign(kS, 0);
  g_kdecided.assign(kS, -1);
  g_kdone.assign(kS, 0);
  std::vector<uint8_t> knewly(kS, 0);
  uint8_t uuids[2 * 16];
  memcpy(uuids, id_a, 16);
  memcpy(uuids + 16, id_b, 16);

  const int64_t dims[11] = {kS, kS, /*R=*/2, /*me=*/0, kDecRing,
                            /*native_apply=*/1, 1 << 20, 1 << 20,
                            /*max_cmds=*/64, /*max_cmd_size=*/4096,
                            /*workers=*/kW};
  const int64_t ptrs[18] = {
      /*rk_ctx worker0*/ 1,  // opaque to the stubs
      (int64_t)a,
      (int64_t)sk,
      (int64_t)next_slot.data(), (int64_t)applied.data(),
      (int64_t)in_flight.data(), (int64_t)votes_seen.data(),
      (int64_t)tainted.data(), (int64_t)last_progress.data(),
      (int64_t)opened_at.data(), (int64_t)ring_slot.data(),
      (int64_t)ring_val.data(), (int64_t)g_kslot.data(),
      (int64_t)g_kdecided.data(), (int64_t)g_kdone.data(),
      (int64_t)knewly.data(), (int64_t)wal,
      /*rk_ctx worker1*/ 2};
  const int64_t fns[20] = {
      (int64_t)&rt_recv_borrow, (int64_t)&rt_recv_release,
      (int64_t)&rt_broadcast_frames, (int64_t)&rt_send,
      (int64_t)&stub_rk_ingest, (int64_t)&stub_rk_tick,
      (int64_t)&stub_rk_retransmit, (int64_t)&stub_rk_drain_stale,
      (int64_t)&sk_apply_wave, (int64_t)&sk_out_buf, (int64_t)&sk_out_offs,
      (int64_t)&sk_plane_lock, (int64_t)&sk_plane_unlock,
      (int64_t)&wal_append, (int64_t)&wal_barrier_covered,
      (int64_t)&wal_durable,
      (int64_t)&rt_recv_borrow_group, (int64_t)&sk_apply_wave_lane,
      (int64_t)&sk_out_buf_lane, (int64_t)&sk_out_offs_lane};
  const double fparams[4] = {1.0, 30.0, 0.2, 0.05};

  void* rtm = rtm_create(dims, ptrs, fns, uuids, fparams);
  if (!rtm || rtm_workers(rtm) != kW) {
    std::fprintf(stderr, "rtm create failed / wrong worker count\n");
    return 1;
  }
  // per-group frame routing through the REAL classifier
  if (rt_set_groups(a, kW, (void*)&rtm_frame_group_mask, rtm) != 0) {
    std::fprintf(stderr, "rt_set_groups failed\n");
    return 1;
  }
  if (rtm_start(rtm) != 0) {
    std::fprintf(stderr, "rtm start failed\n");
    return 1;
  }

  std::atomic<bool> stop{false};
  std::atomic<long> pauses{0}, ev_bytes{0}, waves_pushed{0};
  std::atomic<int> fail{0};

  // control thread: wave submissions to BOTH groups, the pause BARRIER
  // (both workers must park), shared-array mutations while parked, and
  // the one ev drain
  std::thread control([&] {
    stress::Rng rng(7);
    std::vector<uint8_t> evbuf(1 << 18);
    uint64_t token = 1;
    std::vector<uint64_t> slot(kS, 0);
    while (!stop.load()) {
      // a wave on one shard of each group
      for (int g = 0; g < kW; g++) {
        const uint32_t s = (uint32_t)(g * (kS / kW) + rng.below(kS / kW));
        auto cmd = make_wave_cmd(token++, s, slot[s]);
        if (rtm_cmd_push(rtm, cmd.data(), (int64_t)cmd.size()) == 0) {
          slot[s]++;  // rejected re-opens reuse the slot; accepted move on
          waves_pushed.fetch_add(1);
        }
        rt_inbox_kick(a);
      }
      const int64_t n =
          rtm_ev_drain(rtm, evbuf.data(), (int64_t)evbuf.size());
      if (n > 0) ev_bytes.fetch_add(n);
      if ((rng.next() & 7) == 0) {
        // the pause barrier across both workers
        rtm_pause(rtm);
        const double t0 = stress::now_s();
        while (rtm_state(rtm) != 2 /*PAUSED*/) {
          if (stress::now_s() - t0 > 5.0) {
            fail.store(1);  // barrier never completed
            rtm_resume(rtm);
            return;
          }
          rtm_ev_drain(rtm, evbuf.data(), (int64_t)evbuf.size());
        }
        // single-writer handoff: mutate shared arrays while BOTH parked
        for (int s = 0; s < kS; s++) last_progress[s] = stress::now_s();
        rtm_resume(rtm);
        pauses.fetch_add(1);
      }
      stress::sleep_ms(1);
    }
  });

  // peer blaster: v3 vote frames spanning BOTH groups (classifier
  // fan-out with a buffer copy), group-pure frames, and escalate-type
  // frames for group 0's control lane
  std::thread blaster([&] {
    stress::Rng rng(9);
    const int both[4] = {0, 3, 4, 7};
    const int g0[2] = {1, 2};
    const int g1[2] = {5, 6};
    while (!stop.load()) {
      const uint32_t pick = rng.below(4);
      std::vector<uint8_t> f;
      if (pick == 0) {
        f = make_vote_frame(id_b, both, 4);
      } else if (pick == 1) {
        f = make_vote_frame(id_b, g0, 2);
      } else if (pick == 2) {
        f = make_vote_frame(id_b, g1, 2);
      } else {
        f.assign(64, 0);
        f[0] = 3;
        f[1] = 0x66;  // unknown type: group 0, escalated
        memcpy(f.data() + 19, id_b, 16);
      }
      rt_broadcast(b, f.data(), (uint32_t)f.size());
      rt_inbox_kick(a);
      if ((rng.next() & 31) == 0) stress::sleep_ms(1);
    }
  });

  // scraper: per-worker advisory block reads + a plane-locked GET
  // (reader vs both apply lanes — the group store locking under test)
  std::thread scraper([&] {
    const int nc = rtm_counters_count();
    const int ns = rtm_stages_count();
    volatile uint64_t sink = 0;
    while (!stop.load()) {
      for (int g = 0; g < kW; g++) {
        sink ^= rabia_stress_advisory_read(
            (const uint64_t*)rtm_counters_w(rtm, g), nc);
        sink ^= rabia_stress_advisory_read(
            (const uint64_t*)rtm_stages_w(rtm, g), ns);
        rtm_flight_head_w(rtm, g);
      }
      sk_plane_lock(sk);
      const uint8_t key[2] = {'k', 'a'};
      const uint8_t* val = nullptr;
      uint64_t ver = 0;
      (void)sk_get(sk, 0, key, 2, &val, &ver);
      if (val) {
        volatile uint8_t v0 = val[0];  // borrowed read under the bracket
        (void)v0;
      }
      sk_plane_unlock(sk);
      rtm_state(rtm);
      stress::sleep_ms(1);
    }
    (void)sink;
  });

  // durability waiter: the group-commit flush must keep the watermark
  // advancing while both workers stage
  std::thread waiter([&] {
    uint64_t last = 0;
    while (!stop.load()) {
      wal_sync(wal, 0.05);
      const uint64_t d = wal_durable(wal);
      if (d < last) fail.store(2);  // watermark went BACKWARDS
      last = d;
      stress::sleep_ms(2);
    }
  });

  const double t0 = stress::now_s();
  while (stress::now_s() - t0 < 1.5 && !fail.load()) stress::sleep_ms(20);
  stop.store(true);
  control.join();
  blaster.join();
  scraper.join();
  waiter.join();
  rtm_stop(rtm);

  // workers joined: plain reads are safe now
  long applied_per_worker[kW] = {0, 0};
  long native_per_worker[kW] = {0, 0};
  for (int g = 0; g < kW; g++) {
    const uint64_t* ctrs = (const uint64_t*)rtm_counters_w(rtm, g);
    applied_per_worker[g] = (long)ctrs[14];  // RTM_SLOTS_APPLIED
    native_per_worker[g] = (long)ctrs[3];    // RTM_FRAMES_NATIVE
  }
  const uint64_t durable = wal_durable(wal);
  // clear routing BEFORE destroying the ctx: the io thread's classifier
  // holds the ctx pointer (the exact teardown order the bridge uses)
  rt_set_groups(a, 0, nullptr, nullptr);
  rtm_destroy(rtm);
  wal_stop(wal);
  wal_destroy(wal);
  sk_plane_destroy(sk);
  rt_stop(b);
  rt_close(b);
  rt_stop(a);
  rt_close(a);
  if (fail.load()) {
    std::fprintf(stderr, "invariant violated: code %d\n", fail.load());
    return 2;
  }
  std::printf(
      "stress ok: %ld pauses, applied per worker [%ld, %ld], frames per "
      "worker [%ld, %ld], %ld waves pushed, %ld ev bytes, durable=%llu\n",
      pauses.load(), applied_per_worker[0], applied_per_worker[1],
      native_per_worker[0], native_per_worker[1], waves_pushed.load(),
      ev_bytes.load(), (unsigned long long)durable);
  // both workers must have done real end-to-end work: frames ingested,
  // waves applied through their own lanes, WAL records durable, events
  // drained, and the pause barrier exercised
  return (pauses.load() > 0 && applied_per_worker[0] > 0 &&
          applied_per_worker[1] > 0 && native_per_worker[0] > 0 &&
          native_per_worker[1] > 0 && ev_bytes.load() > 0 && durable > 0)
             ? 0
             : 3;
}
