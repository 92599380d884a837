// Transport stress: the epoll io loop vs every concurrent caller lane.
//
// Grown from the round-3 transport_stress.cpp (which gated send/
// broadcast/recv/stats/teardown) with the two seams the chaos and
// scale-out planes added since: the SHAPING delay-heap (rt_set_shaping
// mutating the per-peer delay/drop state while the io thread drains the
// heap at release time) and the flight-ring snapshot (rt_flight_copy
// under the io mutex while both sides record frames).
//
// Threads: two senders (send + broadcast + batched broadcast_frames),
// a zero-copy borrow drain, a copying drain, a shaping meddler
// (set/clear shaping + peer remove/re-add churn), and a stats scraper
// (connected/pool/dropped/flight/counters). Main tears one side down
// mid-traffic. Exit 0 requires real traffic flowed.

#include <vector>

#include "stress_common.h"
#include "transport.h"

int main() {
  unsigned char id_a[16] = {1};
  unsigned char id_b[16] = {2};
  unsigned short pa = 0, pb = 0;
  void* a = rt_create(id_a, "127.0.0.1", 0, &pa);
  void* b = rt_create(id_b, "127.0.0.1", 0, &pb);
  if (!a || !b) {
    std::fprintf(stderr, "create failed\n");
    return 1;
  }
  rt_add_peer(a, id_b, "127.0.0.1", pb);
  rt_add_peer(b, id_a, "127.0.0.1", pa);

  for (int i = 0; i < 200; i++) {
    unsigned char ids[16 * 4];
    if (rt_connected(a, ids, 4) >= 1 && rt_connected(b, ids, 4) >= 1) break;
    stress::sleep_ms(10);
  }

  std::atomic<bool> stop{false};
  std::atomic<long> received{0};

  std::thread sender_a([&] {
    uint8_t msg[512];
    memset(msg, 0x5A, sizeof(msg));
    // a batch of 3 length-prefixed frames, as the native tick's rk_tick
    // emits them (rt_broadcast_frames staging path)
    uint8_t batch[3 * (4 + 96)];
    for (int f = 0; f < 3; f++) {
      uint8_t* rec = batch + f * (4 + 96);
      uint32_t len = 96;
      memcpy(rec, &len, 4);
      memset(rec + 4, 0x30 + f, 96);
    }
    while (!stop.load()) {
      rt_send(a, id_b, msg, sizeof(msg));
      rt_broadcast(a, msg, 64);
      rt_broadcast_frames(a, batch, sizeof(batch));
    }
  });
  std::thread sender_b([&] {
    uint8_t msg[2048];
    memset(msg, 0xA5, sizeof(msg));
    while (!stop.load()) rt_broadcast(b, msg, sizeof(msg));
  });
  std::thread receiver_a([&] {
    // zero-copy drain: borrow straight from the frame arena, touch the
    // bytes (TSan-visible read of io-thread-written memory), release
    uint8_t sender[16];
    const uint8_t* ptr = nullptr;
    uint32_t len = 0;
    volatile uint8_t sink = 0;
    while (!stop.load()) {
      int64_t tok = rt_recv_borrow(a, sender, &ptr, &len, 20);
      if (tok >= 0) {
        if (len > 0) sink ^= ptr[len - 1];
        rt_recv_release(a, tok);
        received.fetch_add(1);
      } else if (tok == -1) {
        break;  // closing
      }
    }
    (void)sink;
  });
  std::thread receiver_b([&] {
    uint8_t sender[16];
    std::vector<uint8_t> buf(1 << 16);
    while (!stop.load()) {
      int n = rt_recv(b, sender, buf.data(), buf.size(), 20);
      if (n >= 0) received.fetch_add(1);
    }
  });
  std::thread shaper([&] {
    // the chaos plane's lane: mutate the per-peer shaping entry (delay +
    // jitter + drop, reseeding the RNG) while the io thread applies it
    // at drain time and releases the delay-heap, then clear — plus
    // redial churn under load
    stress::Rng rng(7);
    int cycles = 0;
    while (!stop.load()) {
      rt_set_shaping(a, id_b, 200 + rng.below(400), rng.below(200),
                     0.05, rng.next() | 1);
      stress::sleep_ms(3);
      rt_set_shaping(a, id_b, 0, 0, 0.0, 0);  // clear this peer
      if (++cycles % 16 == 0) {
        rt_clear_shaping(a);
        rt_remove_peer(a, id_b);
        stress::sleep_ms(10);
        rt_add_peer(a, id_b, "127.0.0.1", pb);
      }
      stress::sleep_ms(2);
    }
  });
  std::thread scraper([&] {
    uint8_t ids[16 * 8];
    const int rec = rt_flight_record_size();
    std::vector<uint8_t> flight((size_t)rec * 256);
    const uint64_t* ctrs_a = rt_counters(a);
    const int nctrs = rt_counters_count();
    volatile uint64_t sink = 0;
    while (!stop.load()) {
      rt_connected(a, ids, 8);
      uint64_t h = 0, m = 0;
      rt_pool_stats(b, &h, &m);
      rt_out_pool_stats(a, &h, &m);
      rt_dropped(a);
      rt_flight_copy(a, flight.data(), 256);
      sink ^= rabia_stress_advisory_read(ctrs_a, nctrs);
      rt_inbox_kick(a);
      stress::sleep_ms(5);
    }
    (void)sink;
  });

  stress::sleep_ms(1500);
  // tear one side down mid-traffic (close-under-load path)
  rt_stop(b);
  stress::sleep_ms(100);
  stop.store(true);
  sender_a.join();
  sender_b.join();
  receiver_a.join();
  receiver_b.join();
  shaper.join();
  scraper.join();
  rt_close(b);
  rt_stop(a);
  rt_close(a);
  std::printf("stress ok: %ld frames received\n", received.load());
  return received.load() > 0 ? 0 : 2;
}
