// Statekernel stress: the plane lock vs apply/export/snapshot lanes.
//
// Seams (statekernel.cpp): the recursive plane mutex is the handoff
// between the GIL-free runtime thread's apply path and the Python
// control plane's reads — sk_get's BORROWED value pointer is only valid
// while the caller holds the sk_plane_lock bracket across the copy-out,
// and the round-13 annotations made the previously-unlocked advisory
// reads (store_size/version/stats/export) lock internally. This program
// runs mutators (restore-path insert/delete/clear + version/stat
// writes) against bracketed readers (get + copy, export), the
// incremental-snapshot lane (delta_size/delta/mark), and the advisory
// introspection lane, all concurrently.

#include <vector>

#include "stress_common.h"

extern "C" {
void* sk_plane_create(int64_t n_stores, int64_t max_keys,
                      int64_t max_key_len, int64_t max_value_size);
void sk_plane_destroy(void* h);
void sk_plane_lock(void* h);
void sk_plane_unlock(void* h);
int32_t sk_counters_count(void);
void* sk_counters(void* h);
int64_t sk_store_count(void* h);
int64_t sk_store_size(void* h, int64_t idx);
uint64_t sk_store_version(void* h, int64_t idx);
void sk_set_version(void* h, int64_t idx, uint64_t v);
void sk_store_stats(void* h, int64_t idx, uint64_t* out);
void sk_add_stats(void* h, int64_t idx, uint64_t ops, uint64_t reads,
                  uint64_t writes);
int64_t sk_get(void* h, int64_t idx, const uint8_t* key, int64_t klen,
               const uint8_t** val_addr, uint64_t* version_out);
int64_t sk_export_size(void* h, int64_t idx);
int64_t sk_export(void* h, int64_t idx, uint8_t* out, int64_t cap);
void sk_clear_store(void* h, int64_t idx);
int32_t sk_delete_raw(void* h, int64_t idx, const uint8_t* key,
                      int64_t klen);
int32_t sk_insert_raw(void* h, int64_t idx, const uint8_t* key,
                      int64_t klen, const uint8_t* val, int64_t vlen,
                      uint64_t version, double created, double updated);
int64_t sk_snapshot_delta_size(void* h, int64_t idx);
int64_t sk_snapshot_delta(void* h, int64_t idx, uint8_t* out, int64_t cap);
void sk_snapshot_mark(void* h, int64_t idx);
}

static const int64_t kStores = 4;

static void mk_key(uint8_t* k, uint32_t i) {
  memcpy(k, "key-", 4);
  memcpy(k + 4, &i, 4);
}

int main() {
  void* h = sk_plane_create(kStores, 1 << 16, 128, 4096);
  if (!h) {
    std::fprintf(stderr, "sk_plane_create failed\n");
    return 1;
  }
  std::atomic<bool> stop{false};
  std::atomic<long> mutations{0}, hits{0};
  std::atomic<int> fail{0};

  // mutators: each owns two stores (apply-lane stand-in: the restore
  // APIs lock internally exactly like sk_apply_wave does)
  auto mutator = [&](int64_t s0, uint64_t seed) {
    stress::Rng rng(seed);
    uint8_t key[8], val[64];
    uint64_t version = 1;
    while (!stop.load()) {
      const int64_t idx = s0 + (int64_t)rng.below(2);
      mk_key(key, rng.below(512));
      const uint32_t vlen = 8 + rng.below(48);
      memset(val, (int)(version & 0xFF), sizeof(val));
      switch (rng.below(8)) {
        case 0:
          sk_delete_raw(h, idx, key, 8);
          break;
        case 1:
          sk_set_version(h, idx, version);
          break;
        case 2:
          sk_add_stats(h, idx, 3, 2, 1);
          break;
        case 3:
          if ((version & 1023) == 0) sk_clear_store(h, idx);
          break;
        default:
          sk_insert_raw(h, idx, key, 8, val, vlen, version, 1.0, 2.0);
      }
      version++;
      mutations.fetch_add(1);
    }
  };
  std::thread m1(mutator, 0, 31), m2(mutator, 2, 32);

  // bracketed reader: the gateway read-index GET shape — hold the plane
  // lock across the borrow + copy-out
  std::thread reader([&] {
    stress::Rng rng(33);
    uint8_t key[8];
    std::vector<uint8_t> copy;
    std::vector<uint8_t> exp(1 << 20);
    while (!stop.load()) {
      const int64_t idx = (int64_t)rng.below((uint32_t)kStores);
      mk_key(key, rng.below(512));
      sk_plane_lock(h);
      const uint8_t* vp = nullptr;
      uint64_t ver = 0;
      const int64_t vlen = sk_get(h, idx, key, 8, &vp, &ver);
      if (vlen >= 0) {
        copy.assign(vp, vp + vlen);
        // every byte of a value is one fill byte (mutator contract)
        for (int64_t i = 1; i < vlen; i++) {
          if (copy[(size_t)i] != copy[0]) {
            fail.store(1);  // torn value under the bracket: a real race
            break;
          }
        }
        hits.fetch_add(1);
      }
      const int64_t need = sk_export_size(h, idx);
      if (need >= 0 && need <= (int64_t)exp.size())
        sk_export(h, idx, exp.data(), (int64_t)exp.size());
      sk_plane_unlock(h);
      stress::sleep_ms(0);
    }
  });

  // incremental-snapshot lane (durability plane's capture path)
  std::thread snap([&] {
    std::vector<uint8_t> buf(1 << 20);
    stress::Rng rng(34);
    while (!stop.load()) {
      const int64_t idx = (int64_t)rng.below((uint32_t)kStores);
      sk_plane_lock(h);
      const int64_t need = sk_snapshot_delta_size(h, idx);
      if (need > 0 && need <= (int64_t)buf.size()) {
        if (sk_snapshot_delta(h, idx, buf.data(), (int64_t)buf.size()) >= 0)
          sk_snapshot_mark(h, idx);
      }
      sk_plane_unlock(h);
      stress::sleep_ms(1);
    }
  });

  // advisory introspection: the metrics scrape shape (now internally
  // locked; counters read under the bracket like the registry does)
  std::thread intro([&] {
    uint64_t st[3];
    volatile uint64_t sink = 0;
    const int nctrs = sk_counters_count();
    while (!stop.load()) {
      sk_store_count(h);
      for (int64_t i = 0; i < kStores; i++) {
        sk_store_size(h, i);
        sk_store_version(h, i);
        sk_store_stats(h, i, st);
      }
      sk_plane_lock(h);
      sink ^= rabia_stress_advisory_read(
          (const uint64_t*)sk_counters(h), nctrs);
      sk_plane_unlock(h);
      stress::sleep_ms(1);
    }
    (void)sink;
  });

  const double t0 = stress::now_s();
  while (stress::now_s() - t0 < 1.5 && !fail.load()) stress::sleep_ms(20);
  stop.store(true);
  m1.join();
  m2.join();
  reader.join();
  snap.join();
  intro.join();
  sk_plane_destroy(h);
  if (fail.load()) {
    std::fprintf(stderr, "invariant violated: code %d\n", fail.load());
    return 2;
  }
  std::printf("stress ok: %ld mutations, %ld bracketed reads\n",
              mutations.load(), hits.load());
  return (mutations.load() > 1000 && hits.load() > 0) ? 0 : 3;
}
