// Shared scaffolding for the native stress programs (build.py
// STRESS_PROGRAMS; tests/test_torch_native_stress.py runs them).
//
// Conventions every program follows:
//   - exit 0 only when the hammered seam did real work (frame counts,
//     op counts — a stress that silently did nothing must not pass);
//   - all cross-thread coordination in the HARNESS uses atomics or the
//     primitives under test, so a sanitizer report always points at
//     kernel code, not scaffolding;
//   - counter blocks that the Python scrape path reads as plain u64s
//     are read here through rabia_stress_advisory_read — the one vetted
//     TSan suppression (stress/tsan.supp) scoped to exactly that
//     contract.

#ifndef RABIA_STRESS_COMMON_H_
#define RABIA_STRESS_COMMON_H_

#include <time.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <atomic>
#include <chrono>
#include <thread>

namespace stress {

inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

inline void sleep_ms(int ms) {
  std::this_thread::sleep_for(std::chrono::milliseconds(ms));
}

// Tiny deterministic RNG (no libc rand: thread-safe by construction).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  uint32_t below(uint32_t n) { return (uint32_t)(next() % n); }
};

}  // namespace stress

// Advisory read of a native counter block through the same plain-u64
// aliasing the Python scrape path uses (np.frombuffer over the borrowed
// pointer). The cells are relaxed atomics on the writer side; this
// deliberate torn-read contract (docs/OBSERVABILITY.md, RKC) is
// suppressed by name in stress/tsan.supp. Marked noinline so the
// suppression's stack match is stable across optimization levels.
__attribute__((noinline)) inline uint64_t rabia_stress_advisory_read(
    const uint64_t* block, int count) {
  uint64_t acc = 0;
  for (int i = 0; i < count; i++) acc ^= block[i];
  // compiler barrier: keep the loads in this frame
  __asm__ volatile("" ::: "memory");
  return acc;
}

#endif  // RABIA_STRESS_COMMON_H_
