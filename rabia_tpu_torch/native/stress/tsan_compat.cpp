// TSan compatibility shim for gcc toolchains (linked into every TSan
// stress binary by build.py's sanitizer toolchain).
//
// gcc-10's libtsan predates the pthread_cond_clockwait interceptor, but
// libstdc++ on glibc >= 2.30 compiles std::condition_variable::wait_for
// /wait_until<steady_clock> down to exactly that call — so TSan misses
// the mutex release/reacquire inside every timed wait and reports a
// false "double lock of a mutex" on trivially correct code (the root
// cause of the retired environmental SKIP in the old TSan gate; see
// docs/STATIC_ANALYSIS.md).
//
// The shim interposes a strong pthread_cond_clockwait that converts the
// deadline to CLOCK_REALTIME and delegates to pthread_cond_timedwait,
// which every libtsan intercepts. Semantics: identical modulo a
// nanoseconds-wide clock-conversion window (irrelevant for stress
// timeouts); glibc's default condattr clock is REALTIME, matching the
// delegated wait. The kernels themselves never emit clockwait (they
// wait via rabia::CondVar's monotonic pthread_cond_timedwait) — this
// covers libstdc++ internals and test scaffolding only.

#include <pthread.h>
#include <time.h>

extern "C" int pthread_cond_clockwait(pthread_cond_t* cond,
                                      pthread_mutex_t* mu, clockid_t clock,
                                      const struct timespec* abstime) {
  struct timespec now_c, now_r, abs_r;
  clock_gettime(clock, &now_c);
  clock_gettime(CLOCK_REALTIME, &now_r);
  long long rem = (long long)(abstime->tv_sec - now_c.tv_sec) * 1000000000ll +
                  (abstime->tv_nsec - now_c.tv_nsec);
  if (rem < 0) rem = 0;
  const long long tgt =
      (long long)now_r.tv_sec * 1000000000ll + now_r.tv_nsec + rem;
  abs_r.tv_sec = (time_t)(tgt / 1000000000ll);
  abs_r.tv_nsec = (long)(tgt % 1000000000ll);
  return pthread_cond_timedwait(cond, mu, &abs_r);
}
