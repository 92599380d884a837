// Thread-safety annotations + annotated lock primitives for the native
// kernels (docs/STATIC_ANALYSIS.md).
//
// Three layers, all in this one header so every kernel shares one
// vocabulary:
//
// 1. RABIA_* macros wrapping clang's -Wthread-safety attributes
//    (CAPABILITY / GUARDED_BY / REQUIRES / ...). No-ops on gcc, so the
//    default g++ build is unchanged; the CI thread-safety cell compiles
//    every kernel with clang++ -Werror=thread-safety, turning the
//    ownership contracts that used to live in comments (single-writer-
//    while-RUNNING, sk_plane_lock brackets, the WAL flush-thread
//    handoff) into compile failures. This is the repo's analog of the
//    reference's compiler-enforced Send/Sync (PAPER.md §1).
//
// 2. rabia::Mutex / rabia::RecursiveMutex / rabia::CondVar /
//    rabia::MutexLock — thin annotated wrappers over std::mutex /
//    std::recursive_mutex / pthread_cond_t. Two deliberate choices:
//      - the capability attribute lives on OUR type (libstdc++'s
//        std::mutex carries no annotations), so GUARDED_BY actually
//        binds;
//      - CondVar waits via pthread_cond_timedwait on a CLOCK_MONOTONIC
//        condattr instead of libstdc++'s wait_for (which compiles to
//        pthread_cond_clockwait — NOT intercepted by gcc-10's libtsan,
//        the root cause of the old TSan gate's false "double lock of a
//        mutex" on this container's glibc and therefore of its
//        environmental SKIP). Every wait here goes through an
//        interceptable primitive, which is what made the TSan gate
//        enforceable again (native/stress/, scripts/sanitize_gate.py).
//
// 3. A debug lock-order checker, compiled in under
//    -DRABIA_NATIVE_DEBUG=1 (build.py's debug flavor, forced by the
//    RABIA_NATIVE_DEBUG=1 env): every Mutex carries a name; acquires
//    record per-thread held-lock stacks and a global name-pair edge set,
//    and an acquisition that inverts a previously seen order (or
//    re-acquires a non-recursive Mutex already held by the thread)
//    aborts with both stacks' names. Running the fuzz/conformance gates
//    against debug-flavor kernels turns the whole test suite into a
//    lock-order prover. Zero cost in regular builds (the hooks compile
//    away).

#ifndef RABIA_NATIVE_ANNOTATIONS_H_
#define RABIA_NATIVE_ANNOTATIONS_H_

#include <errno.h>
#include <pthread.h>
#include <time.h>

#include <mutex>

#if defined(__clang__)
#define RABIA_TSA(x) __attribute__((x))
#else
#define RABIA_TSA(x)  // no-op on gcc: annotations are clang-only
#endif

#define RABIA_CAPABILITY(x) RABIA_TSA(capability(x))
#define RABIA_SCOPED_CAPABILITY RABIA_TSA(scoped_lockable)
#define RABIA_GUARDED_BY(x) RABIA_TSA(guarded_by(x))
#define RABIA_PT_GUARDED_BY(x) RABIA_TSA(pt_guarded_by(x))
#define RABIA_ACQUIRE(...) RABIA_TSA(acquire_capability(__VA_ARGS__))
#define RABIA_RELEASE(...) RABIA_TSA(release_capability(__VA_ARGS__))
#define RABIA_TRY_ACQUIRE(...) RABIA_TSA(try_acquire_capability(__VA_ARGS__))
#define RABIA_REQUIRES(...) RABIA_TSA(requires_capability(__VA_ARGS__))
#define RABIA_EXCLUDES(...) RABIA_TSA(locks_excluded(__VA_ARGS__))
#define RABIA_ACQUIRED_BEFORE(...) RABIA_TSA(acquired_before(__VA_ARGS__))
#define RABIA_ACQUIRED_AFTER(...) RABIA_TSA(acquired_after(__VA_ARGS__))
#define RABIA_RETURN_CAPABILITY(x) RABIA_TSA(lock_returned(x))
#define RABIA_NO_TSA RABIA_TSA(no_thread_safety_analysis)

// --- debug lock-order checker hooks -----------------------------------------

#if defined(RABIA_NATIVE_DEBUG) && RABIA_NATIVE_DEBUG

#include <stdio.h>
#include <stdlib.h>

#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace rabia_lockorder {

// One edge "name_a held while acquiring name_b", keyed by NAME (the
// class of lock, e.g. "transport.mu"), not by instance: the ordering
// discipline is a property of the code paths, and instance addresses
// recycle. Self-edges (same name, DIFFERENT instance nested) are
// reported too — nesting two peers' same-class locks has no defined
// order and is exactly the two-transport deadlock shape.
struct Held {
  const void* m;
  const char* name;
  bool recursive;
};

inline std::vector<Held>& held_stack() {
  thread_local std::vector<Held> stack;
  return stack;
}

inline std::mutex& reg_mu() {
  static std::mutex mu;  // raw std::mutex: the checker must not recurse
  return mu;
}

// Acquisition-order DIGRAPH: adjacency by lock name. Kept as a graph
// (not a pair set) so cycles of any length are caught — a 3-path
// A->B, B->C, C->A deadlock has no reversed PAIR to match, but C->A
// closes a cycle the reachability walk below sees.
inline std::unordered_map<std::string, std::unordered_set<std::string>>&
edges() {
  static std::unordered_map<std::string, std::unordered_set<std::string>>
      e;
  return e;
}

// Is `to` reachable from `from` over recorded edges? (DFS; graphs here
// are a handful of lock classes, cost is irrelevant.)
inline bool reaches(const std::string& from, const std::string& to) {
  if (from == to) return true;
  std::vector<std::string> work{from};
  std::unordered_set<std::string> seen{from};
  auto& e = edges();
  while (!work.empty()) {
    std::string cur = work.back();
    work.pop_back();
    auto it = e.find(cur);
    if (it == e.end()) continue;
    for (const std::string& nxt : it->second) {
      if (nxt == to) return true;
      if (seen.insert(nxt).second) work.push_back(nxt);
    }
  }
  return false;
}

inline void fail(const char* what, const char* held, const char* acq) {
  fprintf(stderr,
          "rabia lockorder: %s: holding \"%s\" while acquiring \"%s\" "
          "(aborting; run with the regular build to ignore)\n",
          what, held, acq);
  fflush(stderr);
  abort();
}

// Runs BEFORE the underlying pthread lock: a same-thread re-acquire of
// a non-recursive mutex must ABORT with a report, not deadlock
// silently inside pthread_mutex_lock; an order inversion is likewise
// best reported before this thread parks on the about-to-deadlock
// acquire.
inline void prelock(const void* m, const char* name, bool recursive) {
  auto& stack = held_stack();
  for (const Held& h : stack) {
    if (h.m == m) {
      if (recursive) return;  // recursive re-acquire: no new edges
      fail("double lock", h.name, name);
    }
  }
  std::lock_guard<std::mutex> lk(reg_mu());
  for (const Held& h : stack) {
    if (h.m == m) continue;
    // adding edge h.name -> name: if name already REACHES h.name the
    // new edge closes a cycle (length 2 = classic pairwise inversion,
    // length >= 3 = the multi-thread deadlock a pair check misses)
    if (reaches(name, h.name)) fail("order inversion", h.name, name);
    edges()[h.name].insert(name);
  }
}

inline void acquired(const void* m, const char* name, bool recursive) {
  held_stack().push_back(Held{m, name, recursive});
}

inline void released(const void* m) {
  auto& stack = held_stack();
  // released in any order: erase the LAST matching entry
  for (size_t i = stack.size(); i-- > 0;) {
    if (stack[i].m == m) {
      stack.erase(stack.begin() + (ptrdiff_t)i);
      return;
    }
  }
}

}  // namespace rabia_lockorder

#define RABIA_LOCKORDER_PRELOCK(m, name, rec) \
  ::rabia_lockorder::prelock((m), (name), (rec))
#define RABIA_LOCKORDER_ACQUIRED(m, name, rec) \
  ::rabia_lockorder::acquired((m), (name), (rec))
#define RABIA_LOCKORDER_RELEASED(m) ::rabia_lockorder::released((m))

#else  // !RABIA_NATIVE_DEBUG

#define RABIA_LOCKORDER_PRELOCK(m, name, rec) ((void)0)
#define RABIA_LOCKORDER_ACQUIRED(m, name, rec) ((void)0)
#define RABIA_LOCKORDER_RELEASED(m) ((void)0)

#endif  // RABIA_NATIVE_DEBUG

namespace rabia {

// Annotated mutex. The name is the lock-order class (debug builds) and
// the human handle in checker reports; keep it "<kernel>.<field>".
class RABIA_CAPABILITY("mutex") Mutex {
 public:
  explicit Mutex(const char* name = "mutex") : name_(name) {}
  Mutex(const Mutex&) = delete;
  Mutex& operator=(const Mutex&) = delete;

  void lock() RABIA_ACQUIRE() {
    RABIA_LOCKORDER_PRELOCK(this, name_, false);
    mu_.lock();
    RABIA_LOCKORDER_ACQUIRED(this, name_, false);
  }
  void unlock() RABIA_RELEASE() {
    RABIA_LOCKORDER_RELEASED(this);
    mu_.unlock();
  }
  bool try_lock() RABIA_TRY_ACQUIRE(true) {
    RABIA_LOCKORDER_PRELOCK(this, name_, false);
    if (!mu_.try_lock()) return false;
    RABIA_LOCKORDER_ACQUIRED(this, name_, false);
    return true;
  }
  pthread_mutex_t* native_handle() { return mu_.native_handle(); }
  const char* name() const { return name_; }

 private:
  std::mutex mu_;
  const char* name_;
};

// Annotated recursive mutex (statekernel's plane lock: a locked reader
// may call entry points that lock internally).
class RABIA_CAPABILITY("mutex") RecursiveMutex {
 public:
  explicit RecursiveMutex(const char* name = "recursive_mutex")
      : name_(name) {}
  RecursiveMutex(const RecursiveMutex&) = delete;
  RecursiveMutex& operator=(const RecursiveMutex&) = delete;

  void lock() RABIA_ACQUIRE() {
    RABIA_LOCKORDER_PRELOCK(this, name_, true);
    mu_.lock();
    RABIA_LOCKORDER_ACQUIRED(this, name_, true);
  }
  void unlock() RABIA_RELEASE() {
    RABIA_LOCKORDER_RELEASED(this);
    mu_.unlock();
  }
  const char* name() const { return name_; }

 private:
  std::recursive_mutex mu_;
  const char* name_;
};

// Scoped guard (std::lock_guard twin the analysis understands).
class RABIA_SCOPED_CAPABILITY MutexLock {
 public:
  explicit MutexLock(Mutex& mu) RABIA_ACQUIRE(mu) : mu_(mu) { mu_.lock(); }
  ~MutexLock() RABIA_RELEASE() { mu_.unlock(); }
  MutexLock(const MutexLock&) = delete;
  MutexLock& operator=(const MutexLock&) = delete;

  Mutex& mutex() { return mu_; }

 private:
  friend class CondVar;
  Mutex& mu_;
};

class RABIA_SCOPED_CAPABILITY RecursiveLock {
 public:
  explicit RecursiveLock(RecursiveMutex& mu) RABIA_ACQUIRE(mu) : mu_(mu) {
    mu_.lock();
  }
  ~RecursiveLock() RABIA_RELEASE() { mu_.unlock(); }
  RecursiveLock(const RecursiveLock&) = delete;
  RecursiveLock& operator=(const RecursiveLock&) = delete;

 private:
  RecursiveMutex& mu_;
};

// Condition variable over rabia::Mutex. Deliberately pthread-level with
// a CLOCK_MONOTONIC condattr: timed waits go through
// pthread_cond_timedwait (intercepted by every libtsan we target),
// never pthread_cond_clockwait (not intercepted by gcc-10's — see the
// header comment). Waits keep the capability held from the analysis'
// point of view, matching clang's std::condition_variable model.
class CondVar {
 public:
  CondVar() {
    pthread_condattr_t attr;
    pthread_condattr_init(&attr);
    pthread_condattr_setclock(&attr, CLOCK_MONOTONIC);
    pthread_cond_init(&cv_, &attr);
    pthread_condattr_destroy(&attr);
  }
  ~CondVar() { pthread_cond_destroy(&cv_); }
  CondVar(const CondVar&) = delete;
  CondVar& operator=(const CondVar&) = delete;

  void notify_one() { pthread_cond_signal(&cv_); }
  void notify_all() { pthread_cond_broadcast(&cv_); }

  void wait(MutexLock& lk) { pthread_cond_wait(&cv_, handle(lk)); }

  // Deadline helpers for explicit wait loops. Predicate lambdas are
  // deliberately NOT offered: clang's thread-safety analysis treats a
  // lambda body as an unannotated function, so guarded-field reads
  // inside one would need NO_TSA escapes — an explicit
  //   timespec dl = CondVar::deadline_in(seconds);
  //   while (<predicate on guarded fields>)
  //     if (!cv.wait_until(lk, dl)) break;
  // loop keeps every guarded access visible to the analysis.
  static timespec deadline_in(double seconds) {
    timespec dl;
    clock_gettime(CLOCK_MONOTONIC, &dl);
    const long long add_ns = seconds > 0 ? (long long)(seconds * 1e9) : 0;
    long long tgt =
        (long long)dl.tv_sec * 1000000000ll + dl.tv_nsec + add_ns;
    dl.tv_sec = (time_t)(tgt / 1000000000ll);
    dl.tv_nsec = (long)(tgt % 1000000000ll);
    return dl;
  }

  // Absolute-deadline wait; returns false on timeout (spurious wakes
  // return true — the caller's loop re-checks its predicate).
  bool wait_until(MutexLock& lk, const timespec& deadline) {
    return pthread_cond_timedwait(&cv_, handle(lk), &deadline) != ETIMEDOUT;
  }

 private:
  // pthread-level wait releases + reacquires the mutex without the
  // wrapper hooks seeing it: the thread's held set is unchanged at
  // return, so the lock-order stack stays accurate without bracketing.
  static pthread_mutex_t* handle(MutexLock& lk) {
    return lk.mu_.native_handle();
  }
  pthread_cond_t cv_;
};

// Capability with no runtime state, modelling a THREAD ROLE (runtime.cpp
// io-thread ownership: "only the io/tick thread touches this while
// RUNNING"). Functions that must run on the role's thread are annotated
// RABIA_REQUIRES(role); the thread entry acquires it via the assert
// helper (a no-op at runtime — the handshake that actually transfers
// ownership is rtm_pause/rtm_resume, stress-checked under TSan).
class RABIA_CAPABILITY("role") ThreadRole {
 public:
  explicit ThreadRole(const char* name = "role") : name_(name) {}
  // assert_held: tells the analysis this thread holds the role without
  // emitting code (clang models it via assert_capability).
  void assert_held() const RABIA_TSA(assert_capability(this)) {}
  const char* name() const { return name_; }

 private:
  const char* name_;
};

}  // namespace rabia

#endif  // RABIA_NATIVE_ANNOTATIONS_H_
