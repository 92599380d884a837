// TCP transport data plane: epoll loop, framing, handshake, reconnect.
//
// Native equivalent of the reference's TcpNetwork (rabia-engine/src/network/
// tcp.rs, SURVEY.md C17), exposed to Python through a C API consumed via
// ctypes (rabia_tpu_torch/net/tcp.py). Wire compatibility points:
//   - frames: u32 little-endian length prefix + payload, 16 MiB cap
//     (tcp.rs:86,125);
//   - handshake: each side sends its 16-byte node id immediately after
//     connect; a connection is "established" once both ids crossed
//     (tcp.rs:384-413,527-557);
//   - dial with exponential backoff: 5 attempts, 100ms base, x2 growth,
//     30s cap (tcp.rs:54-72), then periodic re-dial while the peer stays
//     configured (keepalive scan, tcp.rs:661-684);
//   - per-peer outbound queues; broadcast = enqueue to every established
//     peer (tcp.rs:771-789).
//
// Threading model: ONE io thread owns all sockets and epoll; callers
// enqueue sends under a mutex and kick an eventfd; inbound frames land in a
// deque the Python side drains (blocking with timeout via condvar). No
// Python/GIL involvement inside the io loop.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <time.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include "annotations.h"  // RABIA_* thread-safety macros + rabia::Mutex
#include "transport.h"  // the C ABI — definitions below are checked against it

namespace {

constexpr uint32_t kMaxFrame = 16u * 1024u * 1024u;  // 16 MiB (tcp.rs:86)
// Inbox bound: a fast peer with a slow Python drain must not grow memory
// without limit. Beyond the cap the OLDEST frame is dropped (consensus
// retransmits supersede stale votes) and dropped_frames counts it.
constexpr size_t kMaxInbox = 65536;
constexpr int kMaxDialAttempts = 5;                  // tcp.rs:57
// Session multiplexing (the gateway's client-scaling lane): a peer that
// handshakes with this magic id runs MANY sessions over ONE connection.
// Every subsequent frame on a muxed connection carries a 16-byte session
// id prefix inside the payload: inbound, the prefix becomes the sender
// id (the gateway authenticates the embedded client id against it, same
// trust model as the self-declared handshake id); outbound, rt_send to a
// session id bound on a muxed connection wraps the frame with the
// prefix so the client side can demultiplex. 10^4 client sessions then
// cost a handful of sockets (and loadgen reader tasks) instead of 10^4.
constexpr uint8_t kMuxMagic[16] = {0xF5, 'R', 'A', 'B', 'I', 'A', '-',
                                   'M',  'U', 'X', 0xF5, 0xF5, 0xF5,
                                   0xF5, 0xF5, 0xF5};
constexpr double kDialBaseDelayS = 0.1;              // tcp.rs:58
constexpr double kDialMaxDelayS = 30.0;              // tcp.rs:60
constexpr double kRedialPeriodS = 10.0;              // keepalive scan period
constexpr double kStashTtlS = 10.0;  // stranded-frame redelivery window
// stranded frames kept per peer for a send with no conn to ride
constexpr size_t kMaxStash = 4096;
constexpr size_t kMaxStashBytes = 64u << 20;

using Clock = std::chrono::steady_clock;

// Observability counter block (rt_counters). Indices are ABI: append new
// counters before RTC_COUNT and bump kCountersVersion; never renumber.
enum : int32_t {
  RTC_FRAMES_IN = 0,     // inbound frames parsed off sockets
  RTC_BYTES_IN,          // inbound payload bytes
  RTC_FRAMES_OUT,        // frames enqueued to peer connections
  RTC_BYTES_OUT,         // framed bytes enqueued (incl. 4B prefix)
  RTC_INBOX_DROPPED,     // frames dropped by the bounded inbox
  RTC_OUT_POOL_HITS,     // outbound frame arena reuse hits
  RTC_OUT_POOL_MISSES,   // outbound frame arena allocations
  RTC_IN_POOL_HITS,      // inbound buffer arena reuse hits
  RTC_IN_POOL_MISSES,    // inbound buffer arena allocations
  RTC_BORROWS,           // zero-copy frames handed out (rt_recv_borrow)
  RTC_DIALS,             // outbound connection attempts (incl. redials)
  RTC_CONNS_ESTABLISHED, // handshakes completed into `established`
  RTC_CONNS_CLOSED,      // established connections torn down
  // -- chaos shaping layer (rt_set_shaping, v2) ------------------------
  RTC_SHAPE_DROPPED,     // outbound frames dropped by per-peer shaping
  RTC_SHAPE_DELAYED,     // outbound frames held in the delay queue
  RTC_GROUP_FRAMES,      // frames delivered through per-group inboxes
                         // (fan-out counted: one frame to 2 groups = 2)
  RTC_GROUP_COPIES,      // extra buffer copies for multi-group frames
  RTC_COUNT
};
constexpr int32_t kCountersVersion = 3;

// Flight recorder: one compact record per frame in/out, so a transport
// stall is attributable after the fact (the engine's flight merger folds
// these between the consensus-event records). Layout is a versioned ABI
// like the RTC_* block; the Python twin is rabia_tpu_torch/net/tcp.TF_DTYPE.
struct TfEvent {
  uint64_t t_ns;      // CLOCK_MONOTONIC (same domain as the rk flight ring)
  uint64_t peer;      // last 8 bytes of the peer's 16-byte node id
  uint32_t len;       // payload length (sans the 4-byte prefix)
  uint8_t dir;        // 0 = in (parsed off a socket), 1 = out (enqueued)
  uint8_t msg_type;   // wire byte 1 of the payload (the v3 msg_type)
  uint16_t pad;
};
static_assert(sizeof(TfEvent) == 24, "transport flight record is ABI");
constexpr int32_t kFlightVersion = 1;
constexpr uint32_t kFlightCap = 4096;  // power of two

uint64_t tf_now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

using NodeIdBytes = std::array<uint8_t, 16>;

struct InboundMsg {
  NodeIdBytes sender;
  std::vector<uint8_t> data;
};

struct Conn {
  int fd = -1;
  NodeIdBytes peer{};          // zero until handshake completes
  bool handshaken_in = false;  // peer id received
  bool handshake_sent = false;
  bool outbound = false;       // we dialed (vs accepted)
  // simultaneous-dial duplicate that lost the deterministic tiebreak:
  // no longer in `established` (new sends use the winner) but kept
  // open to DRAIN — queued writes flush, then the write side
  // half-closes; inbound frames keep delivering until the peer's
  // symmetric shutdown EOFs the socket. An immediate ::close() here
  // used to drop any frame in flight on the loser during the
  // handshake race window (both sides briefly hold only the doomed
  // connection), surfacing as a rare receive timeout under CPU load.
  bool draining = false;
  bool shut_wr = false;        // SHUT_WR already issued
  // session-multiplexed connection (handshake id == kMuxMagic): never
  // enters `established`/peer dedup; frames carry 16-byte session ids
  bool mux = false;
  double drain_deadline = 0.0;  // hard close if the peer never EOFs
  // the raw 16-byte handshake id is ALWAYS the first wqueue element
  // and is NOT length-prefixed: it must never be re-routed/stashed as
  // a frame (the receiver would parse its first 4 bytes as a length
  // and poison the winner connection). True until that first element
  // fully flushes.
  bool hs_in_queue = false;
  NodeIdBytes dial_target{};   // peer we dialed (valid when outbound)
  std::vector<uint8_t> rbuf;
  // framed bytes pending write. Shared: one broadcast frame is queued on
  // every peer's connection without copies (recycled to the outbound
  // arena when the last reference completes).
  std::deque<std::shared_ptr<std::vector<uint8_t>>> wqueue;
  size_t woff = 0;  // offset into *wqueue.front()
};

// Per-shard-group inbox (the thread-per-shard-group runtime): the io
// loop classifies each inbound frame by the shard groups it carries
// (rt_set_groups installs the classifier — runtime.cpp's
// rtm_frame_group_mask) and delivers to each flagged group's own queue,
// so N runtime workers pull frames without contending one lock per
// frame. Each GroupInbox has its OWN mutex/condvar: the io thread takes
// it briefly at delivery (lock order: Transport::mu -> gmu), a worker
// takes only its group's — workers never touch the transport-wide `mu`
// on the frame path. Borrowed frames and their recycled buffers are
// group-local; the io thread sweeps `recycle` back into the shared
// arena at its next delivery to that group.
struct GroupInbox {
  rabia::Mutex gmu{"transport.group"};
  rabia::CondVar cv;
  // rt_inbox_kick spurious-wake generation, mirroring the main inbox
  std::atomic<uint64_t> kick_gen{0};
  std::deque<InboundMsg> q RABIA_GUARDED_BY(gmu);
  std::map<int64_t, std::vector<uint8_t>> borrowed RABIA_GUARDED_BY(gmu);
  int64_t next_token RABIA_GUARDED_BY(gmu) = 1;
  std::vector<std::vector<uint8_t>> recycle RABIA_GUARDED_BY(gmu);
};

// classifier: returns a bitmask of groups a frame must reach (bit g =
// deliver to group g); 0 means "group 0" (control/unparseable frames)
typedef uint64_t (*rt_classify_t)(void*, const uint8_t*, uint32_t);

struct Peer {
  std::string host;
  uint16_t port = 0;
  int attempts = 0;
  double next_dial = 0.0;
  bool connected = false;
  // frames stranded on a connection that died before flushing, kept
  // briefly for the next established connection to this peer (the
  // simultaneous-dial duplicate teardown can EOF the loser while our
  // frame is still in its wqueue and before the winner has finished
  // its handshake — dropping there breaks "send after is_connected
  // delivers" even though the peer is up). Expired by kStashTtlS.
  std::deque<std::shared_ptr<std::vector<uint8_t>>> stash;
  size_t stash_bytes = 0;
  double stash_t = 0.0;
};

struct Transport {
  NodeIdBytes self_id{};
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;
  uint16_t port = 0;

  std::thread io_thread;
  std::atomic<bool> stopping{false};

  rabia::Mutex mu{"transport.mu"};  // guards everything below
  std::map<int, Conn> conns RABIA_GUARDED_BY(mu);       // fd -> conn
  std::map<NodeIdBytes, int> established RABIA_GUARDED_BY(mu);
  std::map<NodeIdBytes, Peer> peers RABIA_GUARDED_BY(mu);  // dial targets
  // session id -> fd of the muxed connection carrying it (auto-bound on
  // the first inbound frame bearing the id; latest binding wins, so a
  // session migrating to a fresh connection reroutes its replies)
  std::map<NodeIdBytes, int> mux_sessions RABIA_GUARDED_BY(mu);
  std::deque<InboundMsg> inbox RABIA_GUARDED_BY(mu);
  rabia::CondVar inbox_cv;
  // per-shard-group inboxes (0 = routing off, the single legacy inbox).
  // `groups` entries are stable once created: rt_set_groups only runs
  // while no worker thread is inside a _group call (the runtime bridge
  // installs routing before rtm_start and clears it after rtm_stop), and
  // the vector never shrinks, so workers index it without `mu`.
  std::atomic<int32_t> ngroups{0};
  std::vector<std::unique_ptr<GroupInbox>> groups;
  rt_classify_t classify RABIA_GUARDED_BY(mu) = nullptr;
  void* classify_arg RABIA_GUARDED_BY(mu) = nullptr;
  // rt_inbox_kick: spurious-wake generation counter. A waiter samples it
  // before waiting and also wakes when it changes (see rt_recv_borrow),
  // so a kick staged between the sample and the wait is never lost.
  std::atomic<uint64_t> kick_gen{0};
  uint64_t dropped_frames RABIA_GUARDED_BY(mu) = 0;
  // Zero-copy recv: frames handed out by rt_recv_borrow are parked here
  // (keyed by token) so their pooled buffers outlive the C call until
  // the borrower releases them. std::map: references stay valid across
  // inserts/erases of other keys.
  std::map<int64_t, std::vector<uint8_t>> borrowed RABIA_GUARDED_BY(mu);
  int64_t next_borrow_token RABIA_GUARDED_BY(mu) = 1;
  // Released tokens are STAGED under this light mutex and reclaimed by
  // the next rt_recv_borrow (which holds `mu` anyway). rt_recv_release
  // is called from the engine's event-loop thread once per consumed
  // frame — taking `mu` there would serialize the consensus tick with
  // whole io-loop epoll batches (the same reason rt_send stages under
  // `mu_out` instead of touching `mu`).
  rabia::Mutex mu_rel{"transport.mu_rel"};
  std::vector<int64_t> released RABIA_GUARDED_BY(mu_rel);

  // Outbound staging: rt_send/rt_broadcast never touch `mu` (the io loop
  // holds it across whole epoll batches, syscalls included — a sending
  // engine thread must not stall behind them). Frames are framed once,
  // staged here under the cheap `mu_out`, and drained into per-conn
  // queues by the io thread. Best-effort semantics: a frame staged for a
  // peer that is gone at drain time is dropped, exactly like the
  // reference's sends to disconnected peers (tcp.rs:559-643).
  struct OutMsg {
    std::shared_ptr<std::vector<uint8_t>> frame;
    bool broadcast = false;
    NodeIdBytes target{};
  };
  rabia::Mutex mu_out{"transport.mu_out"};
  std::deque<OutMsg> outq RABIA_GUARDED_BY(mu_out);
  // outbound frame arena
  std::vector<std::vector<uint8_t>> out_pool RABIA_GUARDED_BY(mu_out);
  uint64_t out_hits RABIA_GUARDED_BY(mu_out) = 0;
  uint64_t out_misses RABIA_GUARDED_BY(mu_out) = 0;

  // Chaos shaping layer (rt_set_shaping): per-peer outbound delay/drop
  // injection, applied by the io thread at drain time so the REAL
  // epoll/TCP path carries the shaped traffic (the chaos plane's
  // adverse-network profiles exercise the production C runtime, not a
  // simulator stand-in). Guarded by `mu` (drain_out_locked holds it).
  // Mux client sessions are never shaped — shaping targets replica
  // peers by node id.
  struct Shape {
    uint32_t delay_us = 0;
    uint32_t jitter_us = 0;
    double drop = 0.0;
  };
  std::map<NodeIdBytes, Shape> shaping RABIA_GUARDED_BY(mu);
  struct Delayed {
    double due;
    std::shared_ptr<std::vector<uint8_t>> frame;
    NodeIdBytes target;
    bool operator>(const Delayed& o) const { return due > o.due; }
  };
  std::priority_queue<Delayed, std::vector<Delayed>, std::greater<Delayed>>
      delayq RABIA_GUARDED_BY(mu);
  uint64_t shape_rng RABIA_GUARDED_BY(mu) = 0x9E3779B97F4A7C15ull;

  static inline uint64_t xs64(uint64_t& s) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  double shape_rand01() RABIA_REQUIRES(mu) {  // uniform [0,1), 53-bit
    return (double)(xs64(shape_rng) >> 11) * (1.0 / 9007199254740992.0);
  }

  // Apply the peer's shape to one frame destined for `id` (established
  // fd `fd`): returns true when the frame was consumed (dropped or
  // queued for later delivery), false when the caller should enqueue it
  // now. Caller holds `mu`.
  bool shape_outbound(const NodeIdBytes& id, int fd, double now,
                      const std::shared_ptr<std::vector<uint8_t>>& f)
      RABIA_REQUIRES(mu) {
    (void)fd;
    if (shaping.empty()) return false;
    auto it = shaping.find(id);
    if (it == shaping.end()) return false;
    const Shape& sh = it->second;
    if (sh.drop > 0.0 && shape_rand01() < sh.drop) {
      bump(RTC_SHAPE_DROPPED);
      return true;
    }
    if (sh.delay_us == 0 && sh.jitter_us == 0) return false;
    double d_us = (double)sh.delay_us;
    if (sh.jitter_us)
      d_us += (shape_rand01() * 2.0 - 1.0) * (double)sh.jitter_us;
    if (d_us <= 0.0) return false;  // jitter-only draws clamp at "now"
    delayq.push(Delayed{now + d_us * 1e-6, f, id});
    bump(RTC_SHAPE_DELAYED);
    return true;
  }

  // Release delayed frames whose due time passed; returns the epoll
  // timeout (ms) until the next one is due (capped by `base_ms`).
  // Caller holds `mu`.
  int release_delayed(double now, int base_ms) RABIA_REQUIRES(mu) {
    while (!delayq.empty() && delayq.top().due <= now) {
      Delayed d = delayq.top();
      delayq.pop();
      auto est = established.find(d.target);
      if (est != established.end()) {
        enqueue_shared_locked(est->second, d.frame);
      }
      // peer gone at release time: best-effort drop, exactly like an
      // unshaped frame staged for a disconnected peer
    }
    if (delayq.empty()) return base_ms;
    int ms = (int)((delayq.top().due - now) * 1e3) + 1;
    if (ms < 1) ms = 1;
    return ms < base_ms ? ms : base_ms;
  }

  // observability counter block (RTC_*), exposed raw via rt_counters.
  // Relaxed atomics: multi-writer (io thread + caller threads), read
  // lock-free by the Python scrape path; std::atomic<uint64_t> is
  // layout-compatible with uint64_t for that zero-copy read.
  std::atomic<uint64_t> ctrs[RTC_COUNT];
  static_assert(sizeof(std::atomic<uint64_t>) == sizeof(uint64_t),
                "counter block must read as a plain uint64 array");

  void bump(int32_t i, uint64_t n = 1) {
    ctrs[i].fetch_add(n, std::memory_order_relaxed);
  }

  // flight-recorder frame ring; all writers hold `mu` (handle_readable /
  // enqueue_shared_locked), rt_flight_copy reads under `mu` too
  std::vector<TfEvent> tf RABIA_GUARDED_BY(mu) =
      std::vector<TfEvent>(kFlightCap);
  uint64_t tf_head RABIA_GUARDED_BY(mu) = 0;

  void tf_rec(uint8_t dir, const NodeIdBytes& peer_id, uint32_t len,
              uint8_t msg_type) RABIA_REQUIRES(mu) {
    TfEvent& e = tf[tf_head & (kFlightCap - 1)];
    e.t_ns = tf_now_ns();
    memcpy(&e.peer, peer_id.data() + 8, 8);
    e.len = len;
    e.dir = dir;
    e.msg_type = msg_type;
    e.pad = 0;
    tf_head++;
  }

  std::shared_ptr<std::vector<uint8_t>> make_frame(const uint8_t* data,
                                                   uint32_t len) {
    std::vector<uint8_t> v;
    {
      rabia::MutexLock lo(mu_out);
      if (!out_pool.empty()) {
        v = std::move(out_pool.back());
        out_pool.pop_back();
        v.clear();
        out_hits++;
        bump(RTC_OUT_POOL_HITS);
      } else {
        out_misses++;
        bump(RTC_OUT_POOL_MISSES);
      }
    }
    v.reserve(4 + len);
    v.resize(4 + len);
    v[0] = len & 0xFF;
    v[1] = (len >> 8) & 0xFF;
    v[2] = (len >> 16) & 0xFF;
    v[3] = (len >> 24) & 0xFF;
    memcpy(v.data() + 4, data, len);
    return std::make_shared<std::vector<uint8_t>>(std::move(v));
  }

  void recycle_frame(std::shared_ptr<std::vector<uint8_t>>&& sp) {
    if (sp.use_count() != 1) return;  // other conns still sending it
    rabia::MutexLock lo(mu_out);
    if (out_pool.size() < kMaxPooled && sp->capacity() <= kMaxPooledBuf) {
      out_pool.push_back(std::move(*sp));
    }
  }

  void kick() {
    uint64_t one = 1;
    (void)!::write(wake_fd, &one, 8);
  }

  // buffer arena (rabia-core/src/memory_pool.rs analog): frame/message
  // byte vectors are recycled instead of allocated per frame. Guarded by
  // mu like everything else.
  std::vector<std::vector<uint8_t>> buf_pool RABIA_GUARDED_BY(mu);
  uint64_t pool_hits RABIA_GUARDED_BY(mu) = 0;
  uint64_t pool_misses RABIA_GUARDED_BY(mu) = 0;
  static constexpr size_t kMaxPooled = 256;

  std::vector<uint8_t> pool_get_locked(size_t need) RABIA_REQUIRES(mu) {
    if (!buf_pool.empty()) {
      std::vector<uint8_t> v = std::move(buf_pool.back());
      buf_pool.pop_back();
      v.clear();
      v.reserve(need);
      pool_hits++;
      bump(RTC_IN_POOL_HITS);
      return v;
    }
    pool_misses++;
    bump(RTC_IN_POOL_MISSES);
    std::vector<uint8_t> v;
    v.reserve(need);
    return v;
  }

  // retain only small buffers: consensus traffic is KB-scale; parking
  // snapshot-sized (up to 16 MiB) buffers would pin gigabytes for the
  // process lifetime
  static constexpr size_t kMaxPooledBuf = 256 * 1024;

  void pool_put_locked(std::vector<uint8_t>&& v) RABIA_REQUIRES(mu) {
    if (buf_pool.size() < kMaxPooled && v.capacity() <= kMaxPooledBuf) {
      buf_pool.push_back(std::move(v));
    }
  }

  void io_loop() RABIA_EXCLUDES(mu);
  void handle_readable(int fd) RABIA_REQUIRES(mu);
  void deliver_groups_locked(InboundMsg&& m, int32_t ng) RABIA_REQUIRES(mu);
  void handle_writable(int fd) RABIA_REQUIRES(mu);
  void try_dials() RABIA_REQUIRES(mu);
  void drain_shutdown(int fd, Conn& c) RABIA_REQUIRES(mu);
  void sweep_draining() RABIA_REQUIRES(mu);
  void dial(const NodeIdBytes& id, Peer& p) RABIA_REQUIRES(mu);
  void close_conn(int fd) RABIA_REQUIRES(mu);
  // false: conn was dropped (dup loser)
  bool establish(int fd, Conn& c) RABIA_REQUIRES(mu);
  void enqueue_shared_locked(
      int fd, const std::shared_ptr<std::vector<uint8_t>>& f)
      RABIA_REQUIRES(mu);
  void drain_out_locked() RABIA_REQUIRES(mu) RABIA_EXCLUDES(mu_out);
  void arm_write(int fd, bool on) RABIA_REQUIRES(mu);
};

int set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void Transport::arm_write(int fd, bool on) RABIA_REQUIRES(mu) {
  epoll_event ev{};
  ev.events = EPOLLIN | (on ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(epoll_fd, EPOLL_CTL_MOD, fd, &ev);
}

void Transport::close_conn(int fd) RABIA_REQUIRES(mu) {
  auto it = conns.find(fd);
  if (it == conns.end()) return;
  Conn& c = it->second;
  if (c.hs_in_queue && !c.wqueue.empty()) {
    // the raw handshake id is not a frame — never re-route it
    c.wqueue.pop_front();
    c.woff = 0;
    c.hs_in_queue = false;
  }
  if (c.mux) {
    // unbind every session riding this connection; a session that
    // redials (or already rebound to a newer conn) re-binds on its
    // first inbound frame there
    for (auto it = mux_sessions.begin(); it != mux_sessions.end();) {
      if (it->second == fd)
        it = mux_sessions.erase(it);
      else
        ++it;
    }
  }
  if (c.handshaken_in && !c.mux && !c.wqueue.empty()) {
    // undelivered frames must not die with the socket when the peer is
    // still reachable: re-route whole frames to the established winner
    // (a partially written front frame arrives truncated and is
    // discarded by the peer's length-prefix parser, so re-sending the
    // whole frame cannot duplicate), or stash them briefly for the
    // next connection when the winner's handshake hasn't finished yet.
    auto est = established.find(c.peer);
    if (est != established.end() && est->second != fd) {
      auto wit = conns.find(est->second);
      if (wit != conns.end()) {
        for (auto& f : c.wqueue)
          wit->second.wqueue.push_back(std::move(f));
        arm_write(est->second, true);
        c.wqueue.clear();
      }
    }
    if (!c.wqueue.empty()) {
      auto p = peers.find(c.peer);
      if (p != peers.end()) {
        for (auto& f : c.wqueue) {
          p->second.stash_bytes += f->size();
          p->second.stash.push_back(std::move(f));
        }
        p->second.stash_t = now_s();
        c.wqueue.clear();
      }
    }
  }
  if (c.handshaken_in) {
    auto est = established.find(c.peer);
    if (est != established.end() && est->second == fd) {
      established.erase(est);
      bump(RTC_CONNS_CLOSED);
      auto p = peers.find(c.peer);
      if (p != peers.end()) {
        p->second.connected = false;
        p->second.attempts = 0;
        p->second.next_dial = now_s() + kDialBaseDelayS;
      }
    }
  }
  epoll_ctl(epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
  conns.erase(it);
}

bool Transport::establish(int fd, Conn& c) RABIA_REQUIRES(mu) {
  auto old = established.find(c.peer);
  if (old != established.end() && old->second != fd) {
    // simultaneous-dial duplicate: BOTH sides must deterministically keep
    // the same connection or they flap (each closing the one the other
    // kept). Rule: the connection dialed by the smaller node id wins.
    // The loser is DRAINED, not closed (see Conn::draining): frames a
    // peer sent on it during the race window must still deliver, and
    // our queued writes on it must still flush.
    auto initiator = [&](const Conn& conn) -> const NodeIdBytes& {
      return conn.outbound ? self_id : conn.peer;
    };
    int old_fd = old->second;
    Conn& oldc = conns[old_fd];
    bool new_wins = initiator(c) < initiator(oldc);
    Conn& loser = new_wins ? oldc : c;
    int loser_fd = new_wins ? old_fd : fd;
    loser.draining = true;
    loser.drain_deadline = now_s() + kRedialPeriodS;
    drain_shutdown(loser_fd, loser);
    if (!new_wins) return false;  // c lives on, draining
    established.erase(old);
  }
  established[c.peer] = fd;
  bump(RTC_CONNS_ESTABLISHED);
  auto p = peers.find(c.peer);
  if (p != peers.end()) {
    p->second.connected = true;
    p->second.attempts = 0;
    if (!p->second.stash.empty()) {
      // frames stranded by a dying duplicate connection: deliver on
      // this one unless the redelivery window lapsed (a long-dead peer
      // should not receive stale protocol frames on reconnect —
      // consensus retransmission owns that timescale)
      bool fresh = now_s() - p->second.stash_t <= kStashTtlS;
      for (auto& f : p->second.stash) {
        if (fresh) c.wqueue.push_back(std::move(f));
      }
      p->second.stash.clear();
      p->second.stash_bytes = 0;
      if (fresh) arm_write(fd, true);
    }
  }
  return true;
}

void Transport::drain_shutdown(int fd, Conn& c) RABIA_REQUIRES(mu) {
  // half-close a draining loser once its queued writes flushed; the
  // peer (running the same rule) does the same, and each side closes
  // on the other's EOF — no frame in either direction is dropped
  if (c.draining && !c.shut_wr && c.wqueue.empty()) {
    ::shutdown(fd, SHUT_WR);
    c.shut_wr = true;
  }
}

void Transport::sweep_draining() RABIA_REQUIRES(mu) {
  // a draining peer that crashed mid-drain never EOFs us; reap on the
  // deadline (same period as the redial scan)
  double t = now_s();
  std::vector<int> overdue;
  for (auto& [fd, c] : conns) {
    if (c.draining && t >= c.drain_deadline) overdue.push_back(fd);
  }
  for (int fd : overdue) close_conn(fd);
}

void Transport::handle_readable(int fd) RABIA_REQUIRES(mu) {
  auto it = conns.find(fd);
  if (it == conns.end()) return;
  Conn& c = it->second;
  uint8_t buf[64 * 1024];
  // EOF or a socket error ends the read, but the conn closes only after
  // the frames already read are parsed and delivered: a draining dup
  // loser half-closes right after its last frame flushes, so that frame
  // and the FIN often arrive in one readable event, and closing on the
  // FIN before parsing dropped it (the dup-race receive timeout)
  bool eof = false;
  for (;;) {
    ssize_t n = ::recv(fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c.rbuf.insert(c.rbuf.end(), buf, buf + n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      eof = true;
      break;
    }
  }
  size_t off = 0;
  // handshake: first 16 bytes are the peer's node id
  if (!c.handshaken_in) {
    if (c.rbuf.size() < 16) {
      if (eof) close_conn(fd);
      return;
    }
    memcpy(c.peer.data(), c.rbuf.data(), 16);
    c.handshaken_in = true;
    off = 16;
    if (memcmp(c.peer.data(), kMuxMagic, 16) == 0) {
      // session-multiplexed client connection: many sessions, one
      // socket. Never enters `established` (two mux conns would
      // collide on the magic id) and skips the dup tiebreak.
      c.mux = true;
    } else {
      // a dup loser keeps draining: frames already on this socket still
      // parse and deliver below (sender id is known now either way)
      establish(fd, c);
    }
  }
  while (c.rbuf.size() - off >= 4) {
    uint32_t len = static_cast<uint32_t>(c.rbuf[off]) |
                   (static_cast<uint32_t>(c.rbuf[off + 1]) << 8) |
                   (static_cast<uint32_t>(c.rbuf[off + 2]) << 16) |
                   (static_cast<uint32_t>(c.rbuf[off + 3]) << 24);
    if (len > kMaxFrame || (c.mux && len < 16)) {
      // poisoned stream (mux frames must carry a session id prefix)
      close_conn(fd);
      return;
    }
    if (c.rbuf.size() - off - 4 < len) break;
    InboundMsg m;
    if (c.mux) {
      // [16B session id][inner payload]: the embedded id IS the sender
      memcpy(m.sender.data(), c.rbuf.data() + off + 4, 16);
      mux_sessions[m.sender] = fd;  // bind/rebind replies to this conn
      len -= 16;
      m.data = pool_get_locked(len);
      m.data.assign(c.rbuf.begin() + off + 20,
                    c.rbuf.begin() + off + 20 + len);
      off += 16;  // consumed the prefix; the tail advance below adds len
    } else {
      m.sender = c.peer;
      m.data = pool_get_locked(len);
      m.data.assign(c.rbuf.begin() + off + 4,
                    c.rbuf.begin() + off + 4 + len);
    }
    bump(RTC_FRAMES_IN);
    bump(RTC_BYTES_IN, len);
    tf_rec(0, m.sender, len, len >= 2 ? m.data[1] : 0);
    const int32_t ng = ngroups.load(std::memory_order_acquire);
    if (ng > 0) {
      // thread-per-shard-group routing: classify by the shards the
      // frame carries and deliver to each flagged group's own inbox
      deliver_groups_locked(std::move(m), ng);
    } else {
      if (inbox.size() >= kMaxInbox) {
        pool_put_locked(std::move(inbox.front().data));
        inbox.pop_front();
        dropped_frames++;
        bump(RTC_INBOX_DROPPED);
      }
      inbox.push_back(std::move(m));
    }
    off += 4 + len;
  }
  if (off) c.rbuf.erase(c.rbuf.begin(), c.rbuf.begin() + off);
  if (!inbox.empty()) inbox_cv.notify_all();
  if (eof) close_conn(fd);
}

// Route one inbound frame to its shard groups' inboxes. Multi-group
// frames (a workers=1 peer's mixed vote batch) are copied per extra
// group — each worker's rk ctx ingests only its own shard range, so
// every group must see the whole frame. The classifier is pure and
// read-only (runtime.cpp rtm_frame_group_mask); mask 0 or unroutable
// frames (Propose/sync/admin/malformed) land in group 0, whose worker
// owns control-plane escalation.
void Transport::deliver_groups_locked(InboundMsg&& m, int32_t ng)
    RABIA_REQUIRES(mu) {
  uint64_t mask =
      classify ? classify(classify_arg, m.data.data(),
                          (uint32_t)m.data.size())
               : 1;
  const uint64_t all = ng >= 64 ? ~0ull : ((1ull << ng) - 1);
  mask &= all;
  if (!mask) mask = 1;
  const int32_t last = 63 - __builtin_clzll(mask);
  for (int32_t g = 0; g < ng; g++) {
    if (!(mask & (1ull << g))) continue;
    GroupInbox& G = *groups[(size_t)g];
    InboundMsg d;
    d.sender = m.sender;
    if (g == last) {
      d.data = std::move(m.data);
    } else {
      d.data = pool_get_locked(m.data.size());
      d.data.assign(m.data.begin(), m.data.end());
      bump(RTC_GROUP_COPIES);
    }
    bump(RTC_GROUP_FRAMES);
    {
      rabia::MutexLock lg(G.gmu);
      // sweep this group's released borrow buffers back into the arena
      // (the worker recycles lock-cheap; only the io thread, already
      // holding `mu`, touches the shared pool)
      if (!G.recycle.empty()) {
        for (auto& v : G.recycle) pool_put_locked(std::move(v));
        G.recycle.clear();
      }
      if (G.q.size() >= kMaxInbox) {
        pool_put_locked(std::move(G.q.front().data));
        G.q.pop_front();
        dropped_frames++;
        bump(RTC_INBOX_DROPPED);
      }
      G.q.push_back(std::move(d));
    }
    G.cv.notify_all();
  }
}

void Transport::handle_writable(int fd) RABIA_REQUIRES(mu) {
  auto it = conns.find(fd);
  if (it == conns.end()) return;
  Conn& c = it->second;
  while (!c.wqueue.empty()) {
    auto& front = *c.wqueue.front();
    ssize_t n = ::send(fd, front.data() + c.woff, front.size() - c.woff,
                       MSG_NOSIGNAL);
    if (n > 0) {
      c.woff += static_cast<size_t>(n);
      if (c.woff == front.size()) {
        auto sp = std::move(c.wqueue.front());
        c.wqueue.pop_front();
        c.woff = 0;
        c.hs_in_queue = false;  // handshake is strictly first
        recycle_frame(std::move(sp));
      }
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      return;  // stay EPOLLOUT-armed
    } else {
      close_conn(fd);
      return;
    }
  }
  arm_write(fd, false);
  drain_shutdown(fd, c);  // draining loser: flushed — half-close now
}

void Transport::enqueue_shared_locked(
    int fd, const std::shared_ptr<std::vector<uint8_t>>& f)
    RABIA_REQUIRES(mu) {
  auto it = conns.find(fd);
  if (it == conns.end()) return;
  it->second.wqueue.push_back(f);
  bump(RTC_FRAMES_OUT);
  bump(RTC_BYTES_OUT, f->size());
  tf_rec(1, it->second.peer, (uint32_t)(f->size() - 4),
         f->size() >= 6 ? (*f)[5] : 0);
  arm_write(fd, true);
}

void Transport::drain_out_locked() RABIA_REQUIRES(mu) {
  std::deque<OutMsg> local;
  {
    rabia::MutexLock lo(mu_out);
    local.swap(outq);
  }
  const double now = local.empty() ? 0.0 : now_s();
  for (auto& m : local) {
    if (m.broadcast) {
      for (auto& [id, fd] : established) {
        if (!shape_outbound(id, fd, now, m.frame))
          enqueue_shared_locked(fd, m.frame);
      }
    } else {
      auto est = established.find(m.target);
      if (est != established.end()) {
        if (!shape_outbound(m.target, est->second, now, m.frame))
          enqueue_shared_locked(est->second, m.frame);
        continue;
      }
      auto pr = peers.find(m.target);
      if (pr != peers.end()) {
        // a known peer with no established conn: the simultaneous-dial
        // window, where the conn a send saw connected has just closed as
        // the dup loser and the winner's handshake has not finished.
        // Dropping the frame here broke "send after is_connected
        // delivers" (the dup-race receive timeout); stash it like the
        // frames of a dying conn, for the next conn to this peer within
        // kStashTtlS (bounded, oldest dropped first)
        Peer& p = pr->second;
        while (!p.stash.empty() && (p.stash.size() >= kMaxStash ||
                                    p.stash_bytes + m.frame->size() >
                                        kMaxStashBytes)) {
          p.stash_bytes -= p.stash.front()->size();
          p.stash.pop_front();
        }
        p.stash_bytes += m.frame->size();
        p.stash.push_back(m.frame);
        p.stash_t = now;
        continue;
      }
      auto mx = mux_sessions.find(m.target);
      if (mx != mux_sessions.end()) {
        // session on a muxed connection: re-frame with the 16-byte
        // session id prefix so the client side can demultiplex
        const auto& f = *m.frame;  // [4B len][payload]
        uint32_t plen = (uint32_t)(f.size() - 4);
        auto wrapped = std::make_shared<std::vector<uint8_t>>();
        wrapped->resize(4 + 16 + plen);
        uint32_t wl = 16 + plen;
        (*wrapped)[0] = wl & 0xFF;
        (*wrapped)[1] = (wl >> 8) & 0xFF;
        (*wrapped)[2] = (wl >> 16) & 0xFF;
        (*wrapped)[3] = (wl >> 24) & 0xFF;
        memcpy(wrapped->data() + 4, m.target.data(), 16);
        memcpy(wrapped->data() + 20, f.data() + 4, plen);
        enqueue_shared_locked(mx->second, wrapped);
      }
    }
  }
}

void Transport::dial(const NodeIdBytes& id, Peer& p) RABIA_REQUIRES(mu) {
  bump(RTC_DIALS);
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return;
  set_nonblock(fd);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(p.port);
  if (inet_pton(AF_INET, p.host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    return;
  }
  int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc < 0 && errno != EINPROGRESS) {
    // try_dials already advanced attempts/next_dial for this cycle; an
    // immediate refusal must not double-charge the backoff budget
    ::close(fd);
    return;
  }
  Conn c;
  c.fd = fd;
  c.outbound = true;
  c.dial_target = id;
  // send our id immediately (kernel buffers it through connect completion)
  c.wqueue.push_back(
      std::make_shared<std::vector<uint8_t>>(self_id.begin(), self_id.end()));
  c.handshake_sent = true;
  c.hs_in_queue = true;
  conns[fd] = std::move(c);
  epoll_event ev{};
  ev.events = EPOLLIN | EPOLLOUT;
  ev.data.fd = fd;
  epoll_ctl(epoll_fd, EPOLL_CTL_ADD, fd, &ev);
}

void Transport::try_dials() RABIA_REQUIRES(mu) {
  double t = now_s();
  for (auto& [id, p] : peers) {
    if (p.connected) continue;
    bool mid_dial = false;  // an in-flight outbound conn to this peer?
    for (auto& [fd, c] : conns) {
      if (c.outbound && !c.handshaken_in && c.dial_target == id) {
        mid_dial = true;
        break;
      }
    }
    if (mid_dial) continue;
    // after the initial backoff budget, keep re-dialing slowly forever
    if (p.attempts >= kMaxDialAttempts) {
      if (t >= p.next_dial) {
        p.attempts = 0;
        p.next_dial = t + kRedialPeriodS;
        dial(id, p);
      }
      continue;
    }
    if (t >= p.next_dial) {
      p.attempts++;
      double delay = kDialBaseDelayS;
      for (int i = 1; i < p.attempts; i++) delay *= 2.0;
      if (delay > kDialMaxDelayS) delay = kDialMaxDelayS;
      p.next_dial = t + delay;
      dial(id, p);
    }
  }
}

void Transport::io_loop() RABIA_EXCLUDES(mu) {
  epoll_event evs[64];
  int wait_ms = 50;
  while (!stopping.load()) {
    int n = epoll_wait(epoll_fd, evs, 64, wait_ms);
    rabia::MutexLock lk(mu);
    drain_out_locked();
    // chaos shaping: deliver due delayed frames and tighten the next
    // epoll timeout to the next due time (50ms granularity would smear
    // sub-50ms injected delays)
    wait_ms = delayq.empty() ? 50 : release_delayed(now_s(), 50);
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      uint32_t e = evs[i].events;
      if (fd == wake_fd) {
        uint64_t junk;
        while (::read(wake_fd, &junk, 8) == 8) {
        }
        continue;
      }
      if (fd == listen_fd) {
        for (;;) {
          int cfd = ::accept(listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblock(cfd);
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn c;
          c.fd = cfd;
          c.wqueue.push_back(std::make_shared<std::vector<uint8_t>>(
              self_id.begin(), self_id.end()));
          c.handshake_sent = true;
          c.hs_in_queue = true;
          conns[cfd] = std::move(c);
          epoll_event ev{};
          ev.events = EPOLLIN | EPOLLOUT;
          ev.data.fd = cfd;
          epoll_ctl(epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      // read BEFORE acting on HUP: a peer's final frames can land in
      // the same epoll event as its FIN (EPOLLIN|EPOLLHUP — routine on
      // a draining duplicate connection whose both halves are shut).
      // Closing first would discard them unread from the kernel
      // buffer; handle_readable drains to EOF and closes the conn
      // itself, making the HUP branch a no-op for that fd.
      if (e & EPOLLIN) handle_readable(fd);
      if (e & (EPOLLHUP | EPOLLERR)) {
        close_conn(fd);
        continue;
      }
      if (e & EPOLLOUT) handle_writable(fd);
    }
    try_dials();
    sweep_draining();
  }
}

}  // namespace

extern "C" {

// Creates + starts a transport. Writes the actually-bound port into
// *actual_port (useful with port=0). Returns an opaque handle or null.
void* rt_create(const uint8_t node_id[16], const char* bind_host,
                uint16_t port, uint16_t* actual_port) {
  auto* t = new Transport();
  memcpy(t->self_id.data(), node_id, 16);
  for (auto& c : t->ctrs) c.store(0, std::memory_order_relaxed);

  t->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (t->listen_fd < 0) {
    delete t;
    return nullptr;
  }
  int one = 1;
  setsockopt(t->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    ::close(t->listen_fd);
    delete t;
    return nullptr;
  }
  if (::bind(t->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(t->listen_fd, 128) < 0) {
    ::close(t->listen_fd);
    delete t;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(t->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  t->port = ntohs(addr.sin_port);
  if (actual_port) *actual_port = t->port;
  set_nonblock(t->listen_fd);

  t->epoll_fd = epoll_create1(0);
  t->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = t->listen_fd;
  epoll_ctl(t->epoll_fd, EPOLL_CTL_ADD, t->listen_fd, &ev);
  ev.data.fd = t->wake_fd;
  epoll_ctl(t->epoll_fd, EPOLL_CTL_ADD, t->wake_fd, &ev);

  t->io_thread = std::thread([t] { t->io_loop(); });
  return t;
}

int rt_add_peer(void* h, const uint8_t peer_id[16], const char* host,
                uint16_t port) {
  auto* t = static_cast<Transport*>(h);
  NodeIdBytes id;
  memcpy(id.data(), peer_id, 16);
  {
    rabia::MutexLock lk(t->mu);
    Peer p;
    p.host = host;
    p.port = port;
    p.next_dial = 0.0;
    t->peers[id] = std::move(p);
  }
  uint64_t one = 1;
  (void)!::write(t->wake_fd, &one, 8);
  return 0;
}

int rt_remove_peer(void* h, const uint8_t peer_id[16]) {
  auto* t = static_cast<Transport*>(h);
  NodeIdBytes id;
  memcpy(id.data(), peer_id, 16);
  rabia::MutexLock lk(t->mu);
  t->peers.erase(id);
  auto est = t->established.find(id);
  if (est != t->established.end()) t->close_conn(est->second);
  return 0;
}

// Chaos shaping layer: inject per-peer outbound delay (+/- jitter) and
// drop probability on this transport's link TO peer_id, applied on the
// io thread at drain time (see Transport::shape_outbound). Asymmetric
// by construction — shape one side's transport to impair one direction.
// delay_us=0, drop=0 clears the peer's entry; seed != 0 reseeds the
// deterministic drop RNG. Returns 0.
int rt_set_shaping(void* h, const uint8_t peer_id[16], uint32_t delay_us,
                   uint32_t jitter_us, double drop, uint64_t seed) {
  auto* t = static_cast<Transport*>(h);
  NodeIdBytes id;
  memcpy(id.data(), peer_id, 16);
  {
    rabia::MutexLock lk(t->mu);
    if (seed) t->shape_rng = seed;
    if (delay_us == 0 && jitter_us == 0 && drop <= 0.0) {
      t->shaping.erase(id);
    } else {
      Transport::Shape sh;
      sh.delay_us = delay_us;
      sh.jitter_us = jitter_us;
      sh.drop = drop < 0.0 ? 0.0 : (drop > 1.0 ? 1.0 : drop);
      t->shaping[id] = sh;
    }
  }
  t->kick();
  return 0;
}

// Clear every shaping entry (delayed frames already queued still deliver
// at their due times — clearing stops future impairment, it does not
// reorder traffic already in the delay queue).
int rt_clear_shaping(void* h) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  t->shaping.clear();
  return 0;
}

// 0 = queued; -1 = peer not connected.
int rt_send(void* h, const uint8_t peer_id[16], const uint8_t* data,
            uint32_t len) {
  auto* t = static_cast<Transport*>(h);
  if (len > kMaxFrame) return -2;
  NodeIdBytes id;
  memcpy(id.data(), peer_id, 16);
  auto frame = t->make_frame(data, len);
  {
    rabia::MutexLock lo(t->mu_out);
    t->outq.push_back({std::move(frame), false, id});
  }
  t->kick();
  return 0;
}

// Returns number of peers the frame was queued to.
int rt_broadcast(void* h, const uint8_t* data, uint32_t len) {
  auto* t = static_cast<Transport*>(h);
  if (len > kMaxFrame) return -2;
  auto frame = t->make_frame(data, len);
  {
    rabia::MutexLock lo(t->mu_out);
    t->outq.push_back({std::move(frame), true, NodeIdBytes{}});
  }
  t->kick();
  return 0;
}

// Broadcast a batch of frames packed as [u32 record_len][frame bytes]...
// (the native tick's outbound buffer, hostkernel.cpp rk_tick). All frames
// are staged under ONE outbound lock acquisition and one io-loop kick, so
// a chained tick's R1+R2+Decision wave costs a single Python->C call and
// a single wakeup. Returns the number of frames staged, or -2 if any
// record is malformed / exceeds the frame cap (staging stops there).
int rt_broadcast_frames(void* h, const uint8_t* buf, int64_t len) {
  auto* t = static_cast<Transport*>(h);
  // frame first (make_frame takes mu_out itself for the pool), then stage
  // the whole batch under one lock acquisition
  std::vector<Transport::OutMsg> staged;
  int64_t pos = 0;
  while (pos + 4 <= len) {
    uint32_t rec;
    memcpy(&rec, buf + pos, 4);
    if (rec > kMaxFrame || pos + 4 + (int64_t)rec > len) return -2;
    staged.push_back({t->make_frame(buf + pos + 4, rec), true,
                      NodeIdBytes{}});
    pos += 4 + (int64_t)rec;
  }
  if (staged.empty()) return 0;
  const int n = (int)staged.size();
  {
    rabia::MutexLock lo(t->mu_out);
    for (auto& m : staged) t->outq.push_back(std::move(m));
  }
  t->kick();
  return n;
}

// Blocks up to timeout_ms for one inbound frame. Returns the frame length
// >= 0 (copied into buf, truncated to buf_cap; 0 is a valid empty frame),
// -3 on timeout with no message, -1 if closed.
int rt_recv(void* h, uint8_t sender_out[16], uint8_t* buf, uint32_t buf_cap,
            int timeout_ms) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  if (t->inbox.empty() && timeout_ms != 0) {
    const uint64_t k0 = t->kick_gen.load(std::memory_order_relaxed);
    const timespec dl =
        rabia::CondVar::deadline_in((double)timeout_ms * 1e-3);
    while (t->inbox.empty() && !t->stopping.load() &&
           t->kick_gen.load(std::memory_order_relaxed) == k0) {
      if (!t->inbox_cv.wait_until(lk, dl)) break;
    }
  }
  if (t->inbox.empty()) return t->stopping.load() ? -1 : -3;
  InboundMsg m = std::move(t->inbox.front());
  t->inbox.pop_front();
  memcpy(sender_out, m.sender.data(), 16);
  uint32_t n = static_cast<uint32_t>(m.data.size());
  if (n > buf_cap) n = buf_cap;
  memcpy(buf, m.data.data(), n);
  t->pool_put_locked(std::move(m.data));
  return static_cast<int>(n);
}

// Zero-copy variant of rt_recv: pops one inbound frame and hands out a
// BORROWED pointer into its pooled buffer — no memcpy (the SURVEY
// §7.4.7 handoff: the codec and jax.dlpack consume the frame where the
// io thread landed it). The buffer stays alive, parked in a borrow
// table, until rt_recv_release(token); releasing returns it to the
// arena. Returns a token > 0 with *ptr_out/*len_out set, -3 on timeout
// with no message, -1 if closed.
int64_t rt_recv_borrow(void* h, uint8_t sender_out[16],
                       const uint8_t** ptr_out, uint32_t* len_out,
                       int timeout_ms) {
  auto* t = static_cast<Transport*>(h);
  std::vector<int64_t> rel;
  {
    rabia::MutexLock lr(t->mu_rel);
    rel.swap(t->released);
  }
  rabia::MutexLock lk(t->mu);
  for (int64_t tok : rel) {
    auto it = t->borrowed.find(tok);
    if (it != t->borrowed.end()) {
      t->pool_put_locked(std::move(it->second));
      t->borrowed.erase(it);
    }
  }
  if (t->inbox.empty() && timeout_ms != 0) {
    const uint64_t k0 = t->kick_gen.load(std::memory_order_relaxed);
    const timespec dl =
        rabia::CondVar::deadline_in((double)timeout_ms * 1e-3);
    while (t->inbox.empty() && !t->stopping.load() &&
           t->kick_gen.load(std::memory_order_relaxed) == k0) {
      if (!t->inbox_cv.wait_until(lk, dl)) break;
    }
  }
  if (t->inbox.empty()) return t->stopping.load() ? -1 : -3;
  InboundMsg m = std::move(t->inbox.front());
  t->inbox.pop_front();
  memcpy(sender_out, m.sender.data(), 16);
  int64_t tok = t->next_borrow_token++;
  auto& slot = t->borrowed[tok];
  slot = std::move(m.data);
  *ptr_out = slot.data();
  *len_out = static_cast<uint32_t>(slot.size());
  t->bump(RTC_BORROWS);
  return tok;
}

// Return a borrowed frame's buffer to the arena. Unknown/already-released
// tokens are ignored (close() may race a late release harmlessly as long
// as the handle itself is still alive). Deliberately NEVER takes `mu`:
// the caller is the engine's event-loop thread, and `mu` is held by the
// io thread across whole epoll batches — the token is staged and the
// buffer reclaimed by the next rt_recv_borrow. The borrowed frame stays
// valid until then (reclamation only happens under `mu` in borrow).
void rt_recv_release(void* h, int64_t token) {
  auto* t = static_cast<Transport*>(h);
  const int64_t g = (token >> 48) - 1;
  if (g >= 0) {
    // group-encoded token (rt_recv_borrow_group): recycle group-locally;
    // the io thread sweeps the buffers back into the shared arena at its
    // next delivery. Callers release on the borrowing worker's thread.
    if ((size_t)g < t->groups.size()) {
      GroupInbox& G = *t->groups[(size_t)g];
      rabia::MutexLock lg(G.gmu);
      auto it = G.borrowed.find(token & 0xFFFFFFFFFFFFll);
      if (it != G.borrowed.end()) {
        if (G.recycle.size() < 256) G.recycle.push_back(std::move(it->second));
        G.borrowed.erase(it);
      }
    }
    return;
  }
  rabia::MutexLock lr(t->mu_rel);
  t->released.push_back(token);
}

// Zero-copy receive from one shard group's inbox (rt_set_groups routing
// active). Same contract as rt_recv_borrow; the returned token routes
// its release back to the group. Returns -3 timeout, -1 closed/invalid.
int64_t rt_recv_borrow_group(void* h, int32_t group, uint8_t sender_out[16],
                             const uint8_t** ptr_out, uint32_t* len_out,
                             int timeout_ms) {
  auto* t = static_cast<Transport*>(h);
  const int32_t ng = t->ngroups.load(std::memory_order_acquire);
  if (group < 0 || group >= ng) return -1;
  GroupInbox& G = *t->groups[(size_t)group];
  rabia::MutexLock lk(G.gmu);
  if (G.q.empty() && timeout_ms != 0) {
    const uint64_t k0 = G.kick_gen.load(std::memory_order_relaxed);
    const timespec dl =
        rabia::CondVar::deadline_in((double)timeout_ms * 1e-3);
    while (G.q.empty() && !t->stopping.load() &&
           G.kick_gen.load(std::memory_order_relaxed) == k0) {
      if (!G.cv.wait_until(lk, dl)) break;
    }
  }
  if (G.q.empty()) return t->stopping.load() ? -1 : -3;
  InboundMsg m = std::move(G.q.front());
  G.q.pop_front();
  memcpy(sender_out, m.sender.data(), 16);
  int64_t tok = G.next_token++;
  auto& slot = G.borrowed[tok];
  slot = std::move(m.data);
  *ptr_out = slot.data();
  *len_out = static_cast<uint32_t>(slot.size());
  t->bump(RTC_BORROWS);
  return ((int64_t)(group + 1) << 48) | tok;
}

// Install (ngroups >= 1) or clear (ngroups == 0) per-shard-group frame
// routing. classify_fn(arg, data, len) -> group bitmask (0 = group 0).
// MUST be called while no thread is inside a _group entry point — the
// runtime bridge installs routing before rtm_start and clears it after
// rtm_stop. On clear, undelivered group frames merge back into the
// legacy inbox so a re-attached Python reader sees them.
int rt_set_groups(void* h, int32_t ngroups, void* classify_fn, void* arg) {
  auto* t = static_cast<Transport*>(h);
  if (ngroups < 0 || ngroups > 64) return -1;
  rabia::MutexLock lk(t->mu);
  if (ngroups == 0) {
    t->ngroups.store(0, std::memory_order_release);
    t->classify = nullptr;
    t->classify_arg = nullptr;
    for (auto& gp : t->groups) {
      if (!gp) continue;
      rabia::MutexLock lg(gp->gmu);
      while (!gp->q.empty()) {
        if (t->inbox.size() < kMaxInbox) {
          t->inbox.push_back(std::move(gp->q.front()));
        } else {
          // legacy inbox full: drop like every other overflow path —
          // counted, buffer recycled (not silently destroyed)
          t->pool_put_locked(std::move(gp->q.front().data));
          t->dropped_frames++;
          t->bump(RTC_INBOX_DROPPED);
        }
        gp->q.pop_front();
      }
      for (auto& v : gp->recycle) t->pool_put_locked(std::move(v));
      gp->recycle.clear();
    }
    // `groups` entries are retained: a straggling release may still
    // index them (GroupInbox addresses are stable behind unique_ptr)
    if (!t->inbox.empty()) t->inbox_cv.notify_all();
    return 0;
  }
  while ((int32_t)t->groups.size() < ngroups)
    t->groups.push_back(std::make_unique<GroupInbox>());
  t->classify = (rt_classify_t)classify_fn;
  t->classify_arg = arg;
  t->ngroups.store(ngroups, std::memory_order_release);
  return 0;
}

// Buffer-arena counters (memory_pool.rs PoolStats analog).
void rt_pool_stats(void* h, uint64_t* hits, uint64_t* misses) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  rabia::MutexLock lo(t->mu_out);
  *hits = t->pool_hits + t->out_hits;
  *misses = t->pool_misses + t->out_misses;
}

// Outbound frame-arena counters alone (the out-pool: rt_send/rt_broadcast
// staging buffers), previously folded invisibly into rt_pool_stats.
void rt_out_pool_stats(void* h, uint64_t* hits, uint64_t* misses) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lo(t->mu_out);
  *hits = t->out_hits;
  *misses = t->out_misses;
}

// --- observability counter block -------------------------------------------

int32_t rt_counters_version(void) { return kCountersVersion; }
int32_t rt_counters_count(void) { return RTC_COUNT; }

// --- flight recorder (frame in/out ring) ------------------------------------

int32_t rt_flight_version(void) { return kFlightVersion; }
int32_t rt_flight_record_size(void) { return (int32_t)sizeof(TfEvent); }
// Copy the most recent min(written, kFlightCap, max_records) records into
// `out` (max_records * rt_flight_record_size() bytes) in chronological
// order; returns the count. Taken under the io mutex — a consistent
// snapshot, unlike the relaxed counter block.
int64_t rt_flight_copy(void* h, uint8_t* out, int64_t max_records) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  uint64_t n = t->tf_head < kFlightCap ? t->tf_head : kFlightCap;
  if ((int64_t)n > max_records) n = (uint64_t)max_records;
  uint64_t start = t->tf_head - n;
  auto* dst = reinterpret_cast<TfEvent*>(out);
  for (uint64_t i = 0; i < n; i++) {
    dst[i] = t->tf[(start + i) & (kFlightCap - 1)];
  }
  return (int64_t)n;
}
// Borrowed pointer to the transport's counter block (RTC_* order), valid
// until rt_close. Relaxed-atomic cells readable as plain uint64s.
const uint64_t* rt_counters(void* h) {
  auto* t = static_cast<Transport*>(h);
  return reinterpret_cast<const uint64_t*>(t->ctrs);
}

// Writes up to cap peer ids (16 bytes each) of established peers; returns
// the count.
int rt_connected(void* h, uint8_t* ids_out, int cap) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  int i = 0;
  for (auto& [id, fd] : t->established) {
    if (i >= cap) break;
    memcpy(ids_out + 16 * i, id.data(), 16);
    i++;
  }
  return i;
}

uint16_t rt_port(void* h) { return static_cast<Transport*>(h)->port; }

// Spurious-wake a thread blocked in rt_recv / rt_recv_borrow (returns -3
// there as on timeout). Used by the Python control plane to nudge the
// native runtime thread after staging a command. Deliberately LOCK-FREE:
// taking `mu` here would stall the caller behind whole io-loop epoll
// batches (milliseconds under load — measured on the engine's submit
// path). The cost is a nanoseconds-wide lost-wakeup window (generation
// bumped after the waiter's predicate check but notified before its
// futex wait); the runtime thread bounds that race with a short recv
// timeout, so a lost kick only delays a command by one idle tick.
void rt_inbox_kick(void* h) {
  auto* t = static_cast<Transport*>(h);
  t->kick_gen.fetch_add(1, std::memory_order_relaxed);
  t->inbox_cv.notify_all();
  // wake every shard-group worker too (same lock-free contract)
  const int32_t ng = t->ngroups.load(std::memory_order_acquire);
  for (int32_t g = 0; g < ng; g++) {
    GroupInbox& G = *t->groups[(size_t)g];
    G.kick_gen.fetch_add(1, std::memory_order_relaxed);
    G.cv.notify_all();
  }
}

// Stop the io loop and unblock any rt_recv caller WITHOUT deleting the
// transport. Used when the Python reader thread might still be inside
// rt_recv: stop first, join the reader, then rt_close. Safe to call more
// than once; rt_close after rt_stop is the normal teardown.
void rt_stop(void* h) {
  auto* t = static_cast<Transport*>(h);
  t->stopping.store(true);
  {
    rabia::MutexLock lk(t->mu);
    t->inbox_cv.notify_all();
  }
  const int32_t ng = t->ngroups.load(std::memory_order_acquire);
  for (int32_t g = 0; g < ng; g++) t->groups[(size_t)g]->cv.notify_all();
  uint64_t one = 1;
  (void)!::write(t->wake_fd, &one, 8);
}

// Total inbound frames dropped due to the bounded inbox (oldest-first).
uint64_t rt_dropped(void* h) {
  auto* t = static_cast<Transport*>(h);
  rabia::MutexLock lk(t->mu);
  return t->dropped_frames;
}

void rt_close(void* h) {
  auto* t = static_cast<Transport*>(h);
  t->stopping.store(true);
  {
    rabia::MutexLock lk(t->mu);
    t->inbox_cv.notify_all();
  }
  {
    const int32_t ng = t->ngroups.load(std::memory_order_acquire);
    for (int32_t g = 0; g < ng; g++) t->groups[(size_t)g]->cv.notify_all();
  }
  uint64_t one = 1;
  (void)!::write(t->wake_fd, &one, 8);
  if (t->io_thread.joinable()) t->io_thread.join();
  {
    // the lock_guard must release BEFORE delete: unlocking a destroyed
    // mutex is use-after-free (found by the TSan stress harness)
    rabia::MutexLock lk(t->mu);
    for (auto& [fd, c] : t->conns) ::close(fd);
    t->conns.clear();
    ::close(t->listen_fd);
    ::close(t->epoll_fd);
    ::close(t->wake_fd);
  }
  delete t;
}

}  // extern "C"
