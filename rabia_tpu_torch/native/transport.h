// C ABI of the native transport data plane — the single source of truth
// for every consumer: transport.cpp includes it so definitions are
// compiler-checked against these declarations, the TSan stress harness
// links against it, and rabia_tpu_torch/native/build.py mirrors it in ctypes.
#pragma once

#include <stdint.h>

extern "C" {

// Returns an opaque Transport handle (nullptr on failure); writes the
// actually-bound port (for port 0 requests).
void* rt_create(const uint8_t self_id[16], const char* host, uint16_t port,
                uint16_t* actual_port);
int rt_add_peer(void* h, const uint8_t id[16], const char* host,
                uint16_t port);
int rt_remove_peer(void* h, const uint8_t id[16]);
// Chaos shaping layer: per-peer outbound delay/jitter (us) + drop
// probability, applied by the io thread at drain time. delay=jitter=0
// and drop<=0 clears the peer; seed != 0 reseeds the drop RNG.
int rt_set_shaping(void* h, const uint8_t id[16], uint32_t delay_us,
                   uint32_t jitter_us, double drop, uint64_t seed);
int rt_clear_shaping(void* h);
// 0 ok, -1 unknown/unconnected peer, -2 frame too large.
int rt_send(void* h, const uint8_t id[16], const uint8_t* data, uint32_t len);
// Returns the number of peers reached.
int rt_broadcast(void* h, const uint8_t* data, uint32_t len);
// Broadcast a batch of [u32 record_len][frame] records (the native tick's
// outbound buffer) under one staging lock + one io kick. Returns the
// number of frames staged, -2 on a malformed/oversized record.
int rt_broadcast_frames(void* h, const uint8_t* buf, int64_t len);
// Blocks up to timeout_ms; >=0 frame length (truncated to buf_cap),
// -3 timeout, -1 closed.
int rt_recv(void* h, uint8_t sender_out[16], uint8_t* buf, uint32_t buf_cap,
            int timeout_ms);
// Zero-copy receive: borrow the next inbound frame straight from the
// arena. Returns a token >= 0 (frame at *data_out/*len_out until
// rt_recv_release), -3 timeout, -1 closed.
int64_t rt_recv_borrow(void* h, uint8_t sender_out[16],
                       const uint8_t** data_out, uint32_t* len_out,
                       int timeout_ms);
void rt_recv_release(void* h, int64_t token);
// Thread-per-shard-group routing: install (ngroups >= 1) or clear
// (ngroups == 0) per-group inbound-frame classification. classify_fn is
// `uint64_t (*)(void* arg, const uint8_t* data, uint32_t len)` returning
// a group bitmask (0 = group 0). Call only while no thread is inside a
// _group entry point (install before rtm_start, clear after rtm_stop).
int rt_set_groups(void* h, int32_t ngroups, void* classify_fn, void* arg);
// Zero-copy receive from one shard group's inbox; the returned token is
// group-encoded and releases through rt_recv_release as usual.
int64_t rt_recv_borrow_group(void* h, int32_t group, uint8_t sender_out[16],
                             const uint8_t** data_out, uint32_t* len_out,
                             int timeout_ms);
// Writes up to cap established peer ids (16B each); returns the count.
int rt_connected(void* h, uint8_t* ids_out, int cap);
uint16_t rt_port(void* h);
uint64_t rt_dropped(void* h);
void rt_pool_stats(void* h, uint64_t* hits, uint64_t* misses);
// Outbound-frame arena counters alone (the out-pool), separate from the
// merged rt_pool_stats view.
void rt_out_pool_stats(void* h, uint64_t* hits, uint64_t* misses);
// Versioned, append-only observability counter block: a borrowed pointer
// to rt_counters_count() uint64 cells, valid until rt_close. Indices are
// ABI (RTC_* in transport.cpp); new counters append and bump the
// version. Cells are relaxed atomics — reads are monotonic, not a
// consistent snapshot.
int32_t rt_counters_version(void);
int32_t rt_counters_count(void);
const uint64_t* rt_counters(void* h);
// Flight recorder: one fixed-size record per frame in/out (layout is the
// versioned TfEvent ABI in transport.cpp; the Python twin is
// rabia_tpu_torch/net/tcp.TF_DTYPE). rt_flight_copy writes the most recent
// records into `out` (max_records * rt_flight_record_size() bytes) in
// chronological order and returns the count — a consistent snapshot
// taken under the io mutex.
int32_t rt_flight_version(void);
int32_t rt_flight_record_size(void);
int64_t rt_flight_copy(void* h, uint8_t* out, int64_t max_records);
// Wake any thread blocked in rt_recv / rt_recv_borrow WITHOUT a frame
// (the wait returns -3 as on timeout). The native runtime thread sleeps
// on the transport inbox; the Python control plane kicks it here after
// staging a command so a submission never waits out the recv timeout.
void rt_inbox_kick(void* h);
// Stop the io loop and unblock rt_recv callers WITHOUT freeing the
// handle; call before rt_close when a reader thread may be inside
// rt_recv.
void rt_stop(void* h);
void rt_close(void* h);

}  // extern "C"
