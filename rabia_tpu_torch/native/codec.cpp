// Native binary codec for ProtocolMessage hot frames.
//
// SURVEY §2 C9 / §7.2 step 5 assign the binary serializer to the C++
// host library (reference: rabia-core/src/serialization.rs:22-63 bincode
// codec, :152-169 pooled zero-alloc path). This extension implements the
// SAME wire format as rabia_tpu_torch/core/serialization.py (version 3,
// hand-rolled little-endian) for the latency-critical frame types —
// VoteRound1/VoteRound2 (packed vote vectors), Decision, Propose and
// NewBatch (command batches), ProposeBlock, HeartBeat, SyncRequest,
// SyncResponse (the recovery/snapshot frame, incl. its zlib-level-1 body
// compression), and the client gateway frames (ClientHello, Submit,
// Result, ReadIndex — rabia_tpu_torch/gateway) — and returns None for
// everything else so the Python codec remains the semantics owner and
// fallback. Byte-for-byte compatibility is pinned by
// tests/test_native_codec.py.
//
// Built as a CPython extension (not ctypes): the cost of the Python
// codec is object construction and bytecode, not byte shuffling, so the
// win comes from building ProtocolMessage/vote-vector objects directly
// against the C API (tp_new + slot writes instead of Python __init__).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#define PY_ARRAY_UNIQUE_SYMBOL rabia_codec_ARRAY_API
#include <numpy/arrayobject.h>

#include <zlib.h>

#include <cstdint>
#include <cstring>

extern "C" {
// CPython private-but-exported 128-bit int helpers (uuid.py's own
// int.from_bytes path, minus the bytecode). Present throughout 3.x.
PyObject* _PyLong_FromByteArray(const unsigned char* bytes, size_t n,
                                int little_endian, int is_signed);
int _PyLong_AsByteArray(PyLongObject* v, unsigned char* bytes, size_t n,
                        int little_endian, int is_signed);
}

namespace {

constexpr uint8_t WIRE_VERSION = 3;
constexpr uint8_t FLAG_COMPRESSED = 0x01;
constexpr uint8_t FLAG_HAS_RECIPIENT = 0x02;

// MessageType codes (core/messages.py MessageType — order stable)
constexpr uint8_t MT_PROPOSE = 1;
constexpr uint8_t MT_VOTE1 = 2;
constexpr uint8_t MT_VOTE2 = 3;
constexpr uint8_t MT_DECISION = 4;
constexpr uint8_t MT_SYNCREQ = 5;
constexpr uint8_t MT_SYNCRESP = 6;
constexpr uint8_t MT_NEWBATCH = 7;
constexpr uint8_t MT_HEARTBEAT = 8;
constexpr uint8_t MT_PROPOSE_BLOCK = 10;
constexpr uint8_t MT_CLIENT_HELLO = 11;
constexpr uint8_t MT_SUBMIT = 12;
constexpr uint8_t MT_RESULT = 13;
constexpr uint8_t MT_READ_INDEX = 14;

// Python classes / helpers bound once via bind()
PyObject* g_ProtocolMessage = nullptr;
PyObject* g_VoteRound1 = nullptr;
PyObject* g_VoteRound2 = nullptr;
PyObject* g_Decision = nullptr;
PyObject* g_HeartBeat = nullptr;
PyObject* g_SyncRequest = nullptr;
PyObject* g_SyncResponse = nullptr;
PyObject* g_ClientHello = nullptr;
PyObject* g_Submit = nullptr;
PyObject* g_Result = nullptr;
PyObject* g_ReadIndex = nullptr;
PyObject* g_ProposeBlock = nullptr;
PyObject* g_PayloadBlock = nullptr;
PyObject* g_NodeId = nullptr;
PyObject* g_BatchId = nullptr;
PyObject* g_Propose = nullptr;
PyObject* g_NewBatch = nullptr;
PyObject* g_CommandBatch = nullptr;
PyObject* g_Command = nullptr;
PyObject* g_ShardId = nullptr;
PyObject* g_StateValue = nullptr;
PyObject* g_UUID = nullptr;
PyObject* g_safe_unknown = nullptr;  // uuid.SafeUUID.unknown
PyObject* g_SerializationError = nullptr;
PyObject* g_crc32 = nullptr;  // zlib.crc32
PyObject* g_node_intern = nullptr;  // dict: 16-raw-bytes -> NodeId
PyObject* g_empty_tuple = nullptr;

// interned attribute names
PyObject* s_payload; PyObject* s_id; PyObject* s_sender; PyObject* s_recipient;
PyObject* s_timestamp; PyObject* s_value; PyObject* s_int; PyObject* s_is_safe;
PyObject* s_shards; PyObject* s_phases; PyObject* s_vals; PyObject* s_bids;
PyObject* s_current_phase; PyObject* s_committed_phase; PyObject* s_state_version;
PyObject* s_block; PyObject* s_slots; PyObject* s_counts; PyObject* s_cmd_sizes;
PyObject* s_data; PyObject* s_total_commands;
PyObject* s_shard; PyObject* s_phase; PyObject* s_batch_id; PyObject* s_batch;
PyObject* s_commands;
PyObject* s_responder_phase; PyObject* s_snapshot; PyObject* s_per_shard_phase;
PyObject* s_applied_ids; PyObject* s_per_shard_version;
PyObject* s_client_id; PyObject* s_seq; PyObject* s_ack; PyObject* s_last_seq;
PyObject* s_max_inflight; PyObject* s_ack_upto; PyObject* s_status;
PyObject* s_mode; PyObject* s_key; PyObject* s_frontier;

inline void wr_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
inline void wr_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
inline uint32_t rd_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t rd_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

struct Buf {
  uint8_t stack[8192];
  uint8_t* p = stack;
  size_t cap = sizeof(stack);
  size_t len = 0;
  ~Buf() { if (p != stack) PyMem_Free(p); }
  uint8_t* reserve(size_t n) {
    if (len + n > cap) {
      size_t ncap = cap * 2;
      while (ncap < len + n) ncap *= 2;
      uint8_t* np = (uint8_t*)PyMem_Malloc(ncap);
      if (!np) return nullptr;
      memcpy(np, p, len);
      if (p != stack) PyMem_Free(p);
      p = np; cap = ncap;
    }
    uint8_t* out = p + len;
    len += n;
    return out;
  }
  bool put_u8(uint8_t v) { uint8_t* q = reserve(1); if (!q) return false; *q = v; return true; }
  bool put_u32(uint32_t v) { uint8_t* q = reserve(4); if (!q) return false; wr_u32(q, v); return true; }
  bool put_u64(uint64_t v) { uint8_t* q = reserve(8); if (!q) return false; wr_u64(q, v); return true; }
  bool put_raw(const void* src, size_t n) {
    uint8_t* q = reserve(n); if (!q) return false; memcpy(q, src, n); return true;
  }
};

struct Rd {
  const uint8_t* p;
  size_t len;
  size_t pos = 0;
  const uint8_t* take(size_t n) {
    if (pos + n > len) {
      PyErr_Format(g_SerializationError,
                   "truncated message: need %zu bytes at offset %zu, have %zu",
                   n, pos, len - pos);
      return nullptr;
    }
    const uint8_t* out = p + pos;
    pos += n;
    return out;
  }
};

// --- object construction helpers -----------------------------------------

// allocate an instance without running __init__ (object.__new__ path)
PyObject* raw_new(PyObject* cls) {
  PyTypeObject* t = (PyTypeObject*)cls;
  return t->tp_new(t, g_empty_tuple, nullptr);
}

// set an attribute bypassing the class's __setattr__ (works for both
// __slots__ descriptors and instance dicts; same mechanism as
// object.__setattr__, which frozen dataclasses / uuid.UUID themselves use)
int raw_set(PyObject* obj, PyObject* name, PyObject* val) {
  return PyObject_GenericSetAttr(obj, name, val);
}

// uuid.UUID from 16 big-endian bytes, skipping UUID.__init__ validation
PyObject* make_uuid(const uint8_t* raw) {
  PyObject* big = _PyLong_FromByteArray(raw, 16, /*little=*/0, /*signed=*/0);
  if (!big) return nullptr;
  PyObject* u = raw_new(g_UUID);
  if (!u) { Py_DECREF(big); return nullptr; }
  if (raw_set(u, s_int, big) < 0 ||
      raw_set(u, s_is_safe, g_safe_unknown) < 0) {
    Py_DECREF(big); Py_DECREF(u); return nullptr;
  }
  Py_DECREF(big);
  return u;
}

// 16 wire bytes of a uuid.UUID (big-endian of its .int)
bool uuid_bytes(PyObject* u, uint8_t* out) {
  PyObject* big = PyObject_GetAttr(u, s_int);
  if (!big) return false;
  // UUID(int=...) stores whatever integer-like it was given (e.g. a
  // numpy int64); coerce to an exact PyLong before the byte export
  PyObject* exact = PyNumber_Index(big);
  Py_DECREF(big);
  if (!exact) return false;
  int rc = _PyLong_AsByteArray((PyLongObject*)exact, out, 16, /*little=*/0,
                               /*signed=*/0);
  Py_DECREF(exact);
  return rc == 0;
}

// interned NodeId from 16 raw bytes
PyObject* intern_node(const uint8_t* raw) {
  PyObject* key = PyBytes_FromStringAndSize((const char*)raw, 16);
  if (!key) return nullptr;
  PyObject* hit = PyDict_GetItemWithError(g_node_intern, key);
  if (hit) {
    Py_INCREF(hit);
    Py_DECREF(key);
    return hit;
  }
  if (PyErr_Occurred()) { Py_DECREF(key); return nullptr; }
  if (PyDict_Size(g_node_intern) > 4096) PyDict_Clear(g_node_intern);
  PyObject* u = make_uuid(raw);
  if (!u) { Py_DECREF(key); return nullptr; }
  PyObject* node = raw_new(g_NodeId);
  if (!node || raw_set(node, s_value, u) < 0) {
    Py_XDECREF(node); Py_DECREF(u); Py_DECREF(key); return nullptr;
  }
  Py_DECREF(u);
  if (PyDict_SetItem(g_node_intern, key, node) < 0) {
    Py_DECREF(node); Py_DECREF(key); return nullptr;
  }
  Py_DECREF(key);
  return node;
}

// contiguous int64 view of a numpy attr (no copy when already i64)
PyArrayObject* as_i64(PyObject* owner, PyObject* name) {
  PyObject* a = PyObject_GetAttr(owner, name);
  if (!a) return nullptr;
  PyArrayObject* arr = (PyArrayObject*)PyArray_FROM_OTF(
      a, NPY_INT64, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED);
  Py_DECREF(a);
  return arr;
}

PyArrayObject* as_i8(PyObject* owner, PyObject* name) {
  PyObject* a = PyObject_GetAttr(owner, name);
  if (!a) return nullptr;
  PyArrayObject* arr = (PyArrayObject*)PyArray_FROM_OTF(
      a, NPY_INT8, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED);
  Py_DECREF(a);
  return arr;
}

// --- payload encoders -----------------------------------------------------

// vote vector body: u32 n + n * (u32 shard, u64 phase, u8 vote)
bool encode_votes(Buf& b, PyObject* payload) {
  PyArrayObject* sh = as_i64(payload, s_shards);
  PyArrayObject* ph = as_i64(payload, s_phases);
  PyArrayObject* vv = as_i8(payload, s_vals);
  if (!sh || !ph || !vv) {
    Py_XDECREF(sh); Py_XDECREF(ph); Py_XDECREF(vv);
    return false;
  }
  npy_intp n = PyArray_DIM(sh, 0);
  const int64_t* ps = (const int64_t*)PyArray_DATA(sh);
  const int64_t* pp = (const int64_t*)PyArray_DATA(ph);
  const int8_t* pv = (const int8_t*)PyArray_DATA(vv);
  bool ok = b.put_u32((uint32_t)n);
  if (ok) {
    uint8_t* q = b.reserve((size_t)n * 13);
    ok = q != nullptr;
    if (ok) {
      for (npy_intp i = 0; i < n; i++) {
        wr_u32(q, (uint32_t)ps[i]);
        wr_u64(q + 4, (uint64_t)pp[i]);
        q[12] = (uint8_t)pv[i];
        q += 13;
      }
    }
  }
  Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
  return ok;
}

// Decision body: u32 n + n * (u32, u64, u8 decision, u8 has_bid) +
// trailing 16B batch ids for has_bid entries in order
bool encode_decision(Buf& b, PyObject* payload) {
  PyArrayObject* sh = as_i64(payload, s_shards);
  PyArrayObject* ph = as_i64(payload, s_phases);
  PyArrayObject* vv = as_i8(payload, s_vals);
  PyObject* bids = PyObject_GetAttr(payload, s_bids);
  if (!sh || !ph || !vv || !bids) {
    Py_XDECREF(sh); Py_XDECREF(ph); Py_XDECREF(vv); Py_XDECREF(bids);
    return false;
  }
  npy_intp n = PyArray_DIM(sh, 0);
  const int64_t* ps = (const int64_t*)PyArray_DATA(sh);
  const int64_t* pp = (const int64_t*)PyArray_DATA(ph);
  const int8_t* pv = (const int8_t*)PyArray_DATA(vv);
  bool has_bids = bids != Py_None;
  bool ok = b.put_u32((uint32_t)n);
  uint8_t* q = ok ? b.reserve((size_t)n * 14) : nullptr;
  ok = q != nullptr;
  if (ok) {
    for (npy_intp i = 0; i < n; i++) {
      wr_u32(q, (uint32_t)ps[i]);
      wr_u64(q + 4, (uint64_t)pp[i]);
      q[12] = (uint8_t)pv[i];
      uint8_t hb = 0;
      if (has_bids) {
        PyObject* bid = PyList_GET_ITEM(bids, i);  // borrowed
        hb = (bid != Py_None) ? 1 : 0;
      }
      q[13] = hb;
      q += 14;
    }
    if (has_bids) {
      for (npy_intp i = 0; ok && i < n; i++) {
        PyObject* bid = PyList_GET_ITEM(bids, i);
        if (bid == Py_None) continue;
        PyObject* val = PyObject_GetAttr(bid, s_value);
        uint8_t raw[16];
        ok = val && uuid_bytes(val, raw) && b.put_raw(raw, 16);
        Py_XDECREF(val);
      }
    }
  }
  Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); Py_DECREF(bids);
  return ok;
}

bool put_u64_attr(Buf& b, PyObject* payload, PyObject* name) {
  PyObject* v = PyObject_GetAttr(payload, name);
  if (!v) return false;
  uint64_t x = PyLong_AsUnsignedLongLong(v);
  Py_DECREF(v);
  if (x == (uint64_t)-1 && PyErr_Occurred()) return false;
  return b.put_u64(x);
}

// zlib-compatible CRC-32 (IEEE 0xEDB88320), table built on first use —
// CommandBatch.checksum() chains crc32 over (id bytes, data) per command,
// which would cost one Python call per piece via g_crc32
uint32_t crc32_table[256];
bool crc32_ready = false;
uint32_t crc32_run(uint32_t crc, const uint8_t* buf, size_t n) {
  if (!crc32_ready) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc32_table[i] = c;
    }
    crc32_ready = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < n; i++)
    crc = crc32_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint32_t crc32_of(PyObject* data_bytes, bool* ok) {
  PyObject* r = PyObject_CallFunctionObjArgs(g_crc32, data_bytes, nullptr);
  if (!r) { *ok = false; return 0; }
  uint32_t v = (uint32_t)(PyLong_AsUnsignedLong(r) & 0xFFFFFFFFu);
  Py_DECREF(r);
  *ok = !PyErr_Occurred();
  return v;
}

// ProposeBlock body (serialization.py _encode_payload ProposeBlock branch)
bool encode_block(Buf& b, PyObject* payload) {
  PyObject* blk = PyObject_GetAttr(payload, s_block);
  if (!blk) return false;
  PyObject* bid = PyObject_GetAttr(blk, s_id);
  PyArrayObject* sh = as_i64(blk, s_shards);
  PyArrayObject* sl = as_i64(blk, s_slots);
  PyArrayObject* ct = as_i64(blk, s_counts);
  PyArrayObject* cs = as_i64(blk, s_cmd_sizes);
  PyObject* data = PyObject_GetAttr(blk, s_data);
  PyObject* tot = PyObject_GetAttr(blk, s_total_commands);
  bool ok = bid && sh && sl && ct && cs && data && tot &&
            PyBytes_Check(data);
  if (ok) {
    uint8_t raw[16];
    ok = uuid_bytes(bid, raw) && b.put_raw(raw, 16);
    npy_intp k = PyArray_DIM(sh, 0);
    ok = ok && b.put_u32((uint32_t)k);
    if (ok) {
      const int64_t* p = (const int64_t*)PyArray_DATA(sh);
      uint8_t* q = b.reserve((size_t)k * 4);
      ok = q != nullptr;
      for (npy_intp i = 0; ok && i < k; i++) wr_u32(q + 4 * i, (uint32_t)p[i]);
    }
    if (ok) {
      const int64_t* p = (const int64_t*)PyArray_DATA(sl);
      uint8_t* q = b.reserve((size_t)k * 8);
      ok = q != nullptr;
      for (npy_intp i = 0; ok && i < k; i++) wr_u64(q + 8 * i, (uint64_t)p[i]);
    }
    if (ok) {
      const int64_t* p = (const int64_t*)PyArray_DATA(ct);
      uint8_t* q = b.reserve((size_t)k * 4);
      ok = q != nullptr;
      for (npy_intp i = 0; ok && i < k; i++) wr_u32(q + 4 * i, (uint32_t)p[i]);
    }
    long total = ok ? PyLong_AsLong(tot) : 0;
    ok = ok && !PyErr_Occurred() && b.put_u32((uint32_t)total);
    if (ok) {
      npy_intp nsz = PyArray_DIM(cs, 0);
      const int64_t* p = (const int64_t*)PyArray_DATA(cs);
      uint8_t* q = b.reserve((size_t)nsz * 4);
      ok = q != nullptr;
      for (npy_intp i = 0; ok && i < nsz; i++) wr_u32(q + 4 * i, (uint32_t)p[i]);
    }
    if (ok) {
      Py_ssize_t dn = PyBytes_GET_SIZE(data);
      ok = b.put_u32((uint32_t)dn) &&
           b.put_raw(PyBytes_AS_STRING(data), (size_t)dn);
    }
    if (ok) {
      uint32_t crc = crc32_of(data, &ok);
      ok = ok && b.put_u32(crc);
    }
  }
  Py_XDECREF(bid); Py_XDECREF(sh); Py_XDECREF(sl); Py_XDECREF(ct);
  Py_XDECREF(cs); Py_XDECREF(data); Py_XDECREF(tot); Py_DECREF(blk);
  return ok;
}

bool u64_attr_val(PyObject* obj, PyObject* name, uint64_t* out);

// SyncResponse body (serialization.py _encode_payload SyncResponse
// branch): u64 responder_phase, u64 state_version, u8 has_snapshot
// [+ u32 len + bytes], u32 n + n*u64 per_shard_phase, u32 n + n*(u32
// shard, 16B batch uuid) applied_ids, u32 n + n*u64 per_shard_version.
// The recovery frame of rabia-core/src/serialization.rs:22-63 (uniform
// codec over every message type incl. snapshots). Any shape surprise
// sets *decline (Python codec owns the frame; its error surfaces
// unchanged) rather than raising here.
bool syncresp_u64_seq(Buf& b, PyObject* payload, PyObject* name,
                      bool* decline) {
  PyObject* seq = PyObject_GetAttr(payload, name);
  if (!seq) { PyErr_Clear(); *decline = true; return false; }
  PyObject* fast = PySequence_Fast(seq, "");
  Py_DECREF(seq);
  if (!fast) { PyErr_Clear(); *decline = true; return false; }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  bool ok = b.put_u32((uint32_t)n);
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject* v = PySequence_Fast_GET_ITEM(fast, i);
    PyObject* ix = PyNumber_Index(v);
    if (!ix) { PyErr_Clear(); *decline = true; ok = false; break; }
    uint64_t x = PyLong_AsUnsignedLongLong(ix);
    Py_DECREF(ix);
    if (x == (uint64_t)-1 && PyErr_Occurred()) {
      PyErr_Clear(); *decline = true; ok = false; break;
    }
    ok = b.put_u64(x);
  }
  Py_DECREF(fast);
  return ok;
}

bool encode_syncresp(Buf& b, PyObject* payload, bool* decline) {
  uint64_t rp, sv;
  if (!u64_attr_val(payload, s_responder_phase, &rp) ||
      !u64_attr_val(payload, s_state_version, &sv)) {
    PyErr_Clear(); *decline = true; return false;
  }
  if (!b.put_u64(rp) || !b.put_u64(sv)) return false;
  PyObject* snap = PyObject_GetAttr(payload, s_snapshot);
  if (!snap) { PyErr_Clear(); *decline = true; return false; }
  bool ok;
  if (snap == Py_None) {
    ok = b.put_u8(0);
  } else if (PyBytes_Check(snap)) {
    Py_ssize_t n = PyBytes_GET_SIZE(snap);
    if ((uint64_t)n > 0xFFFFFFFFull) {
      // a >4GiB snapshot overflows the u32 length prefix: the Python
      // writer raises there — decline so it does, never truncate
      Py_DECREF(snap);
      *decline = true;
      return false;
    }
    ok = b.put_u8(1) && b.put_u32((uint32_t)n) &&
         b.put_raw(PyBytes_AS_STRING(snap), (size_t)n);
  } else {
    *decline = true; ok = false;  // bytearray/memoryview: Python path
  }
  Py_DECREF(snap);
  if (!ok) return false;
  if (!syncresp_u64_seq(b, payload, s_per_shard_phase, decline))
    return false;
  PyObject* ids = PyObject_GetAttr(payload, s_applied_ids);
  if (!ids) { PyErr_Clear(); *decline = true; return false; }
  PyObject* fast = PySequence_Fast(ids, "");
  Py_DECREF(ids);
  if (!fast) { PyErr_Clear(); *decline = true; return false; }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  ok = b.put_u32((uint32_t)n);
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject* pair = PySequence_Fast_GET_ITEM(fast, i);
    PyObject* pf = PySequence_Fast(pair, "");
    if (!pf || PySequence_Fast_GET_SIZE(pf) != 2) {
      Py_XDECREF(pf); PyErr_Clear(); *decline = true; ok = false; break;
    }
    PyObject* ix = PyNumber_Index(PySequence_Fast_GET_ITEM(pf, 0));
    uint64_t shard = ix ? PyLong_AsUnsignedLongLong(ix) : (uint64_t)-1;
    Py_XDECREF(ix);
    if (!ix || (shard == (uint64_t)-1 && PyErr_Occurred()) ||
        shard > 0xFFFFFFFFull) {
      Py_DECREF(pf); PyErr_Clear(); *decline = true; ok = false; break;
    }
    PyObject* bid = PySequence_Fast_GET_ITEM(pf, 1);
    PyObject* val = PyObject_GetAttr(bid, s_value);
    uint8_t raw[16];
    bool got = val && uuid_bytes(val, raw);
    Py_XDECREF(val);
    Py_DECREF(pf);
    if (!got) { PyErr_Clear(); *decline = true; ok = false; break; }
    ok = b.put_u32((uint32_t)shard) && b.put_raw(raw, 16);
  }
  Py_DECREF(fast);
  if (!ok) return false;
  return syncresp_u64_seq(b, payload, s_per_shard_version, decline);
}

// --- client gateway frame encoders (rabia_tpu_torch/gateway) --------------------
// Same decline discipline as encode_syncresp: any shape surprise (non-
// bytes blob, out-of-range u32 field) routes the frame to the Python
// codec so its historical error surfaces unchanged.

// 16 wire bytes of a PLAIN uuid.UUID attribute (gateway client ids are
// bare UUIDs, not NodeId/BatchId wrappers)
bool put_uuid_attr(Buf& b, PyObject* payload, PyObject* name, bool* decline) {
  PyObject* u = PyObject_GetAttr(payload, name);
  if (!u) { PyErr_Clear(); *decline = true; return false; }
  uint8_t raw[16];
  bool got = uuid_bytes(u, raw);
  Py_DECREF(u);
  if (!got) { PyErr_Clear(); *decline = true; return false; }
  return b.put_raw(raw, 16);
}

// u32 count + count * (u32 len + bytes) from a tuple-of-bytes attribute
bool encode_blob_tuple(Buf& b, PyObject* payload, PyObject* name,
                       bool* decline) {
  PyObject* seq = PyObject_GetAttr(payload, name);
  if (!seq) { PyErr_Clear(); *decline = true; return false; }
  PyObject* fast = PySequence_Fast(seq, "");
  Py_DECREF(seq);
  if (!fast) { PyErr_Clear(); *decline = true; return false; }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  bool ok = b.put_u32((uint32_t)n);
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject* v = PySequence_Fast_GET_ITEM(fast, i);
    if (!PyBytes_Check(v)) { *decline = true; ok = false; break; }
    ok = b.put_u32((uint32_t)PyBytes_GET_SIZE(v)) &&
         b.put_raw(PyBytes_AS_STRING(v), (size_t)PyBytes_GET_SIZE(v));
  }
  Py_DECREF(fast);
  return ok;
}

// an int attribute bounded to a wire width; out-of-range declines
bool u64_attr_max(PyObject* obj, PyObject* name, uint64_t max, uint64_t* out,
                  bool* decline) {
  if (!u64_attr_val(obj, name, out) || *out > max) {
    PyErr_Clear(); *decline = true; return false;
  }
  return true;
}

// ClientHello body: u8 ack | 16B client uuid | u64 last_seq |
// u32 max_inflight
bool encode_client_hello(Buf& b, PyObject* payload, bool* decline) {
  PyObject* ack = PyObject_GetAttr(payload, s_ack);
  if (!ack) { PyErr_Clear(); *decline = true; return false; }
  int truth = PyObject_IsTrue(ack);
  Py_DECREF(ack);
  if (truth < 0) { PyErr_Clear(); *decline = true; return false; }
  if (!b.put_u8((uint8_t)truth)) return false;
  if (!put_uuid_attr(b, payload, s_client_id, decline)) return false;
  uint64_t ls, mi;
  if (!u64_attr_max(payload, s_last_seq, ~0ull, &ls, decline) ||
      !u64_attr_max(payload, s_max_inflight, 0xFFFFFFFFull, &mi, decline))
    return false;
  return b.put_u64(ls) && b.put_u32((uint32_t)mi);
}

// Submit body: 16B client uuid | u64 seq | u32 shard | u64 ack_upto |
// u32 n | n * blob
bool encode_submit(Buf& b, PyObject* payload, bool* decline) {
  if (!put_uuid_attr(b, payload, s_client_id, decline)) return false;
  uint64_t seq, shard, au;
  if (!u64_attr_max(payload, s_seq, ~0ull, &seq, decline) ||
      !u64_attr_max(payload, s_shard, 0xFFFFFFFFull, &shard, decline) ||
      !u64_attr_max(payload, s_ack_upto, ~0ull, &au, decline))
    return false;
  if (!b.put_u64(seq) || !b.put_u32((uint32_t)shard) || !b.put_u64(au))
    return false;
  return encode_blob_tuple(b, payload, s_commands, decline);
}

// Result body: 16B client uuid | u64 seq | u8 status | u32 n | n * blob
bool encode_result(Buf& b, PyObject* payload, bool* decline) {
  if (!put_uuid_attr(b, payload, s_client_id, decline)) return false;
  uint64_t seq, status;
  if (!u64_attr_max(payload, s_seq, ~0ull, &seq, decline) ||
      !u64_attr_max(payload, s_status, 0xFFull, &status, decline))
    return false;
  if (!b.put_u64(seq) || !b.put_u8((uint8_t)status)) return false;
  return encode_blob_tuple(b, payload, s_payload, decline);
}

// ReadIndex body: u8 mode | 16B client uuid | u64 seq | u32 shard |
// u32 klen + key | u32 k | k * u64 frontier
bool encode_read_index(Buf& b, PyObject* payload, bool* decline) {
  uint64_t mode, seq, shard;
  if (!u64_attr_max(payload, s_mode, 0xFFull, &mode, decline)) return false;
  if (!b.put_u8((uint8_t)mode)) return false;
  if (!put_uuid_attr(b, payload, s_client_id, decline)) return false;
  if (!u64_attr_max(payload, s_seq, ~0ull, &seq, decline) ||
      !u64_attr_max(payload, s_shard, 0xFFFFFFFFull, &shard, decline))
    return false;
  if (!b.put_u64(seq) || !b.put_u32((uint32_t)shard)) return false;
  PyObject* key = PyObject_GetAttr(payload, s_key);
  if (!key) { PyErr_Clear(); *decline = true; return false; }
  bool ok = PyBytes_Check(key);
  if (ok) {
    ok = b.put_u32((uint32_t)PyBytes_GET_SIZE(key)) &&
         b.put_raw(PyBytes_AS_STRING(key), (size_t)PyBytes_GET_SIZE(key));
  } else {
    *decline = true;  // bytearray/memoryview key: Python path
  }
  Py_DECREF(key);
  if (!ok) return false;
  return syncresp_u64_seq(b, payload, s_frontier, decline);
}

// u32/u64 from an int-like attribute (plain int, numpy integer, IntEnum).
// Deliberately NO ShardId-style .value unwrapping: the Python writer
// (struct.pack) rejects wrappers for payload-level fields, and the
// prescan (attr_fits with allow_wrapper=false) routes those frames to it
// so the historical error surfaces unchanged.
bool u64_attr_val(PyObject* obj, PyObject* name, uint64_t* out) {
  PyObject* v = PyObject_GetAttr(obj, name);
  if (!v) return false;
  PyObject* ix = PyNumber_Index(v);
  Py_DECREF(v);
  if (!ix) return false;
  *out = PyLong_AsUnsignedLongLong(ix);
  Py_DECREF(ix);
  return !(*out == (uint64_t)-1 && PyErr_Occurred());
}

// CommandBatch body (serialization.py _write_batch): uuid id, f64 ts,
// u32 shard, u32 checksum, u32 n, then per command uuid id + blob data.
// Caller has pre-validated every Command.data is bytes (see the prescan
// in codec_encode) so checksum and emission are single-pass C.
bool encode_batch(Buf& b, PyObject* batch) {
  PyObject* bid = PyObject_GetAttr(batch, s_id);
  PyObject* bval = bid ? PyObject_GetAttr(bid, s_value) : nullptr;
  Py_XDECREF(bid);
  if (!bval) return false;
  uint8_t raw[16];
  bool ok = uuid_bytes(bval, raw) && b.put_raw(raw, 16);
  Py_DECREF(bval);
  if (!ok) return false;
  PyObject* ts = PyObject_GetAttr(batch, s_timestamp);
  if (!ts) return false;
  double tsv = PyFloat_AsDouble(ts);
  Py_DECREF(ts);
  if (tsv == -1.0 && PyErr_Occurred()) return false;
  uint64_t bits;
  memcpy(&bits, &tsv, 8);
  if (!b.put_u64(bits)) return false;
  // CommandBatch.shard: a ShardId or a plain int — Python writes
  // int(batch.shard), which accepts both
  PyObject* sh = PyObject_GetAttr(batch, s_shard);
  if (!sh) return false;
  PyObject* ix = PyNumber_Index(sh);
  if (!ix) {
    PyErr_Clear();
    PyObject* shv = PyObject_GetAttr(sh, s_value);
    if (shv) {
      ix = PyNumber_Index(shv);
      Py_DECREF(shv);
    }
  }
  Py_DECREF(sh);
  if (!ix) return false;
  uint32_t shard = (uint32_t)PyLong_AsUnsignedLong(ix);
  Py_DECREF(ix);
  if (PyErr_Occurred() || !b.put_u32(shard)) return false;

  PyObject* cmds = PyObject_GetAttr(batch, s_commands);
  if (!cmds) return false;
  Py_ssize_t n = PyTuple_Check(cmds) ? PyTuple_GET_SIZE(cmds) : -1;
  if (n < 0) { Py_DECREF(cmds); return false; }
  // checksum pass (ids big-endian + data, chained)
  uint32_t crc = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* c = PyTuple_GET_ITEM(cmds, i);  // borrowed
    PyObject* cid = PyObject_GetAttr(c, s_id);
    uint8_t craw[16];
    ok = cid && uuid_bytes(cid, craw);
    Py_XDECREF(cid);
    if (!ok) { Py_DECREF(cmds); return false; }
    crc = crc32_run(crc, craw, 16);
    PyObject* data = PyObject_GetAttr(c, s_data);
    if (!data || !PyBytes_Check(data)) {
      Py_XDECREF(data); Py_DECREF(cmds);
      if (!PyErr_Occurred())
        PyErr_SetString(g_SerializationError, "command data is not bytes");
      return false;
    }
    crc = crc32_run(crc, (const uint8_t*)PyBytes_AS_STRING(data),
                    (size_t)PyBytes_GET_SIZE(data));
    Py_DECREF(data);
  }
  ok = b.put_u32(crc) && b.put_u32((uint32_t)n);
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject* c = PyTuple_GET_ITEM(cmds, i);
    PyObject* cid = PyObject_GetAttr(c, s_id);
    uint8_t craw[16];
    ok = cid && uuid_bytes(cid, craw) && b.put_raw(craw, 16);
    Py_XDECREF(cid);
    if (!ok) break;
    PyObject* data = PyObject_GetAttr(c, s_data);
    ok = data && PyBytes_Check(data) &&
         b.put_u32((uint32_t)PyBytes_GET_SIZE(data)) &&
         b.put_raw(PyBytes_AS_STRING(data),
                   (size_t)PyBytes_GET_SIZE(data));
    Py_XDECREF(data);
  }
  Py_DECREF(cmds);
  return ok;
}

// Propose body: u32 shard, u64 phase, uuid batch_id, u8 value,
// u8 has_batch [+ batch]
bool encode_propose(Buf& b, PyObject* payload) {
  uint64_t shard, phase;
  if (!u64_attr_val(payload, s_shard, &shard) ||
      !u64_attr_val(payload, s_phase, &phase))
    return false;
  if (!b.put_u32((uint32_t)shard) || !b.put_u64(phase)) return false;
  PyObject* bid = PyObject_GetAttr(payload, s_batch_id);
  PyObject* bval = bid ? PyObject_GetAttr(bid, s_value) : nullptr;
  Py_XDECREF(bid);
  if (!bval) return false;
  uint8_t raw[16];
  bool ok = uuid_bytes(bval, raw) && b.put_raw(raw, 16);
  Py_DECREF(bval);
  if (!ok) return false;
  PyObject* val = PyObject_GetAttr(payload, s_value);
  if (!val) return false;
  long code = PyLong_AsLong(val);
  Py_DECREF(val);
  if (code == -1 && PyErr_Occurred()) return false;
  if (!b.put_u8((uint8_t)code)) return false;
  PyObject* batch = PyObject_GetAttr(payload, s_batch);
  if (!batch) return false;
  if (batch == Py_None) {
    ok = b.put_u8(0);
  } else {
    ok = b.put_u8(1) && encode_batch(b, batch);
  }
  Py_DECREF(batch);
  return ok;
}

// NewBatch body: u32 shard + batch
bool encode_newbatch(Buf& b, PyObject* payload) {
  uint64_t shard;
  if (!u64_attr_val(payload, s_shard, &shard)) return false;
  if (!b.put_u32((uint32_t)shard)) return false;
  PyObject* batch = PyObject_GetAttr(payload, s_batch);
  if (!batch) return false;
  bool ok = encode_batch(b, batch);
  Py_DECREF(batch);
  return ok;
}

// A Propose/NewBatch payload is fast-pathable only when every command's
// data is exactly bytes (the Python writer accepts any buffer; rather
// than replicate that, odd inputs take the Python path). Returns the
// exact encoded batch body size, 0 for None, or -1 when not
// fast-pathable — the caller compares against the serializer's
// compression threshold, above which the Python codec owns the frame
// (it may compress; this codec never does, and byte parity is pinned).
// an int-like attr that must fit the given wire width; returns false
// (with the error cleared) when it does not — the Python codec then
// owns the frame and raises exactly as it always has. allow_wrapper
// additionally unwraps a .value carrier (ShardId): valid ONLY where the
// Python writer itself coerces via int() (CommandBatch.shard) — the
// struct.pack payload fields must stay strict or the native path would
// succeed where Python raises.
bool attr_fits(PyObject* obj, PyObject* name, uint64_t max,
               bool allow_wrapper) {
  PyObject* v = PyObject_GetAttr(obj, name);
  if (!v) { PyErr_Clear(); return false; }
  PyObject* ix = PyNumber_Index(v);
  if (!ix && allow_wrapper) {
    PyErr_Clear();
    PyObject* val = PyObject_GetAttr(v, s_value);
    Py_DECREF(v);
    if (!val) { PyErr_Clear(); return false; }
    ix = PyNumber_Index(val);
    Py_DECREF(val);
  } else {
    Py_DECREF(v);
  }
  if (!ix) { PyErr_Clear(); return false; }
  uint64_t x = PyLong_AsUnsignedLongLong(ix);
  Py_DECREF(ix);
  if (x == (uint64_t)-1 && PyErr_Occurred()) {
    PyErr_Clear();  // negative or > 2^64
    return false;
  }
  return x <= max;
}

Py_ssize_t batch_body_size(PyObject* batch) {
  if (batch == Py_None) return 0;
  if (Py_TYPE(batch) != (PyTypeObject*)g_CommandBatch) return -1;
  if (!attr_fits(batch, s_shard, 0xFFFFFFFFull, /*allow_wrapper=*/true))
    return -1;
  PyObject* cmds = PyObject_GetAttr(batch, s_commands);
  if (!cmds) { PyErr_Clear(); return -1; }
  Py_ssize_t size = 16 + 8 + 4 + 4 + 4;  // id, ts, shard, crc, count
  bool ok = PyTuple_Check(cmds);
  if (ok) {
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(cmds); i++) {
      PyObject* c = PyTuple_GET_ITEM(cmds, i);
      if (Py_TYPE(c) != (PyTypeObject*)g_Command) { ok = false; break; }
      PyObject* data = PyObject_GetAttr(c, s_data);
      if (!data) { PyErr_Clear(); ok = false; break; }
      bool is_bytes = PyBytes_Check(data);
      if (is_bytes) size += 16 + 4 + PyBytes_GET_SIZE(data);
      Py_DECREF(data);
      if (!is_bytes) { ok = false; break; }
    }
  }
  Py_DECREF(cmds);
  return ok ? size : -1;
}

// --- payload decoders -----------------------------------------------------

PyObject* make_i64_array(npy_intp n) {
  npy_intp dims[1] = {n};
  return PyArray_SimpleNew(1, dims, NPY_INT64);
}

PyObject* decode_votes(Rd& r, PyObject* cls) {
  const uint8_t* q = r.take(4);
  if (!q) return nullptr;
  uint32_t n = rd_u32(q);
  const uint8_t* body = r.take((size_t)n * 13);
  if (!body) return nullptr;
  PyObject* sh = make_i64_array(n);
  PyObject* ph = make_i64_array(n);
  npy_intp dims[1] = {(npy_intp)n};
  PyObject* vv = PyArray_SimpleNew(1, dims, NPY_INT8);
  if (!sh || !ph || !vv) { Py_XDECREF(sh); Py_XDECREF(ph); Py_XDECREF(vv); return nullptr; }
  int64_t* ps = (int64_t*)PyArray_DATA((PyArrayObject*)sh);
  int64_t* pp = (int64_t*)PyArray_DATA((PyArrayObject*)ph);
  int8_t* pv = (int8_t*)PyArray_DATA((PyArrayObject*)vv);
  bool bad = false;
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* e = body + (size_t)i * 13;
    ps[i] = rd_u32(e);
    pp[i] = (int64_t)rd_u64(e + 4);
    uint8_t code = e[12];
    if (code > 3) bad = true;
    pv[i] = (int8_t)code;
  }
  if (bad) {
    Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
    PyErr_SetString(g_SerializationError, "vote code out of range");
    return nullptr;
  }
  PyObject* obj = raw_new(cls);
  if (!obj || raw_set(obj, s_shards, sh) < 0 || raw_set(obj, s_phases, ph) < 0 ||
      raw_set(obj, s_vals, vv) < 0) {
    Py_XDECREF(obj); Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
    return nullptr;
  }
  Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
  return obj;
}

PyObject* decode_decision(Rd& r) {
  const uint8_t* q = r.take(4);
  if (!q) return nullptr;
  uint32_t n = rd_u32(q);
  const uint8_t* body = r.take((size_t)n * 14);
  if (!body) return nullptr;
  PyObject* sh = make_i64_array(n);
  PyObject* ph = make_i64_array(n);
  npy_intp dims[1] = {(npy_intp)n};
  PyObject* vv = PyArray_SimpleNew(1, dims, NPY_INT8);
  if (!sh || !ph || !vv) { Py_XDECREF(sh); Py_XDECREF(ph); Py_XDECREF(vv); return nullptr; }
  int64_t* ps = (int64_t*)PyArray_DATA((PyArrayObject*)sh);
  int64_t* pp = (int64_t*)PyArray_DATA((PyArrayObject*)ph);
  int8_t* pv = (int8_t*)PyArray_DATA((PyArrayObject*)vv);
  bool bad = false;
  uint32_t n_bids = 0;
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* e = body + (size_t)i * 14;
    ps[i] = rd_u32(e);
    pp[i] = (int64_t)rd_u64(e + 4);
    uint8_t code = e[12];
    if (code > 3) bad = true;
    pv[i] = (int8_t)code;
    if (e[13]) n_bids++;
  }
  if (bad) {
    Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
    PyErr_SetString(g_SerializationError, "decision code out of range");
    return nullptr;
  }
  PyObject* bids = Py_None;
  Py_INCREF(Py_None);
  if (n_bids) {
    Py_DECREF(Py_None);
    bids = PyList_New(n);
    if (!bids) { Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); return nullptr; }
    for (uint32_t i = 0; i < n; i++) {
      const uint8_t* e = body + (size_t)i * 14;
      PyObject* item;
      if (e[13]) {
        const uint8_t* raw = r.take(16);
        if (!raw) { Py_DECREF(bids); Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); return nullptr; }
        PyObject* u = make_uuid(raw);
        if (!u) { Py_DECREF(bids); Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); return nullptr; }
        item = raw_new(g_BatchId);
        if (!item || raw_set(item, s_value, u) < 0) {
          Py_XDECREF(item); Py_DECREF(u); Py_DECREF(bids);
          Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv);
          return nullptr;
        }
        Py_DECREF(u);
      } else {
        item = Py_None;
        Py_INCREF(Py_None);
      }
      PyList_SET_ITEM(bids, i, item);  // steals
    }
  }
  PyObject* obj = raw_new(g_Decision);
  if (!obj || raw_set(obj, s_shards, sh) < 0 || raw_set(obj, s_phases, ph) < 0 ||
      raw_set(obj, s_vals, vv) < 0 || raw_set(obj, s_bids, bids) < 0) {
    Py_XDECREF(obj); Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); Py_DECREF(bids);
    return nullptr;
  }
  Py_DECREF(sh); Py_DECREF(ph); Py_DECREF(vv); Py_DECREF(bids);
  return obj;
}

// SyncResponse payload from a (decompressed) body reader
PyObject* decode_syncresp(Rd& r) {
  const uint8_t* q = r.take(17);  // u64 + u64 + u8 has_snapshot
  if (!q) return nullptr;
  PyObject* rp = PyLong_FromUnsignedLongLong(rd_u64(q));
  PyObject* sv = PyLong_FromUnsignedLongLong(rd_u64(q + 8));
  PyObject* snap = nullptr;
  PyObject *psp = nullptr, *ids = nullptr, *psv = nullptr;
  PyObject* obj = nullptr;
  do {
    if (!rp || !sv) break;
    if (q[16]) {
      const uint8_t* ln = r.take(4);
      if (!ln) break;
      uint32_t n = rd_u32(ln);
      const uint8_t* raw = r.take(n);
      if (!raw) break;
      snap = PyBytes_FromStringAndSize((const char*)raw, n);
    } else {
      snap = Py_None;
      Py_INCREF(Py_None);
    }
    if (!snap) break;
    // two u64 tuple sections + the (u32, uuid) applied_ids between them
    auto u64_tuple = [&r]() -> PyObject* {
      const uint8_t* ln = r.take(4);
      if (!ln) return nullptr;
      uint32_t n = rd_u32(ln);
      const uint8_t* raw = r.take((size_t)n * 8);
      if (!raw) return nullptr;
      PyObject* t = PyTuple_New(n);
      if (!t) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        PyObject* v = PyLong_FromUnsignedLongLong(rd_u64(raw + (size_t)i * 8));
        if (!v) { Py_DECREF(t); return nullptr; }
        PyTuple_SET_ITEM(t, i, v);
      }
      return t;
    };
    psp = u64_tuple();
    if (!psp) break;
    const uint8_t* ln = r.take(4);
    if (!ln) break;
    uint32_t n_ids = rd_u32(ln);
    const uint8_t* raw = r.take((size_t)n_ids * 20);
    if (!raw) break;
    ids = PyTuple_New(n_ids);
    if (!ids) break;
    bool bad = false;
    for (uint32_t i = 0; i < n_ids; i++) {
      const uint8_t* e = raw + (size_t)i * 20;
      PyObject* shard = PyLong_FromUnsignedLong(rd_u32(e));
      PyObject* u = shard ? make_uuid(e + 4) : nullptr;
      PyObject* bid = u ? raw_new(g_BatchId) : nullptr;
      if (!bid || raw_set(bid, s_value, u) < 0) {
        Py_XDECREF(bid); Py_XDECREF(u); Py_XDECREF(shard);
        bad = true; break;
      }
      Py_DECREF(u);
      PyObject* pair = PyTuple_New(2);
      if (!pair) {
        Py_DECREF(bid); Py_DECREF(shard);
        bad = true; break;
      }
      PyTuple_SET_ITEM(pair, 0, shard);  // steals
      PyTuple_SET_ITEM(pair, 1, bid);
      PyTuple_SET_ITEM(ids, i, pair);
    }
    if (bad) break;
    psv = u64_tuple();
    if (!psv) break;
    obj = raw_new(g_SyncResponse);
    if (!obj || raw_set(obj, s_responder_phase, rp) < 0 ||
        raw_set(obj, s_state_version, sv) < 0 ||
        raw_set(obj, s_snapshot, snap) < 0 ||
        raw_set(obj, s_per_shard_phase, psp) < 0 ||
        raw_set(obj, s_applied_ids, ids) < 0 ||
        raw_set(obj, s_per_shard_version, psv) < 0) {
      Py_XDECREF(obj);
      obj = nullptr;
      break;
    }
  } while (false);
  Py_XDECREF(rp); Py_XDECREF(sv); Py_XDECREF(snap);
  Py_XDECREF(psp); Py_XDECREF(ids); Py_XDECREF(psv);
  return obj;
}

// zlib-inflate a compressed body into a PyMem buffer (size unknown up
// front — snapshots compress 10x+; grow geometrically like Python's
// zlib.decompress). Returns nullptr with SerializationError set.
uint8_t* inflate_body(const uint8_t* src, size_t n, size_t* out_len) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    PyErr_SetString(g_SerializationError, "decompression failed: init");
    return nullptr;
  }
  size_t cap = n * 4 + 256;
  uint8_t* out = (uint8_t*)PyMem_Malloc(cap);
  if (!out) { inflateEnd(&zs); PyErr_NoMemory(); return nullptr; }
  zs.next_in = (Bytef*)src;
  zs.avail_in = (uInt)n;
  size_t have = 0;
  int rc;
  do {
    if (have == cap) {
      cap *= 2;
      uint8_t* np = (uint8_t*)PyMem_Realloc(out, cap);
      if (!np) { PyMem_Free(out); inflateEnd(&zs); PyErr_NoMemory(); return nullptr; }
      out = np;
    }
    zs.next_out = out + have;
    zs.avail_out = (uInt)(cap - have);
    rc = inflate(&zs, Z_NO_FLUSH);
    have = zs.total_out;
    if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) {
      PyMem_Free(out);
      inflateEnd(&zs);
      PyErr_Format(g_SerializationError, "decompression failed: %s",
                   zs.msg ? zs.msg : "corrupt stream");
      return nullptr;
    }
    if (rc == Z_BUF_ERROR && zs.avail_in == 0 && zs.avail_out > 0) {
      // truncated compressed data
      PyMem_Free(out);
      inflateEnd(&zs);
      PyErr_SetString(g_SerializationError,
                      "decompression failed: incomplete stream");
      return nullptr;
    }
  } while (rc != Z_STREAM_END);
  inflateEnd(&zs);
  *out_len = have;
  return out;
}

// frozen-dataclass carrier with two u64 fields (HeartBeat / SyncRequest)
PyObject* decode_two_u64(Rd& r, PyObject* cls, PyObject* f1, PyObject* f2) {
  const uint8_t* q = r.take(16);
  if (!q) return nullptr;
  PyObject* a = PyLong_FromUnsignedLongLong(rd_u64(q));
  PyObject* b = PyLong_FromUnsignedLongLong(rd_u64(q + 8));
  PyObject* obj = (a && b) ? raw_new(cls) : nullptr;
  if (!obj || raw_set(obj, f1, a) < 0 || raw_set(obj, f2, b) < 0) {
    Py_XDECREF(obj); Py_XDECREF(a); Py_XDECREF(b);
    return nullptr;
  }
  Py_DECREF(a); Py_DECREF(b);
  return obj;
}

PyObject* decode_block(Rd& r) {
  const uint8_t* braw = r.take(16);
  if (!braw) return nullptr;
  PyObject* bid = make_uuid(braw);
  if (!bid) return nullptr;
  const uint8_t* q = r.take(4);
  if (!q) { Py_DECREF(bid); return nullptr; }
  uint32_t k = rd_u32(q);
  const uint8_t* shr = r.take((size_t)k * 4);
  const uint8_t* slr = shr ? r.take((size_t)k * 8) : nullptr;
  const uint8_t* ctr = slr ? r.take((size_t)k * 4) : nullptr;
  const uint8_t* totr = ctr ? r.take(4) : nullptr;
  if (!totr) { Py_DECREF(bid); return nullptr; }
  uint32_t total = rd_u32(totr);
  const uint8_t* szr = r.take((size_t)total * 4);
  const uint8_t* dlenr = szr ? r.take(4) : nullptr;
  if (!dlenr) { Py_DECREF(bid); return nullptr; }
  uint32_t dlen = rd_u32(dlenr);
  const uint8_t* draw = r.take(dlen);
  const uint8_t* crcr = draw ? r.take(4) : nullptr;
  if (!crcr) { Py_DECREF(bid); return nullptr; }

  PyObject* data = PyBytes_FromStringAndSize((const char*)draw, dlen);
  if (!data) { Py_DECREF(bid); return nullptr; }
  bool ok = true;
  uint32_t crc = crc32_of(data, &ok);
  if (!ok) { Py_DECREF(bid); Py_DECREF(data); return nullptr; }
  if (crc != rd_u32(crcr)) {
    Py_DECREF(bid); Py_DECREF(data);
    PyErr_SetString(g_SerializationError, "block data checksum mismatch");
    return nullptr;
  }
  PyObject* sh = make_i64_array(k);
  PyObject* sl = make_i64_array(k);
  PyObject* ct = make_i64_array(k);
  PyObject* cs = make_i64_array(total);
  if (!sh || !sl || !ct || !cs) {
    Py_XDECREF(sh); Py_XDECREF(sl); Py_XDECREF(ct); Py_XDECREF(cs);
    Py_DECREF(bid); Py_DECREF(data);
    return nullptr;
  }
  int64_t* p;
  p = (int64_t*)PyArray_DATA((PyArrayObject*)sh);
  for (uint32_t i = 0; i < k; i++) p[i] = rd_u32(shr + 4 * i);
  p = (int64_t*)PyArray_DATA((PyArrayObject*)sl);
  for (uint32_t i = 0; i < k; i++) p[i] = (int64_t)rd_u64(slr + 8 * i);
  p = (int64_t*)PyArray_DATA((PyArrayObject*)ct);
  for (uint32_t i = 0; i < k; i++) p[i] = rd_u32(ctr + 4 * i);
  p = (int64_t*)PyArray_DATA((PyArrayObject*)cs);
  for (uint32_t i = 0; i < total; i++) p[i] = rd_u32(szr + 4 * i);

  // PayloadBlock validates shape/ordering invariants in __init__ — call
  // it normally; malformed content must raise SerializationError
  PyObject* blk = PyObject_CallFunctionObjArgs(
      g_PayloadBlock, bid, sh, sl, ct, cs, data, nullptr);
  Py_DECREF(bid); Py_DECREF(sh); Py_DECREF(sl); Py_DECREF(ct);
  Py_DECREF(cs); Py_DECREF(data);
  if (!blk) {
    PyObject *et, *ev, *tb;
    PyErr_Fetch(&et, &ev, &tb);
    PyErr_Format(g_SerializationError, "malformed block: %S",
                 ev ? ev : Py_None);
    Py_XDECREF(et); Py_XDECREF(ev); Py_XDECREF(tb);
    return nullptr;
  }
  PyObject* obj = raw_new(g_ProposeBlock);
  if (!obj || raw_set(obj, s_block, blk) < 0) {
    Py_XDECREF(obj); Py_DECREF(blk);
    return nullptr;
  }
  Py_DECREF(blk);
  return obj;
}

// CommandBatch from the wire (serialization.py _read_batch), checksum
// verified with the C crc32 while commands are built
PyObject* decode_batch(Rd& r) {
  const uint8_t* braw = r.take(16);
  if (!braw) return nullptr;
  PyObject* bid_u = make_uuid(braw);
  PyObject* bid = bid_u ? raw_new(g_BatchId) : nullptr;
  if (!bid || raw_set(bid, s_value, bid_u) < 0) {
    Py_XDECREF(bid); Py_XDECREF(bid_u);
    return nullptr;
  }
  Py_DECREF(bid_u);
  const uint8_t* fixed = r.take(8 + 4 + 4 + 4);
  if (!fixed) { Py_DECREF(bid); return nullptr; }
  double tsv;
  uint64_t bits = rd_u64(fixed);
  memcpy(&tsv, &bits, 8);
  uint32_t shard = rd_u32(fixed + 8);
  uint32_t checksum = rd_u32(fixed + 12);
  uint32_t n = rd_u32(fixed + 16);
  // bound the wire-controlled count by the remaining bytes BEFORE
  // allocating (every command needs >= 20 bytes: 16B id + u32 len) —
  // otherwise a short hostile frame forces a multi-GB tuple allocation
  if ((uint64_t)n * 20 > (uint64_t)(r.len - r.pos)) {
    Py_DECREF(bid);
    PyErr_Format(g_SerializationError,
                 "truncated batch: %u commands in %zu bytes", n,
                 r.len - r.pos);
    return nullptr;
  }
  PyObject* cmds = PyTuple_New((Py_ssize_t)n);
  if (!cmds) { Py_DECREF(bid); return nullptr; }
  uint32_t crc = 0;
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* idr = r.take(16);
    const uint8_t* lenr = idr ? r.take(4) : nullptr;
    if (!lenr) { Py_DECREF(bid); Py_DECREF(cmds); return nullptr; }
    uint32_t dlen = rd_u32(lenr);
    const uint8_t* draw = r.take(dlen);
    if (!draw) { Py_DECREF(bid); Py_DECREF(cmds); return nullptr; }
    crc = crc32_run(crc, idr, 16);
    crc = crc32_run(crc, draw, dlen);
    PyObject* cid = make_uuid(idr);
    PyObject* data =
        cid ? PyBytes_FromStringAndSize((const char*)draw, dlen) : nullptr;
    PyObject* cmd = data ? raw_new(g_Command) : nullptr;
    if (!cmd || raw_set(cmd, s_id, cid) < 0 ||
        raw_set(cmd, s_data, data) < 0) {
      Py_XDECREF(cmd); Py_XDECREF(data); Py_XDECREF(cid);
      Py_DECREF(bid); Py_DECREF(cmds);
      return nullptr;
    }
    Py_DECREF(cid); Py_DECREF(data);
    PyTuple_SET_ITEM(cmds, i, cmd);  // steals
  }
  if (crc != checksum) {
    Py_DECREF(bid); Py_DECREF(cmds);
    PyErr_SetString(g_SerializationError,
                    "batch checksum mismatch on decode");
    return nullptr;
  }
  PyObject* shard_obj = raw_new(g_ShardId);
  PyObject* shard_val = PyLong_FromUnsignedLong(shard);
  PyObject* ts = PyFloat_FromDouble(tsv);
  PyObject* batch =
      (shard_obj && shard_val && ts) ? raw_new(g_CommandBatch) : nullptr;
  if (!batch || raw_set(shard_obj, s_value, shard_val) < 0 ||
      raw_set(batch, s_id, bid) < 0 ||
      raw_set(batch, s_commands, cmds) < 0 ||
      raw_set(batch, s_timestamp, ts) < 0 ||
      raw_set(batch, s_shard, shard_obj) < 0) {
    Py_XDECREF(batch); Py_XDECREF(shard_obj); Py_XDECREF(shard_val);
    Py_XDECREF(ts); Py_DECREF(bid); Py_DECREF(cmds);
    return nullptr;
  }
  Py_DECREF(shard_obj); Py_DECREF(shard_val); Py_DECREF(ts);
  Py_DECREF(bid); Py_DECREF(cmds);
  return batch;
}

PyObject* decode_propose(Rd& r) {
  const uint8_t* fixed = r.take(4 + 8 + 16 + 1 + 1);
  if (!fixed) return nullptr;
  uint32_t shard = rd_u32(fixed);
  uint64_t phase = rd_u64(fixed + 4);
  const uint8_t* bidr = fixed + 12;
  uint8_t code = fixed[28];
  uint8_t has_batch = fixed[29];
  PyObject* batch;
  if (has_batch) {
    batch = decode_batch(r);
    if (!batch) return nullptr;
  } else {
    batch = Py_None;
    Py_INCREF(Py_None);
  }
  PyObject* bid_u = make_uuid(bidr);
  PyObject* bid = bid_u ? raw_new(g_BatchId) : nullptr;
  if (!bid || raw_set(bid, s_value, bid_u) < 0) {
    Py_XDECREF(bid); Py_XDECREF(bid_u); Py_DECREF(batch);
    return nullptr;
  }
  Py_DECREF(bid_u);
  // StateValue(code) through the enum class: invalid codes raise exactly
  // what the Python decoder would (ValueError), preserving error parity
  PyObject* sval = PyObject_CallFunction(g_StateValue, "i", (int)code);
  PyObject* shard_obj = sval ? PyLong_FromUnsignedLong(shard) : nullptr;
  PyObject* phase_obj = shard_obj ? PyLong_FromUnsignedLongLong(phase) : nullptr;
  PyObject* obj = phase_obj ? raw_new(g_Propose) : nullptr;
  if (!obj || raw_set(obj, s_shard, shard_obj) < 0 ||
      raw_set(obj, s_phase, phase_obj) < 0 ||
      raw_set(obj, s_batch_id, bid) < 0 ||
      raw_set(obj, s_value, sval) < 0 ||
      raw_set(obj, s_batch, batch) < 0) {
    Py_XDECREF(obj); Py_XDECREF(phase_obj); Py_XDECREF(shard_obj);
    Py_XDECREF(sval); Py_DECREF(bid); Py_DECREF(batch);
    return nullptr;
  }
  Py_DECREF(phase_obj); Py_DECREF(shard_obj); Py_DECREF(sval);
  Py_DECREF(bid); Py_DECREF(batch);
  return obj;
}

PyObject* decode_newbatch(Rd& r) {
  const uint8_t* q = r.take(4);
  if (!q) return nullptr;
  uint32_t shard = rd_u32(q);
  PyObject* batch = decode_batch(r);
  if (!batch) return nullptr;
  PyObject* shard_obj = PyLong_FromUnsignedLong(shard);
  PyObject* obj = shard_obj ? raw_new(g_NewBatch) : nullptr;
  if (!obj || raw_set(obj, s_shard, shard_obj) < 0 ||
      raw_set(obj, s_batch, batch) < 0) {
    Py_XDECREF(obj); Py_XDECREF(shard_obj); Py_DECREF(batch);
    return nullptr;
  }
  Py_DECREF(shard_obj); Py_DECREF(batch);
  return obj;
}

// --- client gateway frame decoders ----------------------------------------

// u32 count + count * (u32 len + bytes) -> tuple of bytes
PyObject* decode_blob_tuple(Rd& r) {
  const uint8_t* q = r.take(4);
  if (!q) return nullptr;
  uint32_t n = rd_u32(q);
  // bound the wire-controlled count by the remaining bytes BEFORE
  // allocating (every blob needs >= 4 length bytes)
  if ((uint64_t)n * 4 > (uint64_t)(r.len - r.pos)) {
    PyErr_Format(g_SerializationError,
                 "truncated blob tuple: %u entries in %zu bytes", n,
                 r.len - r.pos);
    return nullptr;
  }
  PyObject* t = PyTuple_New((Py_ssize_t)n);
  if (!t) return nullptr;
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* ln = r.take(4);
    if (!ln) { Py_DECREF(t); return nullptr; }
    uint32_t dlen = rd_u32(ln);
    const uint8_t* raw = r.take(dlen);
    if (!raw) { Py_DECREF(t); return nullptr; }
    PyObject* blob = PyBytes_FromStringAndSize((const char*)raw, dlen);
    if (!blob) { Py_DECREF(t); return nullptr; }
    PyTuple_SET_ITEM(t, i, blob);  // steals
  }
  return t;
}

// u32 count + count * u64 -> tuple of ints
PyObject* decode_u64_tuple(Rd& r) {
  const uint8_t* ln = r.take(4);
  if (!ln) return nullptr;
  uint32_t n = rd_u32(ln);
  const uint8_t* raw = r.take((size_t)n * 8);
  if (!raw) return nullptr;
  PyObject* t = PyTuple_New((Py_ssize_t)n);
  if (!t) return nullptr;
  for (uint32_t i = 0; i < n; i++) {
    PyObject* v = PyLong_FromUnsignedLongLong(rd_u64(raw + (size_t)i * 8));
    if (!v) { Py_DECREF(t); return nullptr; }
    PyTuple_SET_ITEM(t, i, v);
  }
  return t;
}

PyObject* decode_client_hello(Rd& r) {
  const uint8_t* q = r.take(1 + 16 + 8 + 4);
  if (!q) return nullptr;
  PyObject* ack = PyBool_FromLong(q[0]);
  PyObject* cid = make_uuid(q + 1);
  PyObject* ls = PyLong_FromUnsignedLongLong(rd_u64(q + 17));
  PyObject* mi = PyLong_FromUnsignedLong(rd_u32(q + 25));
  PyObject* obj = (ack && cid && ls && mi) ? raw_new(g_ClientHello) : nullptr;
  if (!obj || raw_set(obj, s_client_id, cid) < 0 ||
      raw_set(obj, s_ack, ack) < 0 || raw_set(obj, s_last_seq, ls) < 0 ||
      raw_set(obj, s_max_inflight, mi) < 0) {
    Py_XDECREF(obj); Py_XDECREF(ack); Py_XDECREF(cid);
    Py_XDECREF(ls); Py_XDECREF(mi);
    return nullptr;
  }
  Py_DECREF(ack); Py_DECREF(cid); Py_DECREF(ls); Py_DECREF(mi);
  return obj;
}

PyObject* decode_submit(Rd& r) {
  const uint8_t* q = r.take(16 + 8 + 4 + 8);
  if (!q) return nullptr;
  PyObject* cid = make_uuid(q);
  PyObject* seq = PyLong_FromUnsignedLongLong(rd_u64(q + 16));
  PyObject* shard = PyLong_FromUnsignedLong(rd_u32(q + 24));
  PyObject* au = PyLong_FromUnsignedLongLong(rd_u64(q + 28));
  PyObject* cmds =
      (cid && seq && shard && au) ? decode_blob_tuple(r) : nullptr;
  PyObject* obj = cmds ? raw_new(g_Submit) : nullptr;
  if (!obj || raw_set(obj, s_client_id, cid) < 0 ||
      raw_set(obj, s_seq, seq) < 0 || raw_set(obj, s_shard, shard) < 0 ||
      raw_set(obj, s_commands, cmds) < 0 ||
      raw_set(obj, s_ack_upto, au) < 0) {
    Py_XDECREF(obj); Py_XDECREF(cid); Py_XDECREF(seq);
    Py_XDECREF(shard); Py_XDECREF(au); Py_XDECREF(cmds);
    return nullptr;
  }
  Py_DECREF(cid); Py_DECREF(seq); Py_DECREF(shard);
  Py_DECREF(au); Py_DECREF(cmds);
  return obj;
}

PyObject* decode_result(Rd& r) {
  const uint8_t* q = r.take(16 + 8 + 1);
  if (!q) return nullptr;
  PyObject* cid = make_uuid(q);
  PyObject* seq = PyLong_FromUnsignedLongLong(rd_u64(q + 16));
  PyObject* status = PyLong_FromLong(q[24]);
  PyObject* pl = (cid && seq && status) ? decode_blob_tuple(r) : nullptr;
  PyObject* obj = pl ? raw_new(g_Result) : nullptr;
  if (!obj || raw_set(obj, s_client_id, cid) < 0 ||
      raw_set(obj, s_seq, seq) < 0 || raw_set(obj, s_status, status) < 0 ||
      raw_set(obj, s_payload, pl) < 0) {
    Py_XDECREF(obj); Py_XDECREF(cid); Py_XDECREF(seq);
    Py_XDECREF(status); Py_XDECREF(pl);
    return nullptr;
  }
  Py_DECREF(cid); Py_DECREF(seq); Py_DECREF(status); Py_DECREF(pl);
  return obj;
}

PyObject* decode_read_index(Rd& r) {
  const uint8_t* q = r.take(1 + 16 + 8 + 4);
  if (!q) return nullptr;
  PyObject* mode = PyLong_FromLong(q[0]);
  PyObject* cid = make_uuid(q + 1);
  PyObject* seq = PyLong_FromUnsignedLongLong(rd_u64(q + 17));
  PyObject* shard = PyLong_FromUnsignedLong(rd_u32(q + 25));
  PyObject* key = nullptr;
  if (mode && cid && seq && shard) {
    const uint8_t* ln = r.take(4);
    const uint8_t* raw = ln ? r.take(rd_u32(ln)) : nullptr;
    if (raw)
      key = PyBytes_FromStringAndSize((const char*)raw,
                                      (Py_ssize_t)rd_u32(ln));
  }
  PyObject* fr = key ? decode_u64_tuple(r) : nullptr;
  PyObject* obj = fr ? raw_new(g_ReadIndex) : nullptr;
  if (!obj || raw_set(obj, s_mode, mode) < 0 ||
      raw_set(obj, s_client_id, cid) < 0 || raw_set(obj, s_seq, seq) < 0 ||
      raw_set(obj, s_shard, shard) < 0 || raw_set(obj, s_key, key) < 0 ||
      raw_set(obj, s_frontier, fr) < 0) {
    Py_XDECREF(obj); Py_XDECREF(mode); Py_XDECREF(cid); Py_XDECREF(seq);
    Py_XDECREF(shard); Py_XDECREF(key); Py_XDECREF(fr);
    return nullptr;
  }
  Py_DECREF(mode); Py_DECREF(cid); Py_DECREF(seq);
  Py_DECREF(shard); Py_DECREF(key); Py_DECREF(fr);
  return obj;
}

// --- entry points ---------------------------------------------------------

PyObject* codec_encode(PyObject*, PyObject* args) {
  PyObject* msg;
  Py_ssize_t compress_threshold = 0;
  if (!PyArg_ParseTuple(args, "O|n", &msg, &compress_threshold))
    return nullptr;
  if (!g_ProtocolMessage) {
    PyErr_SetString(PyExc_RuntimeError, "codec not bound");
    return nullptr;
  }
  PyObject* payload = PyObject_GetAttr(msg, s_payload);
  if (!payload) return nullptr;
  PyTypeObject* pt = Py_TYPE(payload);
  uint8_t mt;
  if (pt == (PyTypeObject*)g_VoteRound1) mt = MT_VOTE1;
  else if (pt == (PyTypeObject*)g_VoteRound2) mt = MT_VOTE2;
  else if (pt == (PyTypeObject*)g_Decision) mt = MT_DECISION;
  else if (pt == (PyTypeObject*)g_HeartBeat) mt = MT_HEARTBEAT;
  else if (pt == (PyTypeObject*)g_SyncRequest) mt = MT_SYNCREQ;
  else if (pt == (PyTypeObject*)g_SyncResponse) mt = MT_SYNCRESP;
  else if (pt == (PyTypeObject*)g_ProposeBlock) mt = MT_PROPOSE_BLOCK;
  else if (pt == (PyTypeObject*)g_Propose) mt = MT_PROPOSE;
  else if (pt == (PyTypeObject*)g_NewBatch) mt = MT_NEWBATCH;
  else if (pt == (PyTypeObject*)g_ClientHello) mt = MT_CLIENT_HELLO;
  else if (pt == (PyTypeObject*)g_Submit) mt = MT_SUBMIT;
  else if (pt == (PyTypeObject*)g_Result) mt = MT_RESULT;
  else if (pt == (PyTypeObject*)g_ReadIndex) mt = MT_READ_INDEX;
  else {
    Py_DECREF(payload);
    Py_RETURN_NONE;  // unsupported: Python codec handles it
  }
  if (mt == MT_PROPOSE || mt == MT_NEWBATCH) {
    PyObject* batch = PyObject_GetAttr(payload, s_batch);
    if (!batch) { Py_DECREF(payload); return nullptr; }
    Py_ssize_t bsize = batch_body_size(batch);
    bool ok_batch =
        bsize >= 0 && (batch != Py_None || mt == MT_PROPOSE) &&
        attr_fits(payload, s_shard, 0xFFFFFFFFull,
                  /*allow_wrapper=*/false) &&
        (mt != MT_PROPOSE ||
         attr_fits(payload, s_phase, ~0ull, /*allow_wrapper=*/false));
    Py_DECREF(batch);
    Py_ssize_t body_size =
        (mt == MT_PROPOSE ? 4 + 8 + 16 + 1 + 1 : 4) + bsize;
    if (!ok_batch ||
        (compress_threshold > 0 && body_size > compress_threshold)) {
      // odd batch content, or large enough that the Python codec may
      // compress it: the Python path owns the frame
      Py_DECREF(payload);
      Py_RETURN_NONE;
    }
  }
  if (mt == MT_DECISION) {
    // encode_decision indexes bids with PyList_GET_ITEM; a non-list
    // sequence (Decision.__init__ accepts any sized iterable) must
    // fall back to the Python codec, not be reinterpreted as a list
    PyObject* bids = PyObject_GetAttr(payload, s_bids);
    if (!bids) { Py_DECREF(payload); return nullptr; }
    bool ok_bids = bids == Py_None || PyList_Check(bids);
    Py_DECREF(bids);
    if (!ok_bids) {
      Py_DECREF(payload);
      Py_RETURN_NONE;
    }
  }

  bool decline = false;  // shape surprise: Python codec owns the frame
  PyObject* mid = PyObject_GetAttr(msg, s_id);
  PyObject* sender = mid ? PyObject_GetAttr(msg, s_sender) : nullptr;
  PyObject* recipient = sender ? PyObject_GetAttr(msg, s_recipient) : nullptr;
  PyObject* ts = recipient ? PyObject_GetAttr(msg, s_timestamp) : nullptr;
  PyObject* out = nullptr;
  if (ts) {
    double tsv = PyFloat_AsDouble(ts);
    if (!(tsv == -1.0 && PyErr_Occurred())) {
      Buf env;
      uint8_t flags = (recipient != Py_None) ? FLAG_HAS_RECIPIENT : 0;
      bool ok = env.put_u8(WIRE_VERSION) && env.put_u8(mt) && env.put_u8(flags);
      uint8_t raw[16];
      ok = ok && uuid_bytes(mid, raw) && env.put_raw(raw, 16);
      if (ok) {
        PyObject* sval = PyObject_GetAttr(sender, s_value);
        ok = sval && uuid_bytes(sval, raw) && env.put_raw(raw, 16);
        Py_XDECREF(sval);
      }
      if (ok && recipient != Py_None) {
        PyObject* rval = PyObject_GetAttr(recipient, s_value);
        ok = rval && uuid_bytes(rval, raw) && env.put_raw(raw, 16);
        Py_XDECREF(rval);
      }
      if (ok) {
        uint64_t bits;
        memcpy(&bits, &tsv, 8);
        ok = env.put_u64(bits);
      }
      if (ok) {
        Buf body;
        switch (mt) {
          case MT_VOTE1:
          case MT_VOTE2: ok = encode_votes(body, payload); break;
          case MT_DECISION: ok = encode_decision(body, payload); break;
          case MT_PROPOSE: ok = encode_propose(body, payload); break;
          case MT_NEWBATCH: ok = encode_newbatch(body, payload); break;
          case MT_HEARTBEAT:
            ok = put_u64_attr(body, payload, s_current_phase) &&
                 put_u64_attr(body, payload, s_committed_phase);
            break;
          case MT_SYNCREQ:
            ok = put_u64_attr(body, payload, s_current_phase) &&
                 put_u64_attr(body, payload, s_state_version);
            break;
          case MT_SYNCRESP:
            ok = encode_syncresp(body, payload, &decline);
            break;
          case MT_PROPOSE_BLOCK: ok = encode_block(body, payload); break;
          case MT_CLIENT_HELLO:
            ok = encode_client_hello(body, payload, &decline);
            break;
          case MT_SUBMIT: ok = encode_submit(body, payload, &decline); break;
          case MT_RESULT: ok = encode_result(body, payload, &decline); break;
          case MT_READ_INDEX:
            ok = encode_read_index(body, payload, &decline);
            break;
        }
        bool body_done = false;
        if (ok && mt == MT_SYNCRESP && compress_threshold > 0 &&
            (Py_ssize_t)body.len > compress_threshold) {
          // same rule as _serialize_py: zlib level 1, keep only if it
          // actually shrinks (byte parity pinned by test_native_codec)
          uLongf clen = compressBound((uLong)body.len);
          uint8_t* cbuf = (uint8_t*)PyMem_Malloc(clen);
          if (!cbuf) {
            ok = false;
            PyErr_NoMemory();
          } else {
            if (compress2(cbuf, &clen, body.p, (uLong)body.len, 1) == Z_OK &&
                (size_t)clen < body.len) {
              env.p[2] |= FLAG_COMPRESSED;  // flags byte of the envelope
              ok = env.put_u32((uint32_t)clen) && env.put_raw(cbuf, clen);
              body_done = true;
            }
            PyMem_Free(cbuf);
          }
        }
        if (ok && !body_done)
          ok = env.put_u32((uint32_t)body.len) &&
               env.put_raw(body.p, body.len);
        if (ok && !decline)
          out = PyBytes_FromStringAndSize((const char*)env.p,
                                          (Py_ssize_t)env.len);
      }
      if (!ok && !decline && !PyErr_Occurred())
        PyErr_SetString(g_SerializationError, "native encode failed");
    }
  }
  Py_XDECREF(ts); Py_XDECREF(recipient); Py_XDECREF(sender);
  Py_XDECREF(mid); Py_DECREF(payload);
  if (decline && !out && !PyErr_Occurred()) {
    // shape surprise: hand the frame to the Python codec untouched
    out = Py_None;
    Py_INCREF(Py_None);
  }
  return out;
}

PyObject* codec_decode(PyObject*, PyObject* arg) {
  if (!g_ProtocolMessage) {
    PyErr_SetString(PyExc_RuntimeError, "codec not bound");
    return nullptr;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
  Rd r{(const uint8_t*)view.buf, (size_t)view.len};
  PyObject* result = nullptr;
  PyObject* payload = nullptr;
  PyObject *mid = nullptr, *sender = nullptr, *recipient = nullptr,
           *tsobj = nullptr;
  uint8_t* inflated = nullptr;
  do {
    const uint8_t* h = r.take(3);
    if (!h) break;
    uint8_t version = h[0], mt = h[1], flags = h[2];
    if (version != WIRE_VERSION) {
      PyErr_Format(g_SerializationError, "unsupported wire version %d",
                   (int)version);
      break;
    }
    bool supported =
        (mt == MT_VOTE1 || mt == MT_VOTE2 || mt == MT_DECISION ||
         mt == MT_HEARTBEAT || mt == MT_SYNCREQ || mt == MT_SYNCRESP ||
         mt == MT_PROPOSE_BLOCK || mt == MT_PROPOSE || mt == MT_NEWBATCH ||
         mt == MT_CLIENT_HELLO || mt == MT_SUBMIT || mt == MT_RESULT ||
         mt == MT_READ_INDEX) &&
        (!(flags & FLAG_COMPRESSED) || mt == MT_SYNCRESP);
    if (!supported) {
      // Python codec owns the remaining types / compressed bodies
      result = Py_None;
      Py_INCREF(Py_None);
      break;
    }
    const uint8_t* idr = r.take(16);
    if (!idr) break;
    mid = make_uuid(idr);
    if (!mid) break;
    const uint8_t* sndr = r.take(16);
    if (!sndr) break;
    sender = intern_node(sndr);
    if (!sender) break;
    if (flags & FLAG_HAS_RECIPIENT) {
      const uint8_t* rcp = r.take(16);
      if (!rcp) break;
      recipient = intern_node(rcp);
      if (!recipient) break;
    } else {
      recipient = Py_None;
      Py_INCREF(Py_None);
    }
    const uint8_t* tsr = r.take(8);
    if (!tsr) break;
    double tsv;
    uint64_t bits = rd_u64(tsr);
    memcpy(&tsv, &bits, 8);
    tsobj = PyFloat_FromDouble(tsv);
    if (!tsobj) break;
    const uint8_t* blr = r.take(4);
    if (!blr) break;
    uint32_t body_len = rd_u32(blr);
    const uint8_t* body = r.take(body_len);
    if (!body) break;
    Rd br{body, body_len};
    if (flags & FLAG_COMPRESSED) {  // only MT_SYNCRESP reaches here
      size_t ilen = 0;
      inflated = inflate_body(body, body_len, &ilen);
      if (!inflated) break;
      br = Rd{inflated, ilen};
    }
    switch (mt) {
      case MT_VOTE1: payload = decode_votes(br, g_VoteRound1); break;
      case MT_VOTE2: payload = decode_votes(br, g_VoteRound2); break;
      case MT_DECISION: payload = decode_decision(br); break;
      case MT_HEARTBEAT:
        payload = decode_two_u64(br, g_HeartBeat, s_current_phase,
                                 s_committed_phase);
        break;
      case MT_SYNCREQ:
        payload = decode_two_u64(br, g_SyncRequest, s_current_phase,
                                 s_state_version);
        break;
      case MT_SYNCRESP: payload = decode_syncresp(br); break;
      case MT_PROPOSE_BLOCK: payload = decode_block(br); break;
      case MT_PROPOSE: payload = decode_propose(br); break;
      case MT_NEWBATCH: payload = decode_newbatch(br); break;
      case MT_CLIENT_HELLO: payload = decode_client_hello(br); break;
      case MT_SUBMIT: payload = decode_submit(br); break;
      case MT_RESULT: payload = decode_result(br); break;
      case MT_READ_INDEX: payload = decode_read_index(br); break;
    }
    if (!payload) break;
    PyObject* msg = raw_new(g_ProtocolMessage);
    if (!msg || raw_set(msg, s_id, mid) < 0 ||
        raw_set(msg, s_sender, sender) < 0 ||
        raw_set(msg, s_recipient, recipient) < 0 ||
        raw_set(msg, s_timestamp, tsobj) < 0 ||
        raw_set(msg, s_payload, payload) < 0) {
      Py_XDECREF(msg);
      break;
    }
    result = msg;
  } while (false);
  Py_XDECREF(payload); Py_XDECREF(mid); Py_XDECREF(sender);
  Py_XDECREF(recipient); Py_XDECREF(tsobj);
  if (inflated) PyMem_Free(inflated);
  PyBuffer_Release(&view);
  return result;
}

PyObject* codec_bind(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {
      "ProtocolMessage", "VoteRound1", "VoteRound2", "Decision",
      "HeartBeat", "SyncRequest", "ProposeBlock", "PayloadBlock",
      "NodeId", "BatchId", "UUID", "safe_unknown", "SerializationError",
      "crc32", "Propose", "NewBatch", "CommandBatch", "Command",
      "ShardId", "StateValue", "SyncResponse", "ClientHello", "Submit",
      "Result", "ReadIndex", nullptr};
  PyObject *pm, *v1, *v2, *dc, *hb, *sr, *pb, *plb, *nid, *bid, *uu, *su,
      *se, *crc, *pr, *nb, *cb, *cm, *si, *sv, *srp, *ch, *sb, *rs, *ri;
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "OOOOOOOOOOOOOOOOOOOOOOOOO", (char**)kwlist, &pm,
          &v1, &v2, &dc, &hb, &sr, &pb, &plb, &nid, &bid, &uu, &su, &se,
          &crc, &pr, &nb, &cb, &cm, &si, &sv, &srp, &ch, &sb, &rs, &ri))
    return nullptr;
#define BIND(slot, val) Py_XDECREF(slot); Py_INCREF(val); slot = val
  BIND(g_ProtocolMessage, pm); BIND(g_VoteRound1, v1); BIND(g_VoteRound2, v2);
  BIND(g_Decision, dc); BIND(g_HeartBeat, hb); BIND(g_SyncRequest, sr);
  BIND(g_ProposeBlock, pb); BIND(g_PayloadBlock, plb); BIND(g_NodeId, nid);
  BIND(g_BatchId, bid); BIND(g_UUID, uu); BIND(g_safe_unknown, su);
  BIND(g_SerializationError, se); BIND(g_crc32, crc);
  BIND(g_Propose, pr); BIND(g_NewBatch, nb); BIND(g_CommandBatch, cb);
  BIND(g_Command, cm); BIND(g_ShardId, si); BIND(g_StateValue, sv);
  BIND(g_SyncResponse, srp); BIND(g_ClientHello, ch); BIND(g_Submit, sb);
  BIND(g_Result, rs); BIND(g_ReadIndex, ri);
#undef BIND
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"bind", (PyCFunction)codec_bind, METH_VARARGS | METH_KEYWORDS,
     "Bind the Python message classes the codec builds/reads."},
    {"encode", codec_encode, METH_VARARGS,
     "encode(msg, compress_threshold=0): serialize a ProtocolMessage; "
     "None if the type is not fast-pathed (or would compress)."},
    {"decode", codec_decode, METH_O,
     "Deserialize wire bytes; None if the type is not fast-pathed."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                         "rabia_torch_native_codec",
                         "Native binary codec for protocol hot frames",
                         -1,
                         methods,
                         nullptr,
                         nullptr,
                         nullptr,
                         nullptr};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit_rabia_torch_native_codec(void) {
  import_array();
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  g_node_intern = PyDict_New();
  g_empty_tuple = PyTuple_New(0);
#define INTERN(var, name) var = PyUnicode_InternFromString(name)
  INTERN(s_payload, "payload"); INTERN(s_id, "id"); INTERN(s_sender, "sender");
  INTERN(s_recipient, "recipient"); INTERN(s_timestamp, "timestamp");
  INTERN(s_value, "value"); INTERN(s_int, "int"); INTERN(s_is_safe, "is_safe");
  INTERN(s_shards, "shards"); INTERN(s_phases, "phases");
  INTERN(s_vals, "vals"); INTERN(s_bids, "bids");
  INTERN(s_current_phase, "current_phase");
  INTERN(s_committed_phase, "committed_phase");
  INTERN(s_state_version, "state_version"); INTERN(s_block, "block");
  INTERN(s_slots, "slots"); INTERN(s_counts, "counts");
  INTERN(s_cmd_sizes, "cmd_sizes"); INTERN(s_data, "data");
  INTERN(s_total_commands, "total_commands");
  INTERN(s_shard, "shard"); INTERN(s_phase, "phase");
  INTERN(s_batch_id, "batch_id"); INTERN(s_batch, "batch");
  INTERN(s_commands, "commands");
  INTERN(s_responder_phase, "responder_phase"); INTERN(s_snapshot, "snapshot");
  INTERN(s_per_shard_phase, "per_shard_phase");
  INTERN(s_applied_ids, "applied_ids");
  INTERN(s_per_shard_version, "per_shard_version");
  INTERN(s_client_id, "client_id"); INTERN(s_seq, "seq");
  INTERN(s_ack, "ack"); INTERN(s_last_seq, "last_seq");
  INTERN(s_max_inflight, "max_inflight"); INTERN(s_ack_upto, "ack_upto");
  INTERN(s_status, "status"); INTERN(s_mode, "mode");
  INTERN(s_key, "key"); INTERN(s_frontier, "frontier");
#undef INTERN
  return m;
}
