// The device lane's window pack gather, on the host CPU: C++ for g++,
// behind a plain C interface (loaded with ctypes by
// rabia_tpu_torch/apps/device_kv.py).
//
// A copy of the reference's rk_pack_gather (rabia_tpu/native/
// hostkernel.cpp). It serves only the GRID shape of a window: full-width
// sorted blocks, where op i covers wave i / n and shard i % n. One pass
// copies each op's key bytes and value bytes into the zeroed, padded
// planes kwin u8[W, S, ku] and vwin u8[W, S, vu], in place of numpy's
// gather, mask and scatter (about four passes over the op bytes).
// Validation stays in Python, where the numpy gather owns the semantics;
// this function trusts only its own bounds check and returns nonzero on
// any op out of range, so that the caller re-zeroes the planes and hands
// the window to the numpy gather.
#include <stdint.h>
#include <string.h>

extern "C" int32_t hp_pack_gather(
    const uint8_t* dbuf, int64_t dbuf_len,
    const int64_t* off, const int64_t* klen, const int64_t* vlen,
    int64_t n_ops, int64_t n, int64_t S, int64_t hdr,
    int64_t ku, int64_t vu,
    uint8_t* kwin, uint8_t* vwin) {
  for (int64_t i = 0; i < n_ops; i++) {
    const int64_t kl = klen[i];
    const int64_t vl = vlen[i];
    const int64_t o = off[i] + hdr;
    if (kl < 0 || vl < 0 || kl > ku || vl > vu || o < 0 ||
        o + kl + vl > dbuf_len) {
      return 1;  // out of the envelope or the buffer: the numpy gather takes it
    }
    const int64_t row = (i / n) * S + (i % n);
    memcpy(kwin + row * ku, dbuf + o, (size_t)kl);
    memcpy(vwin + row * vu, dbuf + o + kl, (size_t)vl);
  }
  return 0;
}
