// Keyed BLAKE2b with an 8-byte digest, for the prefetcher's row digests.
//
// BLAKE2b as RFC 7693 specifies it (its Appendix C reference code, with
// whole-block copies in the update). row_digest gives the bytes that
// Python's hashlib.blake2b(digest_size=8, key=key) gives after update(image
// row) and update(label row), so a batch's XOR of them is
// datapath/audit.py's batch_digest.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace tpu_ddp_native {

struct Blake2b {
  uint64_t h[8];
  uint64_t t[2] = {0, 0};
  uint8_t b[128];
  size_t c = 0;
  size_t outlen;

  static constexpr uint64_t kIv[8] = {
      0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
      0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
      0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

  static uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

  static uint64_t load64(const uint8_t* p) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
#else
    uint64_t v = 0;
    for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
    return v;
#endif
  }

  Blake2b(size_t out_bytes, const uint8_t* key, size_t key_bytes) : outlen(out_bytes) {
    for (int i = 0; i < 8; ++i) h[i] = kIv[i];
    h[0] ^= 0x01010000ULL ^ (uint64_t(key_bytes) << 8) ^ uint64_t(out_bytes);
    std::memset(b, 0, sizeof b);
    if (key_bytes > 0) {
      update(key, key_bytes);
      c = 128;  // the key is a whole block of its own
    }
  }

  void compress(bool last) {
    static constexpr uint8_t sigma[12][16] = {
        {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
        {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
        {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
        {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
        {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
        {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
        {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
        {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
        {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
        {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
        {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
        {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};
    uint64_t v[16], m[16];
    for (int i = 0; i < 8; ++i) {
      v[i] = h[i];
      v[i + 8] = kIv[i];
    }
    v[12] ^= t[0];
    v[13] ^= t[1];
    if (last) v[14] = ~v[14];
    for (int i = 0; i < 16; ++i) m[i] = load64(b + 8 * i);
    auto g = [&](int a, int bb, int cc, int d, uint64_t x, uint64_t y) {
      v[a] = v[a] + v[bb] + x;
      v[d] = rotr(v[d] ^ v[a], 32);
      v[cc] = v[cc] + v[d];
      v[bb] = rotr(v[bb] ^ v[cc], 24);
      v[a] = v[a] + v[bb] + y;
      v[d] = rotr(v[d] ^ v[a], 16);
      v[cc] = v[cc] + v[d];
      v[bb] = rotr(v[bb] ^ v[cc], 63);
    };
    for (int r = 0; r < 12; ++r) {
      const uint8_t* s = sigma[r];
      g(0, 4, 8, 12, m[s[0]], m[s[1]]);
      g(1, 5, 9, 13, m[s[2]], m[s[3]]);
      g(2, 6, 10, 14, m[s[4]], m[s[5]]);
      g(3, 7, 11, 15, m[s[6]], m[s[7]]);
      g(0, 5, 10, 15, m[s[8]], m[s[9]]);
      g(1, 6, 11, 12, m[s[10]], m[s[11]]);
      g(2, 7, 8, 13, m[s[12]], m[s[13]]);
      g(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
  }

  // a full buffer is compressed only once more input arrives, so that the
  // last block is the one final() compresses with the last-block flag
  void update(const uint8_t* in, size_t n) {
    while (n > 0) {
      if (c == 128) {
        t[0] += 128;
        if (t[0] < 128) ++t[1];
        compress(false);
        c = 0;
      }
      size_t take = 128 - c < n ? 128 - c : n;
      std::memcpy(b + c, in, take);
      c += take;
      in += take;
      n -= take;
    }
  }

  void final(uint8_t* out) {
    t[0] += c;
    if (t[0] < c) ++t[1];
    std::memset(b + c, 0, 128 - c);
    compress(true);
    for (size_t i = 0; i < outlen; ++i) out[i] = uint8_t(h[i >> 3] >> (8 * (i & 7)));
  }
};

// The 8 digest bytes of one row: keyed with the 8 little-endian bytes of
// key, over the image row's bytes and then the label row's.
inline void row_digest(uint64_t key, const uint8_t* img, size_t img_bytes,
                       const uint8_t* lbl, size_t lbl_bytes, uint8_t* out) {
  uint8_t k[8];
  for (int i = 0; i < 8; ++i) k[i] = uint8_t(key >> (8 * i));
  Blake2b s(8, k, 8);
  s.update(img, img_bytes);
  s.update(lbl, lbl_bytes);
  s.final(out);
}

}  // namespace tpu_ddp_native
