// Byte-oriented rANS range coder with escape/bypass coding.
//
// Native replacement for the C++ rANS behind CompressAI's
// EntropyBottleneck/GaussianConditional compress/decompress used by the
// reference (/root/reference/model/entropy_models.py:371-372,397-400,438,471).
// Standard construction (Duda 2014): 32-bit state, 8-bit renormalization,
// 16-bit quantized CDFs.  Out-of-support values are coded as an escape
// symbol followed by 4-bit-chunk bypass bits of the zigzagged overflow.
//
// Build: g++ -O3 -shared -fPIC rans.cpp -o librans.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 23;  // renormalization lower bound

struct ByteWriter {
  uint8_t* buf;
  int64_t cap;
  int64_t pos = 0;
  bool overflow = false;
  inline void put(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    buf[pos++] = b;
  }
};

inline void rans_enc_put(uint32_t& x, ByteWriter& w, uint32_t start,
                         uint32_t freq) {
  uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
  while (x >= x_max) {
    w.put(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
  x = ((x / freq) << kProbBits) + (x % freq) + start;
}

struct BitChunkQueue {
  // bypass chunks are collected per-symbol then rANS-uniform-coded as
  // 4-bit symbols with an implicit uniform distribution
  std::vector<uint8_t> chunks;
};

// uniform 4-bit chunk: start = c << 12, freq = 1 << 12 (prob 1/16)
inline void enc_put_chunk(uint32_t& x, ByteWriter& w, uint8_t c) {
  rans_enc_put(x, w, static_cast<uint32_t>(c) << 12, 1u << 12);
}

struct ByteReader {
  const uint8_t* buf;
  int64_t size;
  int64_t pos;  // reads backwards-encoded stream forwards
};

inline uint32_t rans_dec_init(ByteReader& r) {
  uint32_t x = 0;
  for (int i = 0; i < 4 && r.pos < r.size; ++i) {
    x |= static_cast<uint32_t>(r.buf[r.pos++]) << (8 * i);
  }
  return x;
}

inline uint32_t rans_dec_get_cum(uint32_t x) { return x & ((1u << kProbBits) - 1); }

inline void rans_dec_advance(uint32_t& x, ByteReader& r, uint32_t start,
                             uint32_t freq) {
  x = freq * (x >> kProbBits) + (x & ((1u << kProbBits) - 1)) - start;
  while (x < kRansL && r.pos < r.size) {
    x = (x << 8) | r.buf[r.pos++];
  }
}

inline uint8_t dec_get_chunk(uint32_t& x, ByteReader& r) {
  uint32_t cum = rans_dec_get_cum(x);
  uint8_t c = static_cast<uint8_t>(cum >> 12);
  rans_dec_advance(x, r, static_cast<uint32_t>(c) << 12, 1u << 12);
  return c;
}

}  // namespace

extern "C" {

// Encode n values. cdfs: [ncdfs, cdf_stride] row-major quantized CDFs
// (cdf[i][0]=0, cdf[i][len-1]=1<<16). indexes selects the CDF per value.
// Symbol for value v with CDF row i: s = v - offsets[i]; escape symbol is
// cdf_lengths[i]-2. Returns bytes written, or -1 on buffer overflow.
int64_t upcc_rans_encode(const int32_t* values, const int32_t* indexes,
                         int64_t n, const int32_t* cdfs, int64_t ncdfs,
                         int64_t cdf_stride, const int32_t* cdf_lengths,
                         const int32_t* offsets, uint8_t* out,
                         int64_t out_cap) {
  // rANS is LIFO: walk values in reverse, write bytes forward into a temp,
  // then reverse so the decoder reads forwards.
  std::vector<uint8_t> tmp;
  tmp.resize(static_cast<size_t>(out_cap));
  ByteWriter w{tmp.data(), out_cap};
  uint32_t x = kRansL;

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    const int32_t* cdf = cdfs + idx * cdf_stride;
    const int32_t len = cdf_lengths[idx];
    const int32_t max_sym = len - 2;  // last bin = escape/tail
    int32_t s = values[i] - offsets[idx];

    if (s < 0 || s >= max_sym) {
      // bypass: zigzag the overflow beyond the support edge
      int32_t ov = (s < 0) ? -2 * s - 1 : 2 * (s - max_sym);
      // chunks little-endian, 3 data bits + 1 continuation bit
      std::vector<uint8_t> chunks;
      uint32_t u = static_cast<uint32_t>(ov);
      do {
        uint8_t c = u & 0x7;
        u >>= 3;
        if (u) c |= 0x8;
        chunks.push_back(c);
      } while (u);
      // encode chunks in reverse (LIFO) so decode sees them in order
      for (int64_t j = static_cast<int64_t>(chunks.size()) - 1; j >= 0; --j) {
        enc_put_chunk(x, w, chunks[j]);
      }
      s = max_sym;
    }
    const uint32_t start = static_cast<uint32_t>(cdf[s]);
    const uint32_t freq = static_cast<uint32_t>(cdf[s + 1] - cdf[s]);
    rans_enc_put(x, w, start, freq);
    if (w.overflow) return -1;
  }
  // flush 4 state bytes (little-endian order, reversed below)
  for (int i = 3; i >= 0; --i) w.put(static_cast<uint8_t>((x >> (8 * i)) & 0xff));
  if (w.overflow) return -1;

  for (int64_t i = 0; i < w.pos; ++i) out[i] = tmp[w.pos - 1 - i];
  return w.pos;
}

// Decode n values given the same CDFs/indexes. Returns 0 on success.
int64_t upcc_rans_decode(const uint8_t* bytes, int64_t nbytes,
                         const int32_t* indexes, int64_t n,
                         const int32_t* cdfs, int64_t ncdfs,
                         int64_t cdf_stride, const int32_t* cdf_lengths,
                         const int32_t* offsets, int32_t* values_out) {
  ByteReader r{bytes, nbytes, 0};
  uint32_t x = rans_dec_init(r);

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t* cdf = cdfs + idx * cdf_stride;
    const int32_t len = cdf_lengths[idx];
    const int32_t max_sym = len - 2;
    const uint32_t cum = rans_dec_get_cum(x);

    // binary search: largest s with cdf[s] <= cum
    int32_t lo = 0, hi = len - 1;
    while (hi - lo > 1) {
      int32_t mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(cdf[mid]) <= cum) lo = mid; else hi = mid;
    }
    int32_t s = lo;
    rans_dec_advance(x, r, static_cast<uint32_t>(cdf[s]),
                     static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

    if (s == max_sym) {
      // bypass-decode zigzagged overflow
      uint32_t u = 0;
      int shift = 0;
      while (true) {
        uint8_t c = dec_get_chunk(x, r);
        u |= static_cast<uint32_t>(c & 0x7) << shift;
        shift += 3;
        if (!(c & 0x8)) break;
        if (shift > 30) return -2;  // corrupt stream
      }
      int32_t ov = static_cast<int32_t>(u);
      s = (ov & 1) ? -((ov + 1) / 2) : max_sym + ov / 2;
    }
    values_out[i] = s + offsets[idx];
  }
  return 0;
}

}  // extern "C"
