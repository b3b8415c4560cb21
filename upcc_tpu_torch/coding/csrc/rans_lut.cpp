// rANS decoding by table: the decoder of rans.cpp's streams, with the
// per-symbol binary search over the CDF row replaced by one load from a
// small per-row bucket table.
//
// The state arithmetic, the escape (bypass) chunks, the renormalization
// and the end-of-buffer guard are rans.cpp's, so both decoders return the
// same values and the same code on any bytes.  What differs is how the
// symbol under the 16-bit slot cum = x & 0xffff is found.  Each CDF row
// gets B buckets of 65536 / B slots; a bucket's entry holds the largest
// symbol s (at most the escape bin, len - 2) with cdf[s] <= the bucket's
// first slot, that symbol's start and frequency, and a flag set where a
// later symbol also starts inside the bucket.  Flag clear: the entry alone
// gives the symbol and the state update.  Flag set: a forward scan from
// the entry's symbol, while cdf[s + 1] <= cum, finds it, as the search
// would.  B is the largest power of two in [16, 256] that keeps the table
// within 64 KiB at 8 bytes an entry, so the table stays in the L1/L2
// caches beside the rows it is built from; it is built in each call.
//
// The rows are the coder's quantized CDFs (rans.py::pmf_to_quantized_cdf):
// non-decreasing, 0 first and 1 << 16 last, every bin at least 1.
//
// Build: g++ -O3 -shared -fPIC rans_lut.cpp -o librans_lut.so

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 23;  // renormalization lower bound
constexpr int64_t kTableBytes = 64 * 1024;

struct Entry {
  uint32_t start_freq;  // start | (freq - 1) << 16
  uint32_t sym_multi;   // symbol << 1 | (another symbol starts in the bucket)
};

// log2 of the buckets a row: the largest power of two in [16, 256] with
// ncdfs * B entries of 8 bytes within kTableBytes (16 where none is).
int bucket_bits(int64_t ncdfs) {
  int bits = 8;
  while (bits > 4 &&
         ncdfs * (int64_t{1} << bits) * int64_t{sizeof(Entry)} > kTableBytes) {
    --bits;
  }
  return bits;
}

void build_table(const int32_t* cdfs, int64_t ncdfs, int64_t cdf_stride,
                 const int32_t* cdf_lengths, int bits, Entry* table) {
  const int shift = kProbBits - bits;
  const int64_t nb = int64_t{1} << bits;
  const uint32_t width = 1u << shift;
  for (int64_t r = 0; r < ncdfs; ++r) {
    const int32_t* cdf = cdfs + r * cdf_stride;
    const int32_t max_sym = cdf_lengths[r] - 2;
    Entry* row = table + r * nb;
    int32_t s = 0;
    for (int64_t b = 0; b < nb; ++b) {
      const uint32_t lo = static_cast<uint32_t>(b) << shift;
      while (s < max_sym && static_cast<uint32_t>(cdf[s + 1]) <= lo) ++s;
      const bool multi =
          s < max_sym && static_cast<uint32_t>(cdf[s + 1]) <= lo + width - 1;
      const uint32_t start = static_cast<uint32_t>(cdf[s]);
      const uint32_t freq = static_cast<uint32_t>(cdf[s + 1] - cdf[s]);
      row[b].start_freq = (start & kProbMask) | ((freq - 1) << kProbBits);
      row[b].sym_multi = (static_cast<uint32_t>(s) << 1) | (multi ? 1u : 0u);
    }
  }
}

struct ByteReader {
  const uint8_t* buf;
  int64_t size;
  int64_t pos;
};

inline void advance(uint32_t& x, ByteReader& r, uint32_t start,
                    uint32_t freq) {
  x = freq * (x >> kProbBits) + (x & kProbMask) - start;
  while (x < kRansL && r.pos < r.size) {
    x = (x << 8) | r.buf[r.pos++];
  }
}

}  // namespace

extern "C" {

// upcc_rans_decode's arguments and result (0, or -2 on an escape longer
// than any int32), plus direct_out: the symbols one table entry resolved.
int64_t upcc_rans_lut_decode(const uint8_t* bytes, int64_t nbytes,
                             const int32_t* indexes, int64_t n,
                             const int32_t* cdfs, int64_t ncdfs,
                             int64_t cdf_stride, const int32_t* cdf_lengths,
                             const int32_t* offsets, int32_t* values_out,
                             int64_t* direct_out) {
  const int bits = bucket_bits(ncdfs);
  const int shift = kProbBits - bits;
  std::vector<Entry> table(static_cast<size_t>(ncdfs) << bits);
  build_table(cdfs, ncdfs, cdf_stride, cdf_lengths, bits, table.data());

  ByteReader r{bytes, nbytes, 0};
  uint32_t x = 0;
  for (int i = 0; i < 4 && r.pos < r.size; ++i) {
    x |= static_cast<uint32_t>(r.buf[r.pos++]) << (8 * i);
  }

  int64_t direct = 0;
  *direct_out = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t max_sym = cdf_lengths[idx] - 2;
    const uint32_t cum = x & kProbMask;
    const Entry e = table[(static_cast<int64_t>(idx) << bits) + (cum >> shift)];
    int32_t s = static_cast<int32_t>(e.sym_multi >> 1);
    if (!(e.sym_multi & 1)) {
      ++direct;
      advance(x, r, e.start_freq & kProbMask, (e.start_freq >> kProbBits) + 1);
    } else {
      const int32_t* cdf = cdfs + idx * cdf_stride;
      while (s < max_sym && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
      advance(x, r, static_cast<uint32_t>(cdf[s]),
              static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    }

    if (s == max_sym) {
      // bypass-decode the zigzagged overflow, 3 bits a chunk at 1/16
      uint32_t u = 0;
      int chunk_shift = 0;
      while (true) {
        const uint32_t c = (x & kProbMask) >> 12;
        advance(x, r, c << 12, 1u << 12);
        u |= (c & 0x7) << chunk_shift;
        chunk_shift += 3;
        if (!(c & 0x8)) break;
        if (chunk_shift > 30) {
          *direct_out = direct;
          return -2;  // corrupt stream
        }
      }
      const int32_t ov = static_cast<int32_t>(u);
      s = (ov & 1) ? -((ov + 1) / 2) : max_sym + ov / 2;
    }
    values_out[i] = s + offsets[idx];
  }
  *direct_out = direct;
  return 0;
}

}  // extern "C"
