// Context-adaptive occupancy bit coder for the coded-geometry mode
// (codec/refine.py).  Replaces the v5 two-pass measured per-(level, bin)
// tables: a one-pass adaptive KT coder whose contexts combine the learned
// logit bin with the CAUSAL sibling occupancy count — the information the
// per-candidate logits cannot carry (each candidate's logit is computed
// independently; actual surfaces make sibling occupancy strongly
// correlated).  Same coder core as the coordinate codec (csrc/octree.cpp),
// which conditions on neighbor children the same way.
//
// Contexts: [logit bin (32)] x [occupied-among-previous-siblings clamped
// to 4 (5)] = 160, KT counts seeded from the bin-center sigmoid prior so
// per-stream adaptation warm-up costs ~nothing even on small blocks.
// Candidates arrive parent-major (8 children per parent,
// codec/refine.py::children_np); the sibling count resets every 8th bit
// and is reconstructed by the decoder from its own output, so no side
// information of any kind is needed.
//
// Bit-identical python twin: upcc_tpu/coding/occ.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kProbBits = 16;
constexpr uint32_t kHalveAt = 128;

struct Ctx {
  uint16_t c0 = 1, c1 = 1;
  inline uint32_t p0() const {
    uint32_t p = ((uint32_t)c0 << kProbBits) / (uint32_t)(c0 + c1);
    if (p < 64) p = 64;
    if (p > (1u << kProbBits) - 64) p = (1u << kProbBits) - 64;
    return p;
  }
  inline void update(int bit) {
    if (bit) c1 += 2; else c0 += 2;
    if ((uint32_t)(c0 + c1) >= kHalveAt) {
      c0 = (uint16_t)((c0 + 1) >> 1);
      c1 = (uint16_t)((c1 + 1) >> 1);
    }
  }
};

struct Encoder {
  std::vector<uint8_t> out;
  uint32_t low = 0;
  uint32_t range = 0xFFFFFFFFu;

  inline void encode(int bit, Ctx& ctx) {
    uint32_t split = (uint32_t)(((uint64_t)range * ctx.p0()) >> kProbBits);
    if (bit == 0) {
      range = split;
    } else {
      uint32_t nlow = low + split;
      if (nlow < low) carry();
      low = nlow;
      range -= split;
    }
    ctx.update(bit);
    while (range < kTop) {
      out.push_back((uint8_t)(low >> 24));
      low <<= 8;
      range <<= 8;
    }
  }

  inline void carry() {
    for (int64_t i = (int64_t)out.size() - 1; i >= 0; --i) {
      if (out[i] != 0xFF) { out[i]++; return; }
      out[i] = 0;
    }
  }

  void flush() {
    for (int i = 0; i < 4; ++i) {
      out.push_back((uint8_t)(low >> 24));
      low <<= 8;
    }
  }
};

struct Decoder {
  const uint8_t* in;
  int64_t size;
  int64_t pos = 0;
  uint32_t code = 0;
  uint32_t range = 0xFFFFFFFFu;

  void init() {
    for (int i = 0; i < 4; ++i) code = (code << 8) | next();
  }
  inline uint8_t next() { return pos < size ? in[pos++] : 0; }

  inline int decode(Ctx& ctx) {
    uint32_t split = (uint32_t)(((uint64_t)range * ctx.p0()) >> kProbBits);
    int bit;
    if (code < split) {
      bit = 0;
      range = split;
    } else {
      bit = 1;
      code -= split;
      range -= split;
    }
    ctx.update(bit);
    while (range < kTop) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return bit;
  }
};

// ---- occupancy context geometry (mirrored in coding/occ.py) ----

constexpr int kNBins = 32;      // refine.N_BINS
constexpr int kPrefixStates = 5;  // 0..3 occupied siblings so far, 4 = 4+
constexpr int kCtxCount = kNBins * kPrefixStates;
constexpr double kLogitLo = -8.0, kLogitHi = 8.0;  // refine.LOGIT_LO/HI
constexpr int kSeedTotal = 16;  // prior strength in half-units (8 counts)

inline int ctx_index(int bin, int prefix) {
  return bin * kPrefixStates + (prefix > 4 ? 4 : prefix);
}

// Seed each bin's contexts with the sigmoid of the bin center so a fresh
// stream starts from the v4 static tables' prior instead of 50/50.
inline void seed(std::vector<Ctx>& ctxs) {
  const double w = (kLogitHi - kLogitLo) / kNBins;
  for (int b = 0; b < kNBins; ++b) {
    const double center = kLogitLo + (b + 0.5) * w;
    const double p = 1.0 / (1.0 + std::exp(-center));
    int c1 = (int)(p * kSeedTotal + 0.5);
    if (c1 < 1) c1 = 1;
    if (c1 > kSeedTotal - 1) c1 = kSeedTotal - 1;
    for (int s = 0; s < kPrefixStates; ++s) {
      Ctx& c = ctxs[ctx_index(b, s)];
      c.c1 = (uint16_t)c1;
      c.c0 = (uint16_t)(kSeedTotal - c1);
    }
  }
}

}  // namespace

extern "C" {

// bits/bins: n entries, parent-major (n % 8 == 0).  Returns bytes written
// or a negative error (-1 overflow, -2 bad n).
int64_t occ_encode(const uint8_t* bits, const uint8_t* bins, int64_t n,
                   uint8_t* out, int64_t out_cap) {
  if (n % 8 != 0 || n < 0) return -2;
  std::vector<Ctx> ctxs(kCtxCount);
  seed(ctxs);
  Encoder enc;
  enc.out.reserve((size_t)(n / 16 + 64));
  int prefix = 0;
  for (int64_t i = 0; i < n; ++i) {
    if ((i & 7) == 0) prefix = 0;
    const int bit = bits[i] ? 1 : 0;
    enc.encode(bit, ctxs[ctx_index(bins[i] < kNBins ? bins[i] : kNBins - 1,
                                   prefix)]);
    prefix += bit;
  }
  enc.flush();
  if ((int64_t)enc.out.size() > out_cap) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t occ_decode(const uint8_t* data, int64_t size, const uint8_t* bins,
                   int64_t n, uint8_t* out_bits) {
  if (n % 8 != 0 || n < 0) return -2;
  std::vector<Ctx> ctxs(kCtxCount);
  seed(ctxs);
  Decoder dec{data, size};
  dec.init();
  int prefix = 0;
  for (int64_t i = 0; i < n; ++i) {
    if ((i & 7) == 0) prefix = 0;
    const int bit = dec.decode(
        ctxs[ctx_index(bins[i] < kNBins ? bins[i] : kNBins - 1, prefix)]);
    out_bits[i] = (uint8_t)bit;
    prefix += bit;
  }
  return n;
}

}  // extern "C"
