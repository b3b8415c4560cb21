// Lossless octree coordinate codec over sorted Morton codes.
//
// Native replacement for the reference's G-PCC (tmc3) subprocess that
// losslessly codes latent coordinates (/root/reference/model/model.py:388-486,
// SURVEY.md §2 native component 3).  Instead of shelling out with temp PLY
// files, this codes the breadth-first octree occupancy of the block's
// Morton keys directly through an adaptive binary range coder.
//
// Context model (v3, G-PCC-class): each child-occupancy bit is conditioned
// on
//   * the CAUSAL state of the 3 face-adjacent cells outside the parent:
//     per axis, the neighboring parent is absent (0), present but not yet
//     expanded (1), or already expanded in breadth-first Morton order so
//     the exact neighboring child cell is known empty (2) / occupied (3);
//   * the 3 face-adjacent sibling cells inside the parent (unknown /
//     known-empty / known-occupied — slots code in fixed order);
//   * the child slot and a coarse distance-from-leaves bucket.
// Probabilities are Krichevsky-Trofimov counts with periodic halving —
// they converge much faster than shift-register adaptation on the small
// (10-100k key) latent sets the codec codes per block.
//
// Measured on representative sets (scripts/prof_octree.py): stride-8
// vox10 latent set 1.62 -> 1.11 bits/pt vs the v2 (level, slot,
// 6-neighbor-count, sibling-pattern) contexts; dense full-resolution
// surface sets 3.68 -> 3.46 bits/pt.
//
// Build: g++ -O3 -shared -fPIC octree.cpp -o liboctree.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

// ---- adaptive binary range coder (32-bit, carry-less) ----

constexpr uint32_t kTop = 1u << 24;
constexpr int kProbBits = 16;

// KT-style counting context: p0 = c0 / (c0 + c1), halved at kHalveAt so
// the estimate stays adaptive.  Counts are in half units (init 1 == 0.5).
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
      if (nlow < low) carry();  // propagate carry into emitted bytes
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
    // increment the last emitted non-0xFF byte chain
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

// ---- context geometry ----

constexpr int kMaxLevels = 21;
// [level bucket(4)][external 3-axis state(64)][sibling 3-axis state(27)]
// [child slot(8)]
constexpr int kCtxCount = 4 * 64 * 27 * 8;

inline int level_bucket(int level, int levels) {
  int from_leaf = levels - level;  // 1 = last level before leaves
  if (from_leaf <= 1) return 0;
  if (from_leaf == 2) return 1;
  if (from_leaf == 3) return 2;
  return 3;
}
inline int ctx_index(int lb, int ext, int sib, int slot) {
  return (((lb * 64) + ext) * 27 + sib) * 8 + slot;
}

// decode morton code -> 3 coords (21 bits each)
inline void morton_to_xyz(int64_t m, int64_t* x) {
  for (int a = 0; a < 3; ++a) {
    int64_t v = 0;
    for (int b = 0; b < 21; ++b) v |= ((m >> (3 * b + 2 - a)) & 1) << b;
    x[a] = v;
  }
}

inline int64_t xyz_to_morton(const int64_t* x) {
  int64_t m = 0;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 21; ++b) m |= ((x[a] >> b) & 1) << (3 * b + 2 - a);
  return m;
}

// Per-node causal neighbor lookup: for each axis and direction, the index
// of the face-neighbor node in the level's sorted node list (or -1).
// 6 binary searches per node, same cost class as the v2 neighbor count.
struct NodeNbrs {
  int64_t idx[3][2];  // [axis][dir: 0 = -1, 1 = +1]
};

inline NodeNbrs find_nbrs(const std::vector<int64_t>& nodes, int64_t code,
                          int level_bits) {
  NodeNbrs nb;
  int64_t x[3];
  morton_to_xyz(code, x);
  const int64_t lim = int64_t(1) << level_bits;
  for (int a = 0; a < 3; ++a) {
    for (int d = 0; d < 2; ++d) {
      int64_t q[3] = {x[0], x[1], x[2]};
      q[a] += d ? 1 : -1;
      nb.idx[a][d] = -1;
      if (q[a] < 0 || q[a] >= lim) continue;
      int64_t mc = xyz_to_morton(q);
      auto it = std::lower_bound(nodes.begin(), nodes.end(), mc);
      if (it != nodes.end() && *it == mc)
        nb.idx[a][d] = it - nodes.begin();
    }
  }
  return nb;
}

// external 3-axis state for child slot c of node k:
// per axis: 0 absent parent, 1 parent present children unknown,
//           2 child known empty, 3 child known occupied
inline int ext_state(const NodeNbrs& nb, const std::vector<uint8_t>& occ,
                     int64_t k, int c) {
  int ext = 0;
  for (int a = 0; a < 3; ++a) {
    const int bit_a = (c >> (2 - a)) & 1;   // child position along axis a
    const int64_t qi = nb.idx[a][bit_a];    // outward face neighbor
    int s = 0;
    if (qi >= 0) {
      if (qi < k) {
        const int cq = c ^ (1 << (2 - a));  // neighboring cell's slot in Q
        s = 2 + ((occ[qi] >> cq) & 1);
      } else {
        s = 1;
      }
    }
    ext = ext * 4 + s;
  }
  return ext;
}

// sibling 3-axis state: per axis 0 unknown (slot not yet coded),
// 1 known empty, 2 known occupied
inline int sib_state(int c, int occ_so_far) {
  int sib = 0;
  for (int a = 0; a < 3; ++a) {
    const int s = c ^ (1 << (2 - a));
    int v = 0;
    if (s < c) v = 1 + ((occ_so_far >> s) & 1);
    sib = sib * 3 + v;
  }
  return sib;
}

}  // namespace

extern "C" {

// codes: sorted unique morton codes (< 8^levels), n >= 1.
// Returns bytes written or -1 on overflow.
int64_t octree_encode(const int64_t* codes, int64_t n, int levels,
                      uint8_t* out, int64_t out_cap) {
  if (levels > kMaxLevels) return -3;
  std::vector<Ctx> ctxs(kCtxCount);
  Encoder enc;
  enc.out.reserve((size_t)(n / 2 + 64));

  // nodes at the current level as (start, end) ranges into `codes`, the
  // node prefix codes, and each expanded node's child-occupancy byte
  std::vector<int64_t> starts{0}, ends{n}, nodes{0};
  for (int level = 0; level < levels; ++level) {
    const int shift = 3 * (levels - level - 1);
    const int lb = level_bucket(level, levels);
    std::vector<int64_t> nstarts, nends, nnodes;
    std::vector<uint8_t> occ(nodes.size(), 0);
    nstarts.reserve(starts.size() * 4);
    nends.reserve(starts.size() * 4);
    nnodes.reserve(starts.size() * 4);
    for (size_t k = 0; k < starts.size(); ++k) {
      int64_t s = starts[k], e = ends[k];
      // child boundaries: cs[c]..cs[c+1] is child c's range
      int64_t cs[9];
      int64_t p = s;
      for (int c = 0; c < 8; ++c) {
        cs[c] = p;
        while (p < e && (int)((codes[p] >> shift) & 7) == c) ++p;
      }
      cs[8] = e;
      const NodeNbrs nb = find_nbrs(nodes, nodes[k], level);
      int pattern = 0;
      for (int c = 0; c < 8; ++c) {
        int bit = cs[c + 1] > cs[c] ? 1 : 0;
        const int ext = ext_state(nb, occ, (int64_t)k, c);
        const int sib = sib_state(c, pattern);
        enc.encode(bit, ctxs[ctx_index(lb, ext, sib, c)]);
        pattern |= bit << c;
        if (bit && level + 1 < levels) {
          nstarts.push_back(cs[c]);
          nends.push_back(cs[c + 1]);
          nnodes.push_back((nodes[k] << 3) | c);
        }
      }
      occ[k] = (uint8_t)pattern;
    }
    starts.swap(nstarts);
    ends.swap(nends);
    nodes.swap(nnodes);
  }
  enc.flush();
  if ((int64_t)enc.out.size() > out_cap) return -1;
  for (size_t i = 0; i < enc.out.size(); ++i) out[i] = enc.out[i];
  return (int64_t)enc.out.size();
}

// Decodes into `out` (sorted morton codes). Returns count or -1 on overflow.
int64_t octree_decode(const uint8_t* data, int64_t nbytes, int levels,
                      int64_t* out, int64_t out_cap) {
  if (levels > kMaxLevels) return -3;
  std::vector<Ctx> ctxs(kCtxCount);
  Decoder dec{data, nbytes};
  dec.init();

  std::vector<int64_t> nodes{0};  // morton prefixes at current level
  for (int level = 0; level < levels; ++level) {
    const int lb = level_bucket(level, levels);
    std::vector<int64_t> next;
    std::vector<uint8_t> occ(nodes.size(), 0);
    next.reserve(nodes.size() * 4);
    for (size_t k = 0; k < nodes.size(); ++k) {
      const NodeNbrs nb = find_nbrs(nodes, nodes[k], level);
      int pattern = 0;
      for (int c = 0; c < 8; ++c) {
        const int ext = ext_state(nb, occ, (int64_t)k, c);
        const int sib = sib_state(c, pattern);
        int bit = dec.decode(ctxs[ctx_index(lb, ext, sib, c)]);
        pattern |= bit << c;
        if (bit) next.push_back((nodes[k] << 3) | c);
      }
      occ[k] = (uint8_t)pattern;
    }
    nodes.swap(next);
    if ((int64_t)nodes.size() > out_cap) return -1;
  }
  for (size_t i = 0; i < nodes.size(); ++i) out[i] = nodes[i];
  return (int64_t)nodes.size();
}

}  // extern "C"
