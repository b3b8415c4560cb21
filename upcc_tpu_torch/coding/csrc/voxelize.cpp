// Host voxelizer: morton encode + sort + dedup + feature gather.
//
// Native replacement for the numpy voxelization on the encode hot path
// (morton encode ~34M int64 numpy ops + argsort of ~1M keys cost ~1 s per
// vox10 frame; this does the same in ~0.1 s).  Output layout matches
// ops/sparse.voxelize_host_np: sorted unique keys (sentinel padded) and the
// first-occurrence features.
//
// Build: g++ -O3 -march=native -shared -fPIC voxelize.cpp -o libvoxelize.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t spread3(int64_t v) {
  v &= 0x1FFFFF;
  v = (v | (v << 32)) & 0x1F00000000FFFF;
  v = (v | (v << 16)) & 0x1F0000FF0000FF;
  v = (v | (v << 8)) & 0x100F00F00F00F00F;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3;
  v = (v | (v << 2)) & 0x1249249249249249;
  return v;
}

constexpr int kBatchShift = 57;
constexpr int64_t kSentinel = INT64_MAX;

}  // namespace

extern "C" {

// batch int32[n] (negative = padding row), xyz int32[n,3], feats f32[n,c].
// Writes keys int64[cap] (sentinel padded) and feats f32[cap,c] (zero
// padded).  Returns the number of unique voxels (may exceed cap; output is
// clipped).
int64_t voxelize(const int32_t* batch, const int32_t* xyz, const float* feats,
                 int64_t n, int64_t c, int64_t stride, int64_t cap,
                 int64_t* out_keys, float* out_feats) {
  std::vector<std::pair<int64_t, int64_t>> kv(n);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (batch[i] < 0) continue;
    const int64_t x = xyz[3 * i] / stride, y = xyz[3 * i + 1] / stride,
                  z = xyz[3 * i + 2] / stride;
    const int64_t key = (static_cast<int64_t>(batch[i]) << kBatchShift)
        | (spread3(x) << 2) | (spread3(y) << 1) | spread3(z);
    kv[m++] = {key, i};
  }
  kv.resize(m);
  std::sort(kv.begin(), kv.end());

  for (int64_t i = 0; i < cap; ++i) out_keys[i] = kSentinel;
  std::memset(out_feats, 0, sizeof(float) * cap * c);

  int64_t u = 0;
  int64_t prev = kSentinel;
  for (int64_t i = 0; i < m; ++i) {
    if (kv[i].first == prev) continue;
    prev = kv[i].first;
    if (u < cap) {
      out_keys[u] = kv[i].first;
      std::memcpy(out_feats + u * c, feats + kv[i].second * c,
                  sizeof(float) * c);
    }
    ++u;
  }
  return u;
}

}  // extern "C"
