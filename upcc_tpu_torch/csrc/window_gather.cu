// P2: windowed row gather-and-sum for Hopper (sm_90a).
//
// Replaces the Pallas probe kernel of scripts/prof_pallas_gather.py
// (kern, :37-44):
//
//   out[t, s, :] = sum_{k < T} win[t, idx[t, k, s], :]
//
// win f32 [tiles, S, K], idx int32 [tiles, T, S] (rows of the tile's own
// window), out f32 [tiles, S, K].  T row gathers over one window, summed,
// no product: it measures the card's row-gather rate.
//
// What bounds it: bytes.  The function must read the windows and indices
// and write the sums once; the T-fold gathered payload is re-read from the
// windows, which a tile's blocks keep hot in L2 (one window is S * K * 4
// bytes, 8 MiB at the probe's shape).  Design: one block per (tile, group
// of ROWS output rows); each thread owns 16-byte column chunks of an output
// row, reads its T source rows with vector loads, sums in f32 in tap order
// k = 0..T-1 starting from zero, and writes once.  The order is the plain
// version's, so the result is equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int ROWS = 16;  // output rows per block

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ win,
                     const int32_t* __restrict__ idx, int64_t s_rows,
                     int64_t k, int64_t taps, float* __restrict__ out) {
  const int64_t t = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int64_t chunks = k / 4;  // float4 chunks per row
  const float* wt = win + t * s_rows * k;
  const int32_t* it = idx + t * taps * s_rows;
  float* ot = out + t * s_rows * k;
  for (int64_t e = threadIdx.x; e < ROWS * chunks; e += kThreads) {
    const int64_t s = row0 + e / chunks;
    const int64_t c = (e % chunks) * 4;
    if (s >= s_rows) break;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t tap = 0; tap < taps; ++tap) {
      int64_t src = it[tap * s_rows + s];
      src = src < 0 ? 0 : (src < s_rows ? src : s_rows - 1);
      const float4 g = *reinterpret_cast<const float4*>(wt + src * k + c);
      acc.x += g.x;
      acc.y += g.y;
      acc.z += g.z;
      acc.w += g.w;
    }
    *reinterpret_cast<float4*>(ot + s * k + c) = acc;
  }
}

}  // namespace

extern "C" int upcc_window_gather_sum(const void* win, const void* idx,
                                      int64_t tiles, int64_t s_rows, int64_t k,
                                      int64_t taps, void* out, void* stream) {
  if (tiles <= 0 || s_rows <= 0) return 0;
  if (k % 4 || k < 4 || taps < 1 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((s_rows + ROWS - 1) / ROWS), (unsigned)tiles);
  window_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)win, (const int32_t*)idx, s_rows, k, taps, (float*)out);
  return (int)cudaGetLastError();
}
