// P2: windowed row gather-and-sum for Hopper (sm_90a).
//
// Replaces the Pallas probe kernel of scripts/prof_pallas_gather.py
// (kern, :37-44):
//
//   out[t, s, :] = sum_{k < T} win[t, idx[t, k, s], :]
//
// win f32 [tiles, S, K], idx int32 [tiles, T, S] (rows of the tile's own
// window, clipped into it), out f32 [tiles, S, K].  T row gathers over one
// window, summed, no product: it measures the card's row-gather rate.
// Every sum runs over the taps in order k = 0..T-1 starting from zero, as
// the plain version (ops/probe_kernels.py::window_gather_sum_plain) does,
// so the result is equal bit for bit.
//
// What bounds it: bytes — the windows and indices read once and the sums
// written once.  The T-fold gathered payload (3.6 GB at the probe's
// shape, 27 x 134 MB) is what the work moves, and where it is read from
// decides the time: gathered straight from device memory it is served by
// L2, at L2's rate.  Slab mode: one block per (tile, column slab of W = 8
// or 4 floats); the block copies its slab (S rows x W floats, 128 KB at
// S = 4096, W = 8) from device memory into shared memory once with
// cp.async, then every output row sums its T source rows from shared
// memory, two threads a row at W = 8, each owning 16 bytes.  Device memory
// then reads each window once (plus the tile's indices, from L2, once per
// slab); the gathers hit shared memory, where random rows cost bank
// conflicts: 32-byte rows put four rows in one 128-byte wavefront and two
// random rows share a bank group one time in four.  A ragged last slab
// (K % 8 == 4) is 4 floats wide.  Streaming mode, for windows whose slab
// does not fit shared memory even at W = 4: one block per (tile, 16 output
// rows), 16-byte column chunks gathered straight from device memory (the
// design before slabs).  The wrapper chooses by shape
// (ops/probe_kernels.py::window_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabThreads = 1024;
constexpr int kStreamThreads = 256;
constexpr int ROWS = 16;  // output rows per streaming block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// the sum over taps of output row s, piece p: the index of tap j at
// it[j * s_rows + s], clipped into the window; the rows read from the slab
// and added in tap order, from zero
__device__ __forceinline__ float4 gather_row(const float4* slab,
                                             const int32_t* __restrict__ it,
                                             int64_t s_rows, int64_t taps,
                                             int64_t s, int pieces, int p) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 9
  for (int64_t tap = 0; tap < taps; ++tap) {
    int src = it[tap * s_rows + s];
    src = src < 0 ? 0 : (src < s_rows ? src : (int)s_rows - 1);
    const float4 g = slab[(int64_t)src * pieces + p];
    acc.x += g.x;
    acc.y += g.y;
    acc.z += g.z;
    acc.w += g.w;
  }
  return acc;
}

// W: slab width in floats (8 or 4); the last slab may be 4 wide at W = 8
template <int W>
__global__ void __launch_bounds__(kSlabThreads, 1)
window_slab_kernel(const float* __restrict__ win,
                   const int32_t* __restrict__ idx, int64_t s_rows,
                   int64_t k, int64_t taps, float* __restrict__ out) {
  constexpr int kPieces = W / 4;  // float4 pieces of a slab row
  extern __shared__ float4 slab[];  // [s_rows][kPieces]
  const int64_t t = blockIdx.y;
  const int64_t c0 = (int64_t)blockIdx.x * W;
  // pieces this slab holds: kPieces, or 1 for a ragged last slab
  const int lg = (k - c0 >= W && kPieces == 2) ? 1 : 0;
  const int64_t items = s_rows << lg;  // (row, piece) pairs
  const float* wt = win + t * s_rows * k + c0;
  for (int64_t e = threadIdx.x; e < items; e += kSlabThreads) {
    const int64_t r = e >> lg;
    const int p = (int)(e & lg);
    cp_async16(&slab[r * kPieces + p], wt + r * k + 4 * p);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int32_t* it = idx + t * taps * s_rows;
  float* ot = out + t * s_rows * k + c0;
  for (int64_t e = threadIdx.x; e < items; e += kSlabThreads) {
    const int64_t s = e >> lg;
    const int p = (int)(e & lg);
    *reinterpret_cast<float4*>(ot + s * k + 4 * p) =
        gather_row(slab, it, s_rows, taps, s, kPieces, p);
  }
}

__global__ void __launch_bounds__(kStreamThreads)
window_stream_kernel(const float* __restrict__ win,
                     const int32_t* __restrict__ idx, int64_t s_rows,
                     int64_t k, int64_t taps, float* __restrict__ out) {
  const int64_t t = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int64_t chunks = k / 4;  // float4 chunks per row
  const float* wt = win + t * s_rows * k;
  const int32_t* it = idx + t * taps * s_rows;
  float* ot = out + t * s_rows * k;
  for (int64_t e = threadIdx.x; e < ROWS * chunks; e += kStreamThreads) {
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

// width: slab width in floats (8 or 4: slab mode, s_rows * width * 4 bytes
// of shared memory a block) or 0 (streaming mode)
extern "C" int upcc_window_gather_sum(const void* win_, const void* idx_,
                                      int64_t tiles, int64_t s_rows, int64_t k,
                                      int64_t taps, int64_t width, void* out_,
                                      void* stream) {
  if (tiles <= 0 || s_rows <= 0) return 0;
  if (k % 4 || k < 4 || taps < 1 || tiles > 65535 ||
      !(width == 0 || width == 4 || width == 8))
    return (int)cudaErrorInvalidValue;
  const float* win = (const float*)win_;
  const int32_t* idx = (const int32_t*)idx_;
  float* out = (float*)out_;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 0) {
    dim3 grid((unsigned)((s_rows + ROWS - 1) / ROWS), (unsigned)tiles);
    window_stream_kernel<<<grid, kStreamThreads, 0, s>>>(win, idx, s_rows, k,
                                                         taps, out);
    return (int)cudaGetLastError();
  }
  dim3 grid((unsigned)((k + width - 1) / width), (unsigned)tiles);
  const int64_t smem = s_rows * width * 4;
  const void* kern = width == 8 ? (const void*)window_slab_kernel<8>
                                : (const void*)window_slab_kernel<4>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (width == 8)
    window_slab_kernel<8><<<grid, kSlabThreads, smem, s>>>(win, idx, s_rows,
                                                           k, taps, out);
  else
    window_slab_kernel<4><<<grid, kSlabThreads, smem, s>>>(win, idx, s_rows,
                                                           k, taps, out);
  return (int)cudaGetLastError();
}
