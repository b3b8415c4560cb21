// P1: tile-local tap gather + product for Hopper (sm_90a).
//
// Replaces the Pallas probe kernel of scripts/micro_gather.py
// (make_pallas_tapconv, the kernel body at :85-94):
//
//   out[r, :] = sum_{k < T} x[tile(r) * TILE + idx[r, k], :] @ W[k]
//
// x [R, K_in] and W [T, K_in, K_out] in bf16 or f32, idx int32 [R, T] with
// every index local to the row's tile of TILE rows, out f32 [R, K_out].
// No validity mask and dense weights: it measures the gather + tensor-core
// primitive alone, at one fixed shape (R = 2^19, K_in = K_out = 128, T = 27,
// TILE = 2048).
//
// What bounds it: tensor-core operations (2 * R * T * K_in * K_out flops
// against R * K_in inputs, R * T indices and R * K_out outputs: ~1000 flops
// per byte, far above the card's ridge).  The TPU kernel held the whole
// tile in on-chip memory; a 2048 x 128 tile is 512 KiB in bf16 and does not
// fit an SM's shared memory, so here a block owns a 128-row x 128-column
// output tile, gathers its source rows per tap and K chunk into shared
// memory (the tile's rows are hot in L2: all its blocks run close in time)
// and accumulates over the T taps in f32 registers, written once.
//   bf16 operands: WMMA m16n16k16 bf16, exact products, f32 sums.
//   f32 operands:  WMMA m16n16k8 TF32 — the operands are rounded to TF32
//     (10 mantissa bits) on load into the fragments, sums stay f32.  Chosen
//     over FFMA because the probe asks what the matrix unit delivers behind
//     a gather; the rounding is the stated tolerance of this variant.
//
// Deterministic: fixed tap, chunk and fragment order, no atomics.  Loads are
// synchronous (no cp.async / TMA ring) and the products are mma.sync-class
// WMMA, not wgmma: the simple version first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // K chunk
constexpr int PAD = 8;        // shared-memory row padding, in elements
constexpr int kThreads = 256; // 8 warps: 4 along rows x 2 along columns
constexpr int WM = 32;        // rows per warp
constexpr int WN = 64;        // columns per warp

template <typename T> struct Op;
template <> struct Op<__nv_bfloat16> {
  static constexpr int KK = 16;  // depth of one fragment
  using AB = __nv_bfloat16;
};
template <> struct Op<float> {
  static constexpr int KK = 8;
  using AB = wmma::precision::tf32;
};

template <typename Frag>
__device__ __forceinline__ void round_tf32(Frag& f) {
#pragma unroll
  for (int t = 0; t < f.num_elements; ++t) f.x[t] = wmma::__float_to_tf32(f.x[t]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_tapconv_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const T* __restrict__ w, int64_t rows, int64_t k_in,
                    int64_t k_out, int64_t taps, int64_t tile,
                    float* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int KK = Op<T>::KK;
  using AB = typename Op<T>::AB;
  __shared__ __align__(128) T sA[BM][BK + PAD];
  __shared__ __align__(128) T sB[BK][BN + PAD];
  __shared__ __align__(128) float sC[kThreads / 32][16 * 16];
  __shared__ int64_t s_src[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 0..3
  const int wn = warp & 1;   // 0..1
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;
  const int nkc = (int)((k_in + BK - 1) / BK);

  wmma::fragment<wmma::accumulator, 16, 16, KK, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int64_t tap = 0; tap < taps; ++tap) {
    if (tid < BM) {
      const int64_t r = row0 + tid;
      int64_t src = -1;
      if (r < rows) {
        int64_t loc = idx[r * taps + tap];
        loc = loc < 0 ? 0 : (loc < tile ? loc : tile - 1);  // stay in the tile
        src = (r / tile) * tile + loc;
      }
      s_src[tid] = src;
    }
    __syncthreads();

    for (int kc = 0; kc < nkc; ++kc) {
      const int64_t k0 = (int64_t)kc * BK;
      // A tile: BM x BK gathered rows, 16 bytes per vector
#pragma unroll
      for (int v = 0; v < (BM * BK / VEC) / kThreads; ++v) {
        const int e = tid + v * kThreads;
        const int r = e / (BK / VEC);
        const int c = (e % (BK / VEC)) * VEC;
        const int64_t s = s_src[r];
        uint4 val = make_uint4(0, 0, 0, 0);
        if (s >= 0 && k0 + c < k_in)
          val = *reinterpret_cast<const uint4*>(x + s * k_in + k0 + c);
        *reinterpret_cast<uint4*>(&sA[r][c]) = val;
      }
      // B tile: BK x BN block of W[tap]
#pragma unroll
      for (int v = 0; v < (BK * BN / VEC) / kThreads; ++v) {
        const int e = tid + v * kThreads;
        const int kr = e / (BN / VEC);
        const int c = (e % (BN / VEC)) * VEC;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + kr < k_in && col0 + c < k_out)
          val = *reinterpret_cast<const uint4*>(
              w + (tap * k_in + k0 + kr) * k_out + col0 + c);
        *reinterpret_cast<uint4*>(&sB[kr][c]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += KK) {
        wmma::fragment<wmma::matrix_a, 16, 16, KK, AB, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, KK, AB, wmma::row_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(a[i], &sA[wm * WM + i * 16][kk], BK + PAD);
          if constexpr (sizeof(T) == 4) round_tf32(a[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(b[j], &sB[kk][wn * WN + j * 16], BN + PAD);
          if constexpr (sizeof(T) == 4) round_tf32(b[j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: full 16x16 fragments go straight out, ragged ones through a
  // per-warp staging tile with guarded stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = row0 + wm * WM + i * 16;
      const int64_t c = col0 + wn * WN + j * 16;
      if (r >= rows || c >= k_out) continue;
      if (r + 16 <= rows && c + 16 <= k_out) {
        wmma::store_matrix_sync(out + r * k_out + c, acc[i][j], (unsigned)k_out,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(sC[warp], acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, cc = e & 15;
          if (r + rr < rows && c + cc < k_out)
            out[(r + rr) * k_out + c + cc] = sC[warp][e];
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// is_f32: 0 = bf16 operands, 1 = f32 operands (TF32 products)
extern "C" int upcc_tile_tapconv(const void* x, const void* idx, const void* w,
                                 int64_t rows, int64_t k_in, int64_t k_out,
                                 int64_t taps, int64_t tile, int is_f32,
                                 void* out, void* stream) {
  if (rows <= 0) return 0;
  if (k_in % 8 || k_out % 8 || tile < 1 || taps < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((k_out + BN - 1) / BN));
  if (is_f32)
    tile_tapconv_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int32_t*)idx, (const float*)w, rows, k_in,
        k_out, taps, tile, (float*)out);
  else
    tile_tapconv_kernel<__nv_bfloat16>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)x, (const int32_t*)idx,
            (const __nv_bfloat16*)w, rows, k_in, k_out, taps, tile,
            (float*)out);
  return (int)cudaGetLastError();
}
