// K1: tap gather-GEMM for Hopper (sm_90a).
//
// Replaces the XLA tap scan of upcc_tpu/ops/family.py::_tap_scan_gemm
// (the default scan path, family.py:682-689):
//
//   out[r, :] = sum_{k < T} ok[r, k] * flat[min(idx[r, k], n_src - 1), :] @ W[k]
//
// flat bf16 [n_src, K_in], W bf16 [T, K_in, K_out], idx int32 / ok uint8
// [rows, T], out f32 [rows, K_out].  It is the engine under every learned
// conv of the codec (family_conv, family_down_conv, the kernel-5
// family_transpose_up and the grandparent-brick grand_apply).
//
// What bounds it: tensor-core operations.  A dense slot-pair stack costs
// 2 * rows * T * K_in * K_out flops against ~rows * T * K_in * 2 bytes of
// gathered rows, far above the card's ~295 flop/byte ridge.  But the
// stacks are structurally sparse: a kernel-3 child conv keeps 1/8 of its
// slot-pair blocks, the grandparent layouts 1/27 or less.  So the design
// (1) skips every [BK x BN] weight block the host-side mask marks all-zero
// and every tap no row of the tile reads (ok == 0), and (2) for the rest
// gathers the tile's source rows straight into shared memory (no
// materialised [rows, T, K_in] stack) and multiplies them on the tensor
// cores with WMMA bf16 16x16x16 fragments, keeping the f32 accumulator in
// registers across all taps; the output is written once.
//
// Deterministic: each output element is summed in a fixed order (taps in
// order, K in order, fixed fragment order) with no atomics, so two launches
// on the same inputs give the same bits — the codec's encoder and decoder
// rely on it.  Skipped blocks only drop exact-zero products.
//
// This first version loads synchronously (no cp.async / TMA pipeline) and
// uses mma.sync-class WMMA rather than wgmma; those are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // K chunk (must match family.py TAP_BK)
constexpr int APAD = 8;       // shared-memory row padding (bank conflicts)
constexpr int BPAD = 8;
constexpr int kThreads = 256; // 8 warps: 4 along rows x 2 along columns
constexpr int WM = 32;        // rows per warp
constexpr int WN = 64;        // columns per warp

__global__ void __launch_bounds__(kThreads)
tap_gemm_kernel(const __nv_bfloat16* __restrict__ flat, int64_t n_src,
                int64_t k_in, const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ ok, int64_t rows, int64_t taps,
                const __nv_bfloat16* __restrict__ w, int64_t k_out,
                const uint8_t* __restrict__ wmask, float* __restrict__ out) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM][BK + APAD];
  __shared__ __align__(128) __nv_bfloat16 sB[BK][BN + BPAD];
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
  const int nnt = (int)gridDim.y;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int64_t tap = 0; tap < taps; ++tap) {
    int have = 0;
    if (tid < BM) {
      const int64_t r = row0 + tid;
      int64_t src = -1;
      if (r < rows && ok[r * taps + tap]) {
        int64_t s = idx[r * taps + tap];
        s = s < n_src - 1 ? s : n_src - 1;
        src = s < 0 ? 0 : s;
      }
      s_src[tid] = src;
      have = src >= 0;
    }
    // no row of this tile reads this tap: skip it (uniform per block)
    if (!__syncthreads_or(have)) continue;

    for (int kc = 0; kc < nkc; ++kc) {
      if (wmask[((int64_t)tap * nkc + kc) * nnt + blockIdx.y] == 0)
        continue;  // all-zero weight block (uniform per block)
      const int64_t k0 = (int64_t)kc * BK;
      // A tile: BM x BK gathered rows, 8 bf16 (16 bytes) per vector
#pragma unroll
      for (int v = 0; v < (BM * BK / 8) / kThreads; ++v) {
        const int e = tid + v * kThreads;
        const int r = e / (BK / 8);
        const int c8 = (e % (BK / 8)) * 8;
        const int64_t s = s_src[r];
        uint4 val = make_uint4(0, 0, 0, 0);
        if (s >= 0 && k0 + c8 < k_in)
          val = *reinterpret_cast<const uint4*>(flat + s * k_in + k0 + c8);
        *reinterpret_cast<uint4*>(&sA[r][c8]) = val;
      }
      // B tile: BK x BN block of W[tap]
#pragma unroll
      for (int v = 0; v < (BK * BN / 8) / kThreads; ++v) {
        const int e = tid + v * kThreads;
        const int kr = e / (BN / 8);
        const int c8 = (e % (BN / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + kr < k_in && col0 + c8 < k_out)
          val = *reinterpret_cast<const uint4*>(
              w + (tap * k_in + k0 + kr) * k_out + col0 + c8);
        *reinterpret_cast<uint4*>(&sB[kr][c8]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &sA[wm * WM + i * 16][kk], BK + APAD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], &sB[kk][wn * WN + j * 16], BN + BPAD);
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

extern "C" int upcc_tap_gemm(const void* flat, int64_t n_src, int64_t k_in,
                             const void* idx, const void* ok, int64_t rows,
                             int64_t taps, const void* w, int64_t k_out,
                             const void* wmask, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (k_in % 8 || k_out % 8 || n_src < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((k_out + BN - 1) / BN));
  tap_gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)flat, n_src, k_in, (const int32_t*)idx,
      (const uint8_t*)ok, rows, taps, (const __nv_bfloat16*)w, k_out,
      (const uint8_t*)wmask, (float*)out);
  return (int)cudaGetLastError();
}
