// K1w: weight gradient of the tap gather-GEMM (K1), for Hopper (sm_90a).
//
// Replaces what JAX's autodiff derives for the weight stack of
// upcc_tpu/ops/family.py::_tap_scan_gemm (family.py:610) under the
// rematerialized training convs (family.py:743-793):
//
//   dW[k] = sum_r ok[r, k] * flat[min(idx[r, k], n_src - 1), :]^T @ dacc[r, :]
//
// for the [64 x BN] blocks of the [T, K_in, K_out] stack that the layer's
// prepared plan lists (ops/tapplan.py), and no other: every unlisted block
// is a structural zero of the layer's tap table.  flat bf16 [n_src, K_in],
// idx int32 / ok uint8 [rows, T], dacc bf16 [rows, K_out] (the f32 output
// gradient rounded to bf16), dW f32 [n_blocks, 64, BN], K by N in list
// order.  A gathered-A, row-reduced GEMM with f32 accumulation.
//
// What bounds it: tensor-core operations (2 flops per listed weight
// element and row) on the large layers; at the small ones the reads of
// flat and dacc.  This first version is simple and deterministic, not
// fast: one thread block per (listed block, chunk of rows); 8 warps hold
// the 64 x BN f32 sum in WMMA accumulators (bf16 m16n16k16); each step
// gathers 32 rows of the block's tap into shared memory with 16-byte loads
// (rows the tap misses are zero, steps where it misses every row are
// skipped) and adds their products.  Each chunk writes its partial block;
// a second pass adds the chunks' partials in chunk order.  No float
// atomics anywhere: equal inputs give equal bits.  A wgmma/TMA mainloop
// (tap_mainloop.cuh's) with a split-K layout is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBK = 64;           // K rows of a listed block (plan bk)
constexpr int kStep = 32;         // rows one step gathers
constexpr int kThreads = 256;     // 8 warps
constexpr int kApad = kBK + 8;    // bf16 per shared A row (16-byte pad)
constexpr int kBpad = 128 + 8;    // bf16 per shared B row (BN <= 128)

struct Params {
  const __nv_bfloat16* flat;
  const int32_t* idx;
  const uint8_t* ok;
  const __nv_bfloat16* dacc;
  const int32_t* blocks;  // [n_blocks, 3]: tap, first K, column block
  float* part;            // [chunks, n_blocks, 64, bn]
  int64_t n_src, k_in, rows, k_out, n_blocks, chunk;
  int taps, bn;
};

// NF: 16-wide fragment columns per warp (bn / 32); warp w owns fragment
// row w & 3 and fragment columns (w >> 2) + 2 t, t < NF
template <int NF>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(Params p) {
  __shared__ __align__(128) __nv_bfloat16 As[kStep][kApad];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStep][kBpad];
  const int64_t blk = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int tap = p.blocks[blk * 3 + 0];
  const int k0 = p.blocks[blk * 3 + 1];
  const int64_t n0 = (int64_t)p.blocks[blk * 3 + 2] * p.bn;
  const int warp = threadIdx.x >> 5;
  const int fi = warp & 3;
  const int fj = warp >> 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int t = 0; t < NF; ++t) wmma::fill_fragment(acc[t], 0.0f);

  const int64_t r_begin = c * p.chunk;
  const int64_t r_end =
      p.rows < r_begin + p.chunk ? p.rows : r_begin + p.chunk;
  // A copy: thread -> row threadIdx / 8, 8 bf16 at column (threadIdx % 8) * 8
  const int ar = threadIdx.x >> 3;
  const int ac = (threadIdx.x & 7) * 8;
  const int bchunks = p.bn / 8;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kStep) {
    const int64_t r = r0 + ar;
    int take = 0;
    uint4 va = make_uint4(0u, 0u, 0u, 0u);
    if (r < r_end && p.ok[r * p.taps + tap]) {
      take = 1;
      if (k0 + ac < p.k_in) {
        int64_t s = p.idx[r * p.taps + tap];
        s = s < p.n_src - 1 ? s : p.n_src - 1;
        va = *reinterpret_cast<const uint4*>(p.flat + s * p.k_in + k0 + ac);
      }
    }
    // the tap reaches none of these rows: they add nothing
    if (!__syncthreads_or(take)) continue;
    *reinterpret_cast<uint4*>(&As[ar][ac]) = va;
    for (int i = threadIdx.x; i < kStep * bchunks; i += kThreads) {
      const int br = i / bchunks;
      const int bc = (i - br * bchunks) * 8;
      const int64_t rr = r0 + br;
      uint4 vb = make_uint4(0u, 0u, 0u, 0u);
      if (rr < r_end && n0 + bc < p.k_out)
        vb = *reinterpret_cast<const uint4*>(p.dacc + rr * p.k_out + n0 + bc);
      *reinterpret_cast<uint4*>(&Bs[br][bc]) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
      // A^T (64 x rows) is As read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa;
      wmma::load_matrix_sync(fa, &As[kk][fi * 16], kApad);
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &Bs[kk][(fj + 2 * t) * 16], kBpad);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
    __syncthreads();
  }
  float* out = p.part + (c * p.n_blocks + blk) * (int64_t)(kBK * p.bn);
#pragma unroll
  for (int t = 0; t < NF; ++t)
    wmma::store_matrix_sync(out + fi * 16 * p.bn + (fj + 2 * t) * 16, acc[t],
                            p.bn, wmma::mem_row_major);
}

// out[i] = sum over chunks c, in order, of part[c][i]
__global__ void wgrad_reduce_kernel(const float4* __restrict__ part,
                              float4* __restrict__ out, int64_t n4,
                              int64_t chunks) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int64_t c = 1; c < chunks; ++c) {
      const float4 v = part[c * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

}  // namespace

extern "C" int upcc_tap_wgrad(const void* flat, int64_t n_src, int64_t k_in,
                              const void* idx, const void* ok, int64_t rows,
                              int64_t taps, const void* dacc, int64_t k_out,
                              const void* blocks, int64_t n_blocks,
                              int64_t bn, int64_t chunk, int64_t chunks,
                              void* part, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (rows <= 0 || k_in % 8 || k_out % 8 || n_src < 1 ||
      n_src > 0x7fffffffLL || taps < 1 || taps > 32 || bn < 32 || bn > 128 ||
      bn % 32 || chunk < kStep || chunk % kStep || chunks < 1 ||
      chunks > 65535 || n_blocks > 0x7fffffffLL ||
      (chunks > 1 && part == out) || (chunks == 1 && part != out))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.flat = (const __nv_bfloat16*)flat;
  p.idx = (const int32_t*)idx;
  p.ok = (const uint8_t*)ok;
  p.dacc = (const __nv_bfloat16*)dacc;
  p.blocks = (const int32_t*)blocks;
  p.part = (float*)part;
  p.n_src = n_src;
  p.k_in = k_in;
  p.rows = rows;
  p.k_out = k_out;
  p.n_blocks = n_blocks;
  p.chunk = chunk;
  p.taps = (int)taps;
  p.bn = (int)bn;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)n_blocks, (unsigned)chunks);
  switch (bn / 32) {
    case 1: wgrad_kernel<1><<<grid, kThreads, 0, s>>>(p); break;
    case 2: wgrad_kernel<2><<<grid, kThreads, 0, s>>>(p); break;
    case 3: wgrad_kernel<3><<<grid, kThreads, 0, s>>>(p); break;
    default: wgrad_kernel<4><<<grid, kThreads, 0, s>>>(p); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t n4 = n_blocks * kBK * bn / 4;
  int64_t nblk = (n4 + 255) / 256;
  if (nblk > 8192) nblk = 8192;
  wgrad_reduce_kernel<<<(unsigned)nblk, 256, 0, s>>>((const float4*)part,
                                               (float4*)out, n4, chunks);
  return (int)cudaGetLastError();
}
