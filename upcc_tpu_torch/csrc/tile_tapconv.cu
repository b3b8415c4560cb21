// P1: tile-local tap gather + product for Hopper (sm_90a).
//
// Replaces the Pallas probe kernel of scripts/micro_gather.py
// (make_pallas_tapconv, the kernel body at :85-94):
//
//   out[r, :] = sum_{k < T} x[tile(r) * TILE + idx[r, k], :] @ W[k]
//
// x [R, K_in] in bf16 or f32, idx int32 [R, T] with every index local to
// the row's tile of TILE rows (clipped into it), out f32 [R, K_out].  No
// validity mask and dense weights: it measures the gather + tensor-core
// primitive alone, at one fixed shape (R = 2^19, K_in = K_out = 128, T = 27,
// TILE = 2048).  W arrives packed as K-major [BN x 128-byte] tiles with the
// dense list of all its blocks (ops/tapplan.py).
//
// What bounds it: tensor-core operations (2 * R * T * K_in * K_out flops
// against R * K_in inputs, R * T indices and R * K_out outputs: ~1000 flops
// per byte, far above the card's ridge).  The TPU kernel held the whole
// tile in on-chip memory; a 2048 x 128 tile is 512 KiB in bf16 and does not
// fit an SM's shared memory.  Here the tile's rows stay hot in L2 (all its
// row blocks run close in time) and the block runs the pipelined
// cp.async -> wgmma mainloop it shares with K1 (tap_mainloop.cuh): gathers
// into a swizzled shared-memory ring overlap the warpgroup products.
//   bf16 operands: wgmma m64nNk16, exact products, f32 sums.
//   f32 operands:  wgmma m64nNk8 TF32.  Both operands are first rounded to
//     TF32 (10 mantissa bits, round to nearest) by the small kernel below
//     into scratch the wrapper provides, because the gather copies rows
//     into shared memory untouched and the tensor core would otherwise
//     truncate them; sums stay f32.  The rounding is this variant's stated
//     tolerance.
//
// Deterministic: fixed tap, K and step order, no atomics.

#include "tap_mainloop.cuh"

namespace {

// in may equal out
__global__ void round_tf32_kernel(const float4* in, float4* out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 v = in[i];
  uint32_t a, b, c, d;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(a) : "f"(v.x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b) : "f"(v.y));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(c) : "f"(v.z));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(d) : "f"(v.w));
  out[i] = make_float4(__uint_as_float(a), __uint_as_float(b),
                       __uint_as_float(c), __uint_as_float(d));
}

cudaError_t round_tf32(const void* in, void* out, int64_t n,
                       cudaStream_t stream) {
  const int64_t n4 = n / 4;
  if (n4 == 0) return cudaSuccess;
  round_tf32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      (const float4*)in, (float4*)out, n4);
  return cudaGetLastError();
}

}  // namespace

// is_f32: 0 = bf16 operands, 1 = f32 operands (TF32 products).  x_round:
// scratch of x's size (f32 only); wpack is rounded in place (f32 only).
extern "C" int upcc_tile_tapconv(const void* x, void* x_round, const void* idx,
                                 void* wpack, int64_t n_blocks,
                                 const void* tap_ptr, const void* blk_k0,
                                 int64_t rows, int64_t k_in, int64_t k_out,
                                 int64_t taps, int64_t tile, int is_f32,
                                 int64_t bn, int64_t wgs, void* out,
                                 void* stream) {
  if (rows <= 0) return 0;
  const int vec = is_f32 ? 4 : 8;
  if (k_in % vec || k_out % 8 || tile < 1 || taps < 1 || taps > 32 ||
      rows > 0x7fffffffLL || bn < 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tapml::Params p;
  p.src = x;
  if (is_f32) {
    cudaError_t err = round_tf32(x, x_round, rows * k_in, s);
    if (err != cudaSuccess) return (int)err;
    err = round_tf32(wpack, wpack, n_blocks * bn * 32, s);
    if (err != cudaSuccess) return (int)err;
    p.src = x_round;
  }
  p.idx = (const int32_t*)idx;
  p.ok = nullptr;
  p.wpack = wpack;
  p.tap_ptr = (const int32_t*)tap_ptr;
  p.blk_k0 = (const int32_t*)blk_k0;
  p.out = (float*)out;
  p.n_src = rows;
  p.k_in = k_in;
  p.k_out = k_out;
  p.rows = rows;
  p.tile = tile;
  p.taps = (int)taps;
  p.n_col = (int)((k_out + bn - 1) / bn);
  if (is_f32) return (int)tapml::dispatch<float>(p, (int)bn, (int)wgs, s);
  return (int)tapml::dispatch<__nv_bfloat16>(p, (int)bn, (int)wgs, s);
}
