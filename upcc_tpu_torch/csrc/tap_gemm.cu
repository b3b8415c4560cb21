// K1: tap gather-GEMM for Hopper (sm_90a).
//
// Replaces the XLA tap scan of upcc_tpu/ops/family.py::_tap_scan_gemm
// (the default scan path, family.py:682-689):
//
//   out[r, :] = sum_{k < T} ok[r, k] * flat[min(idx[r, k], n_src - 1), :] @ W[k]
//
// flat bf16 [n_src, K_in], idx int32 / ok uint8 [rows, T], out f32
// [rows, K_out].  It is the engine under every learned conv of the codec
// (family_conv, family_down_conv, the kernel-5 family_transpose_up and the
// grandparent-brick grand_apply).  W arrives prepared (ops/tapplan.py): only
// the blocks of the [T, K_in, K_out] stack that the layer's static tap table
// marks nonzero, packed as K-major [BN x 64] bf16 tiles, with the list of
// those blocks per column block, tap-major then K-major.
//
// What bounds it: tensor-core operations.  The bound counts 2 flops per
// nonzero weight and row that reads the weight's tap; a dense slot-pair
// stack would cost 8x (kernel-3 child conv) to 60x (grandparent layouts)
// that.  What the design does about it: the block lists skip the structural
// zeros without probing a mask, taps no row of a tile reads are skipped by
// a 27-bit word, rows a tap misses are zero-filled by the copy itself, and
// the rest runs on the pipelined cp.async -> wgmma mainloop of
// tap_mainloop.cuh (gathers overlap the products; f32 accumulators stay in
// registers over all taps; the output is written once).  Small calls take
// 64-row tiles so that they fill more of the card.
//
// Deterministic beyond run-to-run: an output element's summation order is
// fixed by the layer's block list alone, never by the number of rows, the
// row's place in its tile or the grid (tap_mainloop.cuh).  The codec's
// encoder and decoder batch rows differently and rely on it.

#include "tap_mainloop.cuh"

extern "C" int upcc_tap_gemm(const void* flat, int64_t n_src, int64_t k_in,
                             const void* idx, const void* ok, int64_t rows,
                             int64_t taps, const void* wpack, int64_t k_out,
                             const void* tap_ptr, const void* blk_k0,
                             int64_t bn, int64_t wgs, void* out,
                             void* stream) {
  if (rows <= 0) return 0;
  if (k_in % 8 || k_out % 8 || n_src < 1 || n_src > 0x7fffffffLL ||
      taps < 1 || taps > 32 || bn < 8)
    return (int)cudaErrorInvalidValue;
  tapml::Params p;
  p.src = flat;
  p.idx = (const int32_t*)idx;
  p.ok = (const uint8_t*)ok;
  p.wpack = wpack;
  p.tap_ptr = (const int32_t*)tap_ptr;
  p.blk_k0 = (const int32_t*)blk_k0;
  p.out = (float*)out;
  p.n_src = n_src;
  p.k_in = k_in;
  p.k_out = k_out;
  p.rows = rows;
  p.tile = 0;
  p.taps = (int)taps;
  p.n_col = (int)((k_out + bn - 1) / bn);
  return (int)tapml::dispatch<__nv_bfloat16>(p, (int)bn, (int)wgs,
                                             (cudaStream_t)stream);
}
