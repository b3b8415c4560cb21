// The tap gather-GEMM mainloop shared by K1 (tap_gemm.cu) and P1
// (tile_tapconv.cu), for Hopper (sm_90a); K1w (tap_wgrad.cu) uses its copy
// and wgmma helpers and the MN-major ones below.
//
//   out[r, :] = sum over the listed (tap, K block) pairs of
//               src[row(r, tap), k0 : k0 + BK] @ W[tap][k0 : k0 + BK, cols]
//
// One block owns BM = 64 * WGS rows and one column block of BN columns and
// walks that column block's list of nonzero weight blocks (tap-major, then
// K-major; ops/tapplan.py).  What it is made of:
//
// * a ring of STAGES stages in dynamic shared memory, each an A tile
//   [BM rows x 128 bytes] of gathered source rows and a B tile [BN x 128
//   bytes] of packed weights (K-major, one 128-byte row per output column);
// * all threads start 16-byte cp.async copies for the stage STAGES-1 ahead
//   (A is a row gather, which a TMA tile load cannot express; rows a tap
//   does not reach and the K tail are zero-filled with src-size 0), writing
//   straight into the 128-byte-swizzled layout the wgmma descriptors name:
//   16-byte chunk c of row r lands at chunk c ^ (r & 7);
// * each warpgroup multiplies its 64 rows with wgmma.mma_async (m64nBNk16
//   bf16, or m64nBNk8 TF32), both operands read from shared memory, the
//   f32 accumulator [64 x BN] held in registers over the whole list and
//   written once;
// * per step: cp.async.wait_group (the stage has landed), wgmma.wait_group
//   (the previous product is done, so the stage it read is free),
//   fence.proxy.async (cp.async writes are generic-proxy writes, wgmma
//   reads through the async proxy), one __syncthreads, the four k-steps of
//   this stage, then the copies for the stage that was freed.  The copies
//   run while the tensor cores work; two blocks per SM cover each other's
//   barrier.
//
// The block's [BM, T] index slab is read once, coalesced, into shared
// memory as source rows (-1: not read); a T-bit word says which taps any
// row of the tile reads, and whole taps outside it are skipped.
//
// Order of summation: an output element's f32 sum runs over its listed
// products in list order, 16 (bf16) or 8 (TF32) K values per wgmma step,
// whatever BM, BN, the grid or the other rows of the tile are; skipped
// taps and zero-filled rows only drop or add exact zeros.  No atomics, no
// split of the sum across blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tapml {

struct Params {
  const void* src;         // [n_src, k_in] operand rows
  const int32_t* idx;      // [rows, taps]
  const uint8_t* ok;       // [rows, taps], or null: every tap is read
  const void* wpack;       // [n_blocks, BN, BK] K-major weight tiles
  const int32_t* tap_ptr;  // [n_col, taps + 1] list ranges per column block
  const int32_t* blk_k0;   // [n_blocks] first K of each listed block
  float* out;              // [rows, k_out]
  int64_t n_src, k_in, k_out, rows;
  int64_t tile;            // > 0: idx is local to the row's tile of `tile` rows
  int taps, n_col;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// K-major operand tile, rows of 128 bytes, 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); LBO is not used by swizzled K-major layouts.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// D[64 x N] += A[64 x k] * B[N x k]^T, both tiles in shared memory
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 32>(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 128>(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<float, 32>(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<float, 64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<float, 128>(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// MN-major operand tile (K1w, tap_wgrad.cu): rows of 128 bytes hold 64
// consecutive M (or N) elements of one K index, 128-byte swizzle as above.
// 8-row K groups are 1024 bytes apart.  A tile read by one instruction
// spans one 64-element swizzle atom in M/N, so the offset between atoms is
// never used; it is set to the same 1024 bytes so that the descriptor
// means the same whichever of its two offsets the K-group stride is.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)(1024 >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// D[64 x N] += A[64 x k] * B[k x N], bf16, both tiles MN-major in shared
// memory (transpose immediates set: legal for 16-bit types only); a k-step
// of 16 advances both descriptors by 16 rows (2048 bytes)
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da,
                                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_mn<32>(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_mn<64>(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T, int WGS, int BN, int STAGES>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int NT = 128 * WGS;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SLAB = BM + 1;  // padded row of the source-row slab
  static size_t smem_bytes(int taps) {
    return (size_t)STAGES * STAGE_BYTES + (size_t)taps * SLAB * 4 + 1024;
  }
};

template <typename T, int WGS, int BN, int STAGES>
__global__ void __launch_bounds__(128 * WGS, 2)
tap_mainloop_kernel(const Params p) {
  using C = Cfg<T, WGS, BN, STAGES>;
  constexpr int AHEAD = STAGES - 1;  // steps the copies run ahead
  constexpr int BM = C::BM, NT = C::NT, SLAB = C::SLAB;
  constexpr int BK = 128 / sizeof(T);   // elements of one 128-byte row
  constexpr int VEC = 16 / sizeof(T);   // elements of one 16-byte chunk

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint32_t s_mask;
  __shared__ int s_nit;
  __shared__ int s_tap[32], s_beg[32], s_end[32];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;  // 1024-byte aligned: the swizzle needs it
  int32_t* s_src =
      reinterpret_cast<int32_t*>(smem_raw + pad + STAGES * C::STAGE_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int col = (int)(blockIdx.x % (unsigned)p.n_col);
  const int64_t row0 = (int64_t)(blockIdx.x / (unsigned)p.n_col) * BM;
  const int64_t col0 = (int64_t)col * BN;
  const int taps = p.taps;
  const T* __restrict__ src = static_cast<const T*>(p.src);
  const T* __restrict__ wpack = static_cast<const T*>(p.wpack);

  if (tid == 0) s_mask = 0;
  __syncthreads();

  // the tile's source rows, read once and coalesced: s_src[tap][row]
  {
    uint32_t bits = 0;
    const int64_t g0 = row0 * taps;
    for (int e = tid; e < BM * taps; e += NT) {
      const int r = e / taps;
      const int k = e - r * taps;
      int32_t s = -1;
      if (row0 + r < p.rows) {
        if (p.tile > 0) {
          int64_t loc = p.idx[g0 + e];
          loc = loc < 0 ? 0 : (loc < p.tile ? loc : p.tile - 1);
          s = (int32_t)((row0 + r) / p.tile * p.tile + loc);
        } else if (p.ok[g0 + e]) {
          int64_t v = p.idx[g0 + e];
          v = v < p.n_src - 1 ? v : p.n_src - 1;
          s = (int32_t)(v < 0 ? 0 : v);
        }
      }
      s_src[k * SLAB + r] = s;
      if (s >= 0) bits |= 1u << k;
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&s_mask, bits);
  }
  __syncthreads();
  // the taps some row reads and the column block lists, with their list
  // ranges, compacted in tap order by the first warp (one lane per tap)
  if (tid < 32) {
    const int32_t* tp = p.tap_ptr + (int64_t)col * (taps + 1);
    int b = 0, e = 0;
    if (lane < taps) {
      b = tp[lane];
      e = tp[lane + 1];
    }
    const bool on = lane < taps && ((s_mask >> lane) & 1u) && e > b;
    const uint32_t live = __ballot_sync(0xffffffffu, on);
    if (on) {
      const int n = __popc(live & ((1u << lane) - 1u));
      s_tap[n] = lane;
      s_beg[n] = b;
      s_end[n] = e;
    }
    int total = on ? e - b : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) s_nit = total;
  }
  __syncthreads();
  const int n_it = s_nit;

  // copies of one step: the A rows of `tap` at K block k0, weight tile `le`
  auto copy_step = [&](int stage, int tap, int le) {
    const int k0 = __ldg(p.blk_k0 + le);
    const uint32_t a_dst = sbase + stage * C::STAGE_BYTES;
    const uint32_t b_dst = a_dst + C::A_BYTES;
    const int32_t* rows_of = s_src + tap * SLAB;
#pragma unroll
    for (int v = 0; v < BM * 8 / NT; ++v) {
      const int e = tid + v * NT;
      const int r = e >> 3, c = e & 7;
      const int32_t s = rows_of[r];
      const int64_t kk = (int64_t)k0 + c * VEC;
      const bool on = s >= 0 && kk < p.k_in;
      const T* g = on ? src + (int64_t)s * p.k_in + kk : src;
      cp_async16(a_dst + r * 128 + ((c ^ (r & 7)) << 4), g, on ? 16 : 0);
    }
    const T* wt = wpack + (int64_t)le * (BN * BK);
#pragma unroll
    for (int v = 0; v < (BN * 8 + NT - 1) / NT; ++v) {
      const int e = tid + v * NT;
      if (BN * 8 % NT == 0 || e < BN * 8) {
        const int n = e >> 3, c = e & 7;
        cp_async16(b_dst + n * 128 + ((c ^ (n & 7)) << 4),
                   wt + n * BK + c * VEC, 16);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  // the copy cursor over the active taps' list ranges
  int lt = 0, le = n_it > 0 ? s_beg[0] : 0, lend = n_it > 0 ? s_end[0] : 0;
  int queued = 0;
  auto copy_next = [&](int stage) {
    if (queued < n_it) {
      copy_step(stage, s_tap[lt], le);
      ++queued;
      if (++le == lend && queued < n_it) {
        ++lt;
        le = s_beg[lt];
        lend = s_end[lt];
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) copy_next(s);

  int stage = 0;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of step `it` landed
    wgmma_wait<0>();             // the product of step it-1 is done
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed, stage it-1 is free
    const uint32_t a = sbase + stage * C::STAGE_BYTES + wg * (64 * 128);
    const uint32_t b = sbase + stage * C::STAGE_BYTES + C::A_BYTES;
    const uint64_t da = make_desc(a), db = make_desc(b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // 32 bytes of K per step
      wgmma_ss<T, BN>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    copy_next(stage + AHEAD >= STAGES ? stage + AHEAD - STAGES
                                       : stage + AHEAD);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // epilogue: thread (warp w, lane l) of a warpgroup holds rows
  // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1)
  const int64_t r0 = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int64_t r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int64_t c = col0 + j * 8 + (lane & 3) * 2;
    if (c < p.k_out) {
      if (r0 < p.rows)
        *reinterpret_cast<float2*>(p.out + r0 * p.k_out + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r1 < p.rows)
        *reinterpret_cast<float2*>(p.out + r1 * p.k_out + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <typename T, int WGS, int BN, int STAGES>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<T, WGS, BN, STAGES>;
  auto kernel = tap_mainloop_kernel<T, WGS, BN, STAGES>;
  const size_t smem = C::smem_bytes(p.taps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (p.rows + C::BM - 1) / C::BM * p.n_col;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, C::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// row tile (WGS x 64 rows) and column block by run-time value; the ring is
// as deep as lets two blocks share an SM
template <typename T>
cudaError_t dispatch(const Params& p, int bn, int wgs, cudaStream_t stream) {
#define UPCC_TAP_CASE(W, N, S) \
  if (wgs == W && bn == N) return launch<T, W, N, S>(p, stream);
  UPCC_TAP_CASE(1, 32, 4)
  UPCC_TAP_CASE(1, 64, 4)
  UPCC_TAP_CASE(1, 128, 4)
  UPCC_TAP_CASE(2, 32, 4)
  UPCC_TAP_CASE(2, 64, 4)
  UPCC_TAP_CASE(2, 128, 3)
#undef UPCC_TAP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace tapml
