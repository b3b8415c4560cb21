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
// idx int32 [rows, T] (ok enters through the row lists below), dacc bf16
// [rows, K_out] (the f32 output gradient rounded to bf16), dW f32
// [n_blocks, 64, BN], K by N in list order.  A gathered-A GEMM whose
// reduction runs over rows, f32 sums.
//
// What bounds it: on the training calls, bytes (reading flat and dacc
// once is 20-50 times the operations' time at the bf16 peak).  The kernel
// reads them more than once: each listed block needs its tap's rows of
// both, so a gathered A row serves every column block of its (tap, K
// block) pair and a dacc row every (tap, K block) pair of its column.
// What the design does about it:
//
// * the work unit is a wgrad tile (ops/tapplan.py::wgrad_tile_list): one
//   tap, one K block and up to two listed column blocks of that pair, in
//   (tap, K block, column) order, so one gathered A tile feeds both column
//   blocks (two consumer warpgroups, each a 64 x BN f32 sum in registers)
//   and neighbouring tiles share their rows in L2;
// * per-tap row lists (ops/family.py::wgrad_row_lists: the rows with
//   ok[r, k], ascending, built on the device once per map by a few PyTorch
//   operations): a tile reads only the rows its tap reaches, so no product
//   is an exact zero;
// * a ring of 4 stages in dynamic shared memory, each ROWS list entries
//   (64, or 32 for a pair, so that two blocks share an SM): A, the gathered
//   rows' 128 bytes of the K block, and B, the same rows of dacc as
//   128-byte sub-tiles of 64 columns, both filled by 16-byte cp.async into
//   the 128-byte swizzle of tap_mainloop.cuh (chunk c of row r at
//   c ^ (r & 7)); the list entries' rows and sources are staged in shared
//   memory 1024 at a time;
// * the reduction dimension is rows, so both operands are MN-major in
//   shared memory: wgmma m64nNk16 bf16 with both transpose immediates set
//   (tap_mainloop.cuh's wgmma_ss_mn), a k-step 16 rows further; copies for
//   stage s + STAGES - 1 run while stage s multiplies, with
//   tap_mainloop.cuh's wait / fence / barrier order;
// * the grid is tiles x row splits, the split count chosen on the host from
//   rows alone (ops/family.py::wgrad_splits); a split covers a fixed range
//   of its tap's list and is empty past the tap's count.  One split writes
//   dW directly.  Otherwise each non-empty split writes its f32 partial to
//   scratch, takes an integer ticket (atomicAdd after __threadfence), and
//   the last split of a tile to arrive adds the non-empty partials in split
//   order and writes the block, then sets the ticket back to zero.  The
//   order of every sum is fixed whatever the schedule: equal inputs give
//   equal bits, with no float atomics and one launch a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tap_mainloop.cuh"

namespace {

using tapml::cp_async16;
using tapml::cp_async_commit;
using tapml::cp_async_wait;
using tapml::fence_proxy_async;
using tapml::make_desc_mn;
using tapml::smem_u32;
using tapml::wgmma_commit;
using tapml::wgmma_fence;
using tapml::wgmma_ss_mn;
using tapml::wgmma_wait;

constexpr int kBK = 64;     // K rows of a listed block: M of the product
constexpr int kSeg = 1024;  // list entries staged in shared memory at once
constexpr int kTile = 8;    // int32 fields of one wgrad tile

struct Params {
  const __nv_bfloat16* flat;  // [n_src, k_in]
  const int32_t* idx;         // [rows, taps]
  const __nv_bfloat16* dacc;  // [rows, k_out]
  // [n_tiles, 8]: tap, first K, blocks (1 or 2), column 0, list position
  // 0, column 1, list position 1, unused
  const int32_t* tiles;
  // per-tap row lists, tap-major (ops/family.py::wgrad_row_lists):
  // ends, the running count of ok^T flattened; entry i of tap t is row
  // lists[1 + ends[t rows - 1] + i] - t rows
  const int32_t* lists;
  const int64_t* ends;
  float* out;        // [n_blocks, 64, bn]
  float* part;       // [splits, n_blocks, 64, bn] when splits > 1
  int32_t* tickets;  // [n_tiles], zero on entry and left zero
  int64_t n_src, k_in, rows, k_out, n_blocks, chunk;
  int taps, splits;
};

// ROWS: list entries (the reduction) of one stage
template <int BN, int NCB, int ROWS, int STAGES>
struct WCfg {
  static constexpr int NT = 128 * NCB;          // one warpgroup a column block
  static constexpr int NW = BN < 64 ? BN : 64;  // N of one wgmma
  static constexpr int NSUB = BN / NW;          // 64-column sub-tiles
  static constexpr int SUB = ROWS * 128;        // bytes of one sub-tile
  static constexpr int A_BYTES = ROWS * 128;
  static constexpr int STAGE = A_BYTES + NCB * NSUB * SUB;
  static size_t smem_bytes() {
    return (size_t)STAGES * STAGE + 2 * kSeg * sizeof(int32_t) + 1024;
  }
};

template <int BN, int NCB, int ROWS, int STAGES>
__global__ void __launch_bounds__(128 * NCB, 2)
tap_wgrad_kernel(const Params p) {
  using C = WCfg<BN, NCB, ROWS, STAGES>;
  constexpr int kRows = ROWS;
  constexpr int NT = C::NT, NW = C::NW, NSUB = C::NSUB, SUB = C::SUB;
  constexpr int AHEAD = STAGES - 1;
  constexpr int CPR = BN / 8;  // 16-byte chunks of a row of one column block

  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;  // 1024-byte aligned: the swizzle needs it
  int32_t* s_row =
      reinterpret_cast<int32_t*>(smem_raw + pad + STAGES * C::STAGE);
  int32_t* s_src = s_row + kSeg;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int32_t* tl = p.tiles + (int64_t)blockIdx.x * kTile;
  const int tap = tl[0];
  const int k0 = tl[1];
  const int nblk = tl[2];
  const int64_t col0 = (int64_t)tl[3] * BN;
  const int64_t col1 = nblk > 1 ? (int64_t)tl[5] * BN : 0;
  const int split = (int)blockIdx.y;
  const int64_t base = tap > 0 ? p.ends[tap * p.rows - 1] : 0;
  const int64_t count = p.ends[(tap + 1) * p.rows - 1] - base;
  const int64_t beg = (int64_t)split * p.chunk;
  const int64_t end = count < beg + p.chunk ? count : beg + p.chunk;
  const int64_t n = end > beg ? end - beg : 0;  // this split's entries
  const int n_st = (int)((n + kRows - 1) / kRows);
  const bool mma_on = wg < nblk;  // uniform over the warpgroup

  // list entries [first, first + kSeg) of the split: their rows and
  // source rows (both -1 past the end: dacc and flat zero-filled)
  auto load_seg = [&](int64_t first) {
    for (int e = tid; e < kSeg; e += NT) {
      const int64_t i = first + e;
      int32_t row = -1, src = -1;
      if (i < n) {
        const int64_t r = (int64_t)p.lists[1 + base + beg + i] - tap * p.rows;
        int64_t s = p.idx[r * p.taps + tap];
        s = s < p.n_src - 1 ? s : p.n_src - 1;
        row = (int32_t)r;
        src = (int32_t)(s < 0 ? 0 : s);
      }
      s_row[e] = row;
      s_src[e] = src;
    }
  };

  // the copies of stage j (64 entries) into ring slot `slot`
  auto copy_stage = [&](int slot, int j) {
    const int eb = (j * kRows) % kSeg;
    const uint32_t a_dst = sbase + slot * C::STAGE;
    const uint32_t b_dst = a_dst + C::A_BYTES;
#pragma unroll
    for (int v = 0; v < kRows * 8 / NT; ++v) {
      const int e = tid + v * NT;
      const int r = e >> 3, c = e & 7;
      const int32_t s = s_src[eb + r];
      const int64_t kk = (int64_t)k0 + c * 8;
      const bool on = s >= 0 && kk < p.k_in;
      const __nv_bfloat16* g = on ? p.flat + (int64_t)s * p.k_in + kk : p.flat;
      cp_async16(a_dst + r * 128 + ((c ^ (r & 7)) << 4), g, on ? 16 : 0);
    }
    constexpr int BCH = kRows * NCB * CPR;
#pragma unroll
    for (int v = 0; v < (BCH + NT - 1) / NT; ++v) {
      const int e = tid + v * NT;
      if (BCH % NT == 0 || e < BCH) {
        const int c = e % CPR;
        const int rb = e / CPR;
        const int cb = rb % NCB, r = rb / NCB;
        if (cb < nblk) {
          const int32_t row = s_row[eb + r];
          const int64_t col = (cb == 0 ? col0 : col1) + c * 8;
          const bool on = row >= 0 && col < p.k_out;
          const __nv_bfloat16* g =
              on ? p.dacc + (int64_t)row * p.k_out + col : p.dacc;
          cp_async16(b_dst + (cb * NSUB + (c >> 3)) * SUB + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4),
                     g, on ? 16 : 0);
        }
      }
    }
  };

  float acc[NSUB][NW / 2];
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[h][i] = 0.0f;

  int queued = 0;
  auto copy_next = [&](int slot) {
    if (queued < n_st) {
      if (queued > 0 && (queued * kRows) % kSeg == 0) {
        __syncthreads();  // every copy that read the old entries is issued
        load_seg((int64_t)queued * kRows);
        __syncthreads();
      }
      copy_stage(slot, queued);
      ++queued;
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  if (n_st > 0) load_seg(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) copy_next(s);

  int slot = 0;
  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of stage `it` landed
    wgmma_wait<0>();             // the product of stage it-1 is done
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed, stage it-1 is free
    if (mma_on) {
      const uint32_t a = sbase + slot * C::STAGE;
      const uint32_t b = a + C::A_BYTES + wg * NSUB * SUB;
      const uint64_t da = make_desc_mn(a);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks)
#pragma unroll
        for (int h = 0; h < NSUB; ++h)
          wgmma_ss_mn<NW>(acc[h], da + ks * 128,
                          make_desc_mn(b + h * SUB) + ks * 128);
      wgmma_commit();
    }
    copy_next(slot + AHEAD >= STAGES ? slot + AHEAD - STAGES : slot + AHEAD);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      asm volatile("" : "+f"(acc[h][i])::"memory");

  // a thread (warp w, lane l of its warpgroup) holds rows 16 w + l / 4
  // (+ 8) of the block and columns h NW + 8 j + 2 (l % 4) (+ 1)
  const int m0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cl = (lane & 3) * 2;
  const int64_t blk = BN * (int64_t)kBK;
  const int64_t pos = mma_on ? tl[4 + 2 * wg] : 0;
  auto store = [&](float* dst) {
#pragma unroll
    for (int h = 0; h < NSUB; ++h)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        float* q = dst + m0 * BN + h * NW + j * 8 + cl;
        *reinterpret_cast<float2*>(q) =
            make_float2(acc[h][4 * j], acc[h][4 * j + 1]);
        *reinterpret_cast<float2*>(q + 8 * BN) =
            make_float2(acc[h][4 * j + 2], acc[h][4 * j + 3]);
      }
  };
  if (p.splits == 1) {
    if (mma_on) store(p.out + pos * blk);
    return;
  }
  if (mma_on && n > 0) store(p.part + ((int64_t)split * p.n_blocks + pos) * blk);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(p.tickets + blockIdx.x, 1);
    s_last = t == p.splits - 1;
    if (s_last) p.tickets[blockIdx.x] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!s_last || !mma_on) return;
  __threadfence();
  // the last split of the tile: the non-empty splits' partials (its own
  // among them), added in split order
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[h][i] = 0.0f;
  for (int s = 0; s < p.splits; ++s) {
    if ((int64_t)s * p.chunk >= count) break;  // this split and later: empty
    const float* src = p.part + ((int64_t)s * p.n_blocks + pos) * blk;
#pragma unroll
    for (int h = 0; h < NSUB; ++h)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float* q = src + m0 * BN + h * NW + j * 8 + cl;
        const float2 v0 = __ldcg(reinterpret_cast<const float2*>(q));
        const float2 v1 = __ldcg(reinterpret_cast<const float2*>(q + 8 * BN));
        acc[h][4 * j] += v0.x;
        acc[h][4 * j + 1] += v0.y;
        acc[h][4 * j + 2] += v1.x;
        acc[h][4 * j + 3] += v1.y;
      }
  }
  store(p.out + pos * blk);
}

template <int BN, int NCB, int ROWS, int STAGES>
cudaError_t launch(const Params& p, int64_t n_tiles, cudaStream_t stream) {
  using C = WCfg<BN, NCB, ROWS, STAGES>;
  auto kernel = tap_wgrad_kernel<BN, NCB, ROWS, STAGES>;
  const size_t smem = C::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)n_tiles, (unsigned)p.splits);
  kernel<<<grid, C::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// pairs: 1 for tiles of up to two column blocks (two consumer warpgroups),
// 0 for single-column tiles
extern "C" int upcc_tap_wgrad(const void* flat, int64_t n_src, int64_t k_in,
                              const void* idx, int64_t rows, int64_t taps,
                              const void* dacc, int64_t k_out,
                              const void* tiles, int64_t n_tiles,
                              int64_t pairs, const void* lists,
                              const void* ends, int64_t n_blocks, int64_t bn,
                              int64_t chunk, int64_t splits, void* part,
                              void* tickets, void* out, void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0) return 0;
  if (rows <= 0 || rows >= 0x7fffffffLL || k_in % 8 || k_out % 8 ||
      n_src < 1 || n_src > 0x7fffffffLL || taps < 1 || taps > 32 ||
      (bn != 32 && bn != 64 && bn != 128) || (pairs != 0 && pairs != 1) ||
      chunk < 64 || chunk % 64 || splits < 1 || splits > 65535 ||
      (splits - 1) * chunk >= rows || n_tiles > 0x7fffffffLL ||
      n_blocks > 0x7fffffffLL || lists == nullptr || ends == nullptr ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.flat = (const __nv_bfloat16*)flat;
  p.idx = (const int32_t*)idx;
  p.dacc = (const __nv_bfloat16*)dacc;
  p.tiles = (const int32_t*)tiles;
  p.lists = (const int32_t*)lists;
  p.ends = (const int64_t*)ends;
  p.out = (float*)out;
  p.part = (float*)part;
  p.tickets = (int32_t*)tickets;
  p.n_src = n_src;
  p.k_in = k_in;
  p.rows = rows;
  p.k_out = k_out;
  p.n_blocks = n_blocks;
  p.chunk = chunk;
  p.taps = (int)taps;
  p.splits = (int)splits;
  cudaStream_t s = (cudaStream_t)stream;
  // four stages, at most 24 KB each (32 rows a stage for a pair, 64 for
  // one column block): two blocks or more an SM
  if (pairs) {
    if (bn == 128) return (int)launch<128, 2, 32, 4>(p, n_tiles, s);
    if (bn == 64) return (int)launch<64, 2, 32, 4>(p, n_tiles, s);
    return (int)launch<32, 2, 32, 4>(p, n_tiles, s);
  }
  if (bn == 128) return (int)launch<128, 1, 64, 4>(p, n_tiles, s);
  if (bn == 64) return (int)launch<64, 1, 64, 4>(p, n_tiles, s);
  return (int)launch<32, 1, 64, 4>(p, n_tiles, s);
}
