// K2: exact per-batch top-k mask for Hopper (sm_90a), one cooperative launch.
//
// Replaces upcc_tpu/ops/topk.py::topk_mask together with its one-hot
// matmul histogram _batch_histogram (topk.py:36-120).  For candidates with
// int64 keys (batch = key >> 57, SENTINEL = invalid) and f32 logits, the
// mask keeps exactly k[b] candidates of every batch b: the k largest
// logits, ties at the threshold filled by position (first wins); invalid
// slots never win and k <= 0 keeps nothing.  The mask equals the plain
// version (ops/topk.py::topk_mask_plain) bit for bit.
//
// Algorithm (as the reference): the logits' order-preserving 32-bit image
// u is radix-selected in 4 passes of 256-bin per-batch histograms, each
// pass fixing 8 more bits of every batch's threshold; then every candidate
// is classified (u > thr: keep; u == thr: tie) and a tie is kept when its
// rank among all ties by position, less the ties of earlier batches, is
// below k - #(u > thr).
//
// What bounds it: bytes — keys and logits read once (12 bytes a
// candidate), one byte of mask written.  Design: one persistent grid of
// one 1024-thread block per SM, launched cooperatively, phases separated
// by grid syncs (5 in all), so a call is one launch (its four histograms
// come in zero and are left zero).  Each block owns a contiguous slice (a
// multiple of 4096 candidates).  Resident mode: the block reads its
// slice from memory once and keeps u (4 bytes) and a 16-bit batch index in
// shared memory for every later phase; streaming mode, for slices that do
// not fit, re-reads them in every phase (the wrapper chooses by shape).
// Histograms: one shared 256-bin histogram for each of a window of kWin
// batches from the slice's first batch, fed by one shared atomic a value
// (aggregating a warp's equal bins with __match_any_sync first costs more
// than the atomics it saves, even where the first pass puts nearly every
// logit in a few bins or ties put whole warps in one), flushed into one
// global histogram per pass (four buffers, so nothing is re-zeroed between
// syncs); integer atomics are exact in any order.  Only batches with
// k > 0 are counted.  After each sync every block derives every batch's
// next 8 threshold bits from the global histogram, one warp per batch
// scanning the 256 bins, so the blocks agree without another sync; the
// same scans count the values above the threshold (summed over the
// levels) and at it (the last level's bin), which give k - #(u > thr) and
// the ties of earlier batches.  Tie ranks: each warp counts the ties of a
// contiguous run of its block's slice, each block publishes its total;
// after the last sync a block sums the totals of the blocks before it and
// every warp ranks its run's ties with warp scans in position order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kVec = 4;                  // consecutive candidates a thread takes
constexpr int kChunk = kThreads * kVec;  // 4096: slices are multiples of it
constexpr int kWin = 4;                  // batches of a block's shared histogram
constexpr int kBins = 256;
constexpr int kBatchShift = 57;
constexpr int64_t kSentinel = INT64_MAX;
constexpr uint32_t kInvalid = 0xFFFFu;   // batch index of an invalid slot

__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t bits = __float_as_uint(f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t batch_of(int64_t key, int maxb) {
  if (key == kSentinel) return kInvalid;
  const int64_t b = key >> kBatchShift;
  return (uint32_t)(b < 0 ? 0 : (b > maxb - 1 ? maxb - 1 : b));
}

// candidates i .. i+3 from device memory (i a multiple of 4; past n:
// invalid)
__device__ __forceinline__ void load_global(const int64_t* __restrict__ keys,
                                            const float* __restrict__ logits,
                                            int64_t i, int64_t n, int maxb,
                                            uint32_t u[kVec],
                                            uint32_t b[kVec]) {
  int64_t key[kVec];
  float lg[kVec];
  if (i + kVec <= n) {
    const longlong2 k01 = *reinterpret_cast<const longlong2*>(keys + i);
    const longlong2 k23 = *reinterpret_cast<const longlong2*>(keys + i + 2);
    const float4 l = *reinterpret_cast<const float4*>(logits + i);
    key[0] = k01.x, key[1] = k01.y, key[2] = k23.x, key[3] = k23.y;
    lg[0] = l.x, lg[1] = l.y, lg[2] = l.z, lg[3] = l.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      key[j] = i + j < n ? keys[i + j] : kSentinel;
      lg[j] = i + j < n ? logits[i + j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    u[j] = ordered(lg[j]);
    b[j] = batch_of(key[j], maxb);
  }
}

// exclusive scan of one int per thread over the block; *total = block sum
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = w ? warp_sums[w - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one count in histogram entry key = batch * 256 + bin: in shared memory
// for the batches of the block's window, else in device memory
__device__ __forceinline__ void hist_add(uint32_t key, int b0,
                                         int32_t* s_hist, int32_t* g_hist) {
  const int wb = (int)(key >> 8) - b0;
  if (wb >= 0 && wb < kWin)
    atomicAdd(&s_hist[wb * kBins + (key & 255)], 1);
  else
    atomicAdd(&g_hist[key], 1);
}

// one warp: the bin of batch b's histogram that holds its krem-th largest
// active value; fixes 8 bits of prefix, lowers krem (as topk_mask_plain:
// no bin found leaves both, and this level's bits stay 0).  Adds to *ngt
// the active values in bins above this level's bits (they exceed the
// threshold whatever the lower bits) and, where ties is given, stores the
// count in that bin (at the last level: the values equal to it).
__device__ __forceinline__ void warp_select(const int32_t* hist, int shift,
                                            uint32_t* prefix, int32_t* krem,
                                            int32_t* ngt, int32_t* ties) {
  const int lane = threadIdx.x & 31;
  int h[8], s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    h[q] = __ldcg(hist + lane * 8 + q);
    s += h[q];
  }
  int incl = s;  // count in the bins of lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += y;
  }
  const int kr = *krem;
  int desc = incl - s;  // count in bins above this lane's
  int hit = -1;
#pragma unroll
  for (int q = 7; q >= 0; --q) {
    if (desc < kr && desc + h[q] >= kr) hit = lane * 8 + q;
    desc += h[q];
  }
  // at most one bin satisfies desc < kr <= desc + h
  const unsigned who = __ballot_sync(0xffffffffu, hit >= 0);
  const int t = who ? __shfl_sync(0xffffffffu, hit, __ffs(who) - 1) : 0;
  int above = 0, at = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    above += lane * 8 + q > t ? h[q] : 0;
    at += lane * 8 + q == t ? h[q] : 0;
  }
  above = warp_sum(above);
  at = warp_sum(at);
  if (lane == 0) {
    if (who) {
      *prefix |= (uint32_t)t << shift;
      *krem = kr - above > 0 ? kr - above : 0;
    }
    *ngt += above;
    if (ties != nullptr) *ties = at;
  }
  __syncwarp();
}

// int32 entries of the five per-batch arrays in shared memory, rounded up
// to 16 bytes
__host__ __device__ __forceinline__ int batch_ints(int maxb) {
  return (5 * maxb + 3) & ~3;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
topk_kernel(const int64_t* __restrict__ keys, const float* __restrict__ logits,
            const int32_t* __restrict__ k, int64_t n, int maxb,
            int64_t per_block, int32_t* __restrict__ g_hist,
            int32_t* __restrict__ g_blk, uint8_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 smem4[];
  int32_t* s_hist = reinterpret_cast<int32_t*>(smem4);    // [kWin][256]
  uint32_t* s_prefix = reinterpret_cast<uint32_t*>(s_hist + kWin * kBins);
  int32_t* s_krem = reinterpret_cast<int32_t*>(s_prefix + maxb);
  int32_t* s_need = s_krem + maxb;   // max(k, 0) until the thresholds
  int32_t* s_ngt = s_need + maxb;    // values above the threshold
  int32_t* s_prior = s_ngt + maxb;   // ties, then ties of earlier batches
  // resident slice, 16-byte aligned after the per-batch arrays
  uint32_t* s_u = reinterpret_cast<uint32_t*>(s_hist + kWin * kBins +
                                              batch_ints(maxb));
  uint16_t* s_b = reinterpret_cast<uint16_t*>(s_u + per_block);
  __shared__ int s_b0, s_warp[kThreads / 32];

  // g_hist: [4][maxb][256], zero on entry and exit; g_blk: [gridDim.x]
  // tie totals, whatever they hold on entry
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t rest = n - start;
  const int len = (int)(rest < 0 ? 0 : (rest < per_block ? rest : per_block));

  for (int b = tid; b < maxb; b += kThreads) {
    s_prefix[b] = 0;
    s_krem[b] = s_need[b] = k[b] > 0 ? k[b] : 0;
    s_ngt[b] = s_prior[b] = 0;
  }
  for (int i = tid; i < kWin * kBins; i += kThreads) s_hist[i] = 0;
  if (tid == 0) {
    const uint32_t b0 = len > 0 ? batch_of(keys[start], maxb) : 0;
    s_b0 = b0 == kInvalid ? 0 : (int)b0;
  }

  // resident: the slice from device memory into shared memory, two steps
  // of loads in flight a thread
  if (kResident) {
    for (int c0 = 0; c0 < len; c0 += 2 * kChunk) {
      uint32_t u[2][kVec], b[2][kVec];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h * kChunk + kVec * tid;
        if (c < len) load_global(keys, logits, start + c, n, maxb, u[h], b[h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h * kChunk + kVec * tid;
        if (c < len) {
          *reinterpret_cast<uint4*>(s_u + c) =
              make_uint4(u[h][0], u[h][1], u[h][2], u[h][3]);
          *reinterpret_cast<uint2*>(s_b + c) = make_uint2(
              b[h][0] | (b[h][1] << 16), b[h][2] | (b[h][3] << 16));
        }
      }
    }
  }
  __syncthreads();
  const int b0 = s_b0;

  // candidates c .. c+3 of the slice (c a multiple of 4; past the slice
  // or n: invalid)
  auto items = [&](int c, uint32_t u[kVec], uint32_t b[kVec]) {
    if (c >= len) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) u[j] = 0, b[j] = kInvalid;
    } else if (kResident) {
      const uint4 uu = *reinterpret_cast<const uint4*>(s_u + c);
      const uint2 bb = *reinterpret_cast<const uint2*>(s_b + c);
      u[0] = uu.x, u[1] = uu.y, u[2] = uu.z, u[3] = uu.w;
      b[0] = bb.x & 0xFFFFu, b[1] = bb.x >> 16;
      b[2] = bb.y & 0xFFFFu, b[3] = bb.y >> 16;
    } else {
      load_global(keys, logits, start + c, n, maxb, u, b);
    }
  };

  // four radix passes over the batches with k > 0 (a batch with k <= 0
  // keeps nothing whatever its threshold); each pass's select comes after
  // the grid sync that completes its histogram, in every block alike
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int32_t* gh = g_hist + pass * maxb * kBins;
    if (pass > 0) {
      const int32_t* prev = g_hist + (pass - 1) * maxb * kBins;
      for (int b = warp; b < maxb; b += kThreads / 32)
        if (s_need[b] > 0)
          warp_select(prev + b * kBins, shift + 8, &s_prefix[b], &s_krem[b],
                      &s_ngt[b], nullptr);
      __syncthreads();
    }
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      uint32_t u[kVec], b[kVec];
      items(c0 + kVec * tid, u, b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        bool act = b[j] != kInvalid && s_need[b[j]] > 0;
        if (act && pass > 0)
          act = (u[j] >> (shift + 8)) == (s_prefix[b[j]] >> (shift + 8));
        if (act)
          hist_add(b[j] * kBins + ((u[j] >> shift) & 255), b0, s_hist, gh);
      }
    }
    __syncthreads();
    for (int i = tid; i < kWin * kBins; i += kThreads) {
      const int c = s_hist[i];
      if (c) {
        atomicAdd(&gh[(b0 + i / kBins) * kBins + (i % kBins)], c);
        s_hist[i] = 0;
      }
    }
    grid.sync();
  }

  // the thresholds; the count above each (summed over the levels) and at
  // it (the last level's bin) give need = max(k - #above, 0) and the ties
  // of earlier batches without another sweep
  for (int b = warp; b < maxb; b += kThreads / 32)
    if (s_need[b] > 0)
      warp_select(g_hist + 3 * maxb * kBins + b * kBins, 0, &s_prefix[b],
                  &s_krem[b], &s_ngt[b], &s_prior[b]);
  __syncthreads();
  {
    const int b = tid;  // maxb <= kThreads: one batch a thread
    const int kc = b < maxb ? s_need[b] : 0;
    int total;
    const int prior = block_excl_scan(kc > 0 ? s_prior[b] : 0, &total);
    if (b < maxb) {
      s_prior[b] = prior;
      s_need[b] = kc - s_ngt[b] > 0 ? kc - s_ngt[b] : 0;
      s_krem[b] = kc > 0;  // from here: k > 0
    }
  }
  __syncthreads();
  auto classify = [&](uint32_t u, uint32_t b, bool* gt, bool* tie) {
    const bool on = b != kInvalid && s_krem[b];
    *gt = on && u > s_prefix[b];
    *tie = on && u == s_prefix[b];
  };

  // the slice in 32 warp runs of seg candidates (seg a multiple of 128);
  // each warp counts its ties, the block publishes its total
  const int seg = (len + 32 * 128 - 1) / (32 * 128) * 128;
  const int w0 = warp * seg, w1 = w0 + seg < len ? w0 + seg : len;
  {
    int mine = 0;
    for (int c = w0 + kVec * lane; c < w1; c += 32 * kVec) {
      uint32_t u[kVec], b[kVec];
      items(c, u, b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        bool gt, tie;
        classify(u[j], b[j], &gt, &tie);
        mine += tie;
      }
    }
    mine = warp_sum(mine);
    if (lane == 0) s_warp[warp] = mine;
  }
  __syncthreads();
  if (warp == 0) {
    const int all = warp_sum(s_warp[lane]);
    if (lane == 0) g_blk[blockIdx.x] = all;
  }
  grid.sync();
  // every block has read the histograms: leave them zero for the next call
  for (int i = blockIdx.x * kThreads + tid; i < 4 * maxb * kBins;
       i += gridDim.x * kThreads)
    g_hist[i] = 0;

  // ties before each warp's run: earlier slices, then earlier warps
  {
    int before = 0;
    for (int j = tid; j < (int)blockIdx.x; j += kThreads)
      before += __ldcg(g_blk + j);
    int total;
    block_excl_scan(before, &total);
    if (warp == 0) {
      const int v = s_warp[lane];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      s_warp[lane] = total + x - v;
    }
  }
  __syncthreads();

  // the mask, in position order: a tie's rank is the ties before it less
  // the ties of the batches before its own
  int running = s_warp[warp];
  for (int c0 = w0; c0 < w1; c0 += 32 * kVec) {
    const int c = c0 + kVec * lane;
    uint32_t u[kVec], b[kVec];
    items(c, u, b);
    bool gt[kVec], tie[kVec];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      classify(u[j], b[j], &gt[j], &tie[j]);
      mine += tie[j];
    }
    int x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    int rank = running + x - mine;
    running += __shfl_sync(0xffffffffu, x, 31);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool keep =
          gt[j] || (tie[j] && rank - s_prior[b[j]] < s_need[b[j]]);
      word |= (uint32_t)keep << (8 * j);
      rank += tie[j];
    }
    const int64_t i = start + c;
    if (c < len) {
      if (i + kVec <= n) {
        *reinterpret_cast<uint32_t*>(out + i) = word;
      } else {
        for (int j = 0; i + j < n; ++j) out[i + j] = (word >> (8 * j)) & 1;
      }
    }
  }
}

}  // namespace

// Shared memory of one block: the window histograms, five per-batch
// arrays and, resident, 6 bytes per candidate of the slice.
static int64_t smem_bytes(int maxb, int64_t per_block, int resident) {
  return (int64_t)kWin * kBins * 4 + 4LL * batch_ints(maxb) +
         (resident ? 6 * per_block : 0);
}

static const void* kernel_of(int resident) {
  return resident ? (const void*)topk_kernel<true>
                  : (const void*)topk_kernel<false>;
}

// The dynamic shared memory one block of the resident (1) or streaming (0)
// kernel takes for maxb batches and slices of per_block candidates, and
// how many such blocks fit one SM (the wrapper checks its plan against
// both once per shape).
extern "C" int upcc_topk_fit(int resident, int64_t maxb, int64_t per_block,
                             int64_t* smem, int64_t* blocks) {
  if (maxb < 1 || maxb > 1024 || per_block % kChunk || per_block <= 0)
    return (int)cudaErrorInvalidValue;
  *smem = smem_bytes((int)maxb, per_block, resident);
  cudaError_t e = cudaFuncSetAttribute(
      kernel_of(resident), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e != cudaSuccess) return (int)e;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, kernel_of(resident), kThreads, (size_t)*smem);
  *blocks = nb;
  return (int)e;
}

// hist: int32 [4 * maxb * 256], zero (the kernel leaves it zero again, so
// a buffer kept per stream needs no memset); totals: int32 [grid], any
// values; grid blocks of per_block candidates (a multiple of 4096) each,
// all resident at once (cudaLaunchCooperativeKernel refuses a grid that
// is not)
extern "C" int upcc_topk_mask(const void* keys_, const void* logits_,
                              const void* k_, int64_t n, int64_t maxb_,
                              int resident, int64_t grid, int64_t per_block,
                              void* hist_, void* totals_, void* out_,
                              void* stream_) {
  if (n <= 0) return 0;
  if (maxb_ < 1 || maxb_ > 1024 || per_block % kChunk || per_block <= 0 ||
      grid < 1 || grid * per_block < n)
    return (int)cudaErrorInvalidValue;
  int maxb = (int)maxb_;
  cudaStream_t s = (cudaStream_t)stream_;
  const int64_t smem = smem_bytes(maxb, per_block, resident);
  const void* kern = kernel_of(resident);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t* keys = (const int64_t*)keys_;
  const float* logits = (const float*)logits_;
  const int32_t* k = (const int32_t*)k_;
  int32_t* hist = (int32_t*)hist_;
  int32_t* totals = (int32_t*)totals_;
  uint8_t* out = (uint8_t*)out_;
  void* args[] = {&keys,      &logits, &k,      &n,  &maxb,
                  &per_block, &hist,   &totals, &out};
  e = cudaLaunchCooperativeKernel(kern, dim3((unsigned)grid), dim3(kThreads),
                                  args, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
