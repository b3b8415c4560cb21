// K2: exact per-batch top-k mask for Hopper (sm_90a).
//
// Replaces upcc_tpu/ops/topk.py::topk_mask together with its one-hot
// matmul histogram _batch_histogram (topk.py:36-120).  For candidates with
// sorted int64 keys (batch = key >> 57, SENTINEL = invalid) and f32 logits,
// the mask keeps exactly k[b] candidates of every batch b: the k largest
// logits, ties at the threshold filled by position (first wins); invalid
// slots never win and k <= 0 keeps nothing.  The mask equals the reference
// bit for bit.
//
// Algorithm (as the reference): the logits' order-preserving 32-bit image
// u is radix-selected in 4 passes of 256-bin per-batch histograms, each
// pass fixing 8 more bits of every batch's threshold; then every candidate
// is classified (u > thr: keep; u == thr: tie) and a tie is kept when its
// rank among its batch's ties, by position, is below k - #(u > thr).
//
// What bounds it: bytes.  Each pass reads the keys and logits (12 bytes per
// candidate, ~2M candidates at the finest decode level) and the whole
// select makes 6 such reads plus 1 byte of mask out, ~0.15 GB: ~45 us at
// 3.35 TB/s.  Design against that: histograms accumulate in shared memory
// (integer atomics, exact in any order) over a window of the few batches a
// 4096-candidate tile spans — candidates are batch-major sorted on the
// codec's path — and only nonzero bins are flushed; the per-batch threshold
// search is one tiny kernel; the tie rank is a block scan plus one scan of
// per-tile totals (no device-wide library scan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4096 (topk.py's nblk)
constexpr int kWin = 4;  // batches a tile's shared histogram holds
constexpr int kBatchShift = 57;
constexpr int64_t kSentinel = INT64_MAX;

__device__ __forceinline__ int64_t ordered(float f) {
  const int32_t bits = __float_as_int(f);
  const int64_t b = (int64_t)bits & 0xFFFFFFFFLL;
  return bits < 0 ? ((~b) & 0xFFFFFFFFLL) : (b | 0x80000000LL);
}

__device__ __forceinline__ int batch_of(int64_t key, int maxb) {
  const int b = (int)(key >> kBatchShift);
  return b < 0 ? 0 : (b > maxb - 1 ? maxb - 1 : b);
}

// exclusive scan of one int per thread over the block; *total = block sum
template <int NT>
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[NT / 32];
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
    int s = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = w ? warp_sums[w - 1] : 0;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void init_kernel(const int32_t* k, int maxb, int64_t* prefix,
                            int64_t* krem) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < maxb) {
    prefix[b] = 0;
    krem[b] = k[b] > 0 ? k[b] : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int64_t* __restrict__ keys, const float* __restrict__ logits,
            int64_t n, int maxb, int shift, const int64_t* __restrict__ prefix,
            int32_t* __restrict__ hist) {
  __shared__ int32_t sh[kWin * 256];
  __shared__ int s_b0;
  for (int i = threadIdx.x; i < kWin * 256; i += kThreads) sh[i] = 0;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  if (threadIdx.x == 0)
    s_b0 = keys[base] != kSentinel ? batch_of(keys[base], maxb) : 0;
  __syncthreads();
  const int b0 = s_b0;
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    if (i >= n) break;
    const int64_t key = keys[i];
    if (key == kSentinel) continue;
    const int b = batch_of(key, maxb);
    const int64_t u = ordered(logits[i]);
    if ((u >> (shift + 8)) != (prefix[b] >> (shift + 8))) continue;
    const int bin = (int)((u >> shift) & 255);
    const int wb = b - b0;
    if (wb >= 0 && wb < kWin)
      atomicAdd(&sh[wb * 256 + bin], 1);
    else
      atomicAdd(&hist[b * 256 + bin], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWin * 256; i += kThreads) {
    const int c = sh[i];
    if (c) atomicAdd(&hist[(b0 + i / 256) * 256 + (i & 255)], c);
  }
}

// one thread per batch: the bin holding the krem-th largest active value
__global__ void select_kernel(const int32_t* __restrict__ hist, int maxb,
                              int shift, int64_t* prefix, int64_t* krem) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= maxb) return;
  const int64_t kr = krem[b];
  int64_t desc = 0;  // active count in bins above t
  for (int t = 255; t >= 0; --t) {
    const int64_t h = hist[b * 256 + t];
    if (desc < kr && desc + h >= kr) {
      prefix[b] |= (int64_t)t << shift;
      krem[b] = kr - desc > 0 ? kr - desc : 0;
      return;
    }
    desc += h;
  }
}

__device__ __forceinline__ void classify(const int64_t* keys,
                                         const float* logits, int64_t i,
                                         int64_t n, int maxb, const int32_t* k,
                                         const int64_t* prefix, int* b,
                                         int* gt, int* tie) {
  *gt = 0;
  *tie = 0;
  *b = 0;
  if (i >= n) return;
  const int64_t key = keys[i];
  if (key == kSentinel) return;
  *b = batch_of(key, maxb);
  const int64_t thr = k[*b] > 0 ? prefix[*b] : (1LL << 32);
  const int64_t u = ordered(logits[i]);
  *gt = u > thr;
  *tie = u == thr;
}

// per-batch counts of u > thr and of ties; per-tile tie totals
__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ keys, const float* __restrict__ logits,
             int64_t n, int maxb, const int32_t* __restrict__ k,
             const int64_t* __restrict__ prefix, int64_t* n_gt, int64_t* ties,
             int32_t* blk_ties) {
  __shared__ int32_t s_gt[kWin], s_tie[kWin];
  __shared__ int s_b0;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  if (threadIdx.x < kWin) s_gt[threadIdx.x] = s_tie[threadIdx.x] = 0;
  if (threadIdx.x == 0)
    s_b0 = keys[base] != kSentinel ? batch_of(keys[base], maxb) : 0;
  __syncthreads();
  const int b0 = s_b0;
  int my_ties = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    int b, gt, tie;
    classify(keys, logits, i, n, maxb, k, prefix, &b, &gt, &tie);
    if (!(gt | tie)) continue;
    my_ties += tie;
    const int wb = b - b0;
    if (wb >= 0 && wb < kWin) {
      if (gt) atomicAdd(&s_gt[wb], 1);
      if (tie) atomicAdd(&s_tie[wb], 1);
    } else {
      if (gt) atomicAdd((unsigned long long*)&n_gt[b], 1ULL);
      if (tie) atomicAdd((unsigned long long*)&ties[b], 1ULL);
    }
  }
  int total;
  block_excl_scan<kThreads>(my_ties, &total);
  if (threadIdx.x == 0) blk_ties[blockIdx.x] = total;
  if (threadIdx.x < kWin && b0 + (int)threadIdx.x < maxb) {
    if (s_gt[threadIdx.x])
      atomicAdd((unsigned long long*)&n_gt[b0 + threadIdx.x],
                (unsigned long long)s_gt[threadIdx.x]);
    if (s_tie[threadIdx.x])
      atomicAdd((unsigned long long*)&ties[b0 + threadIdx.x],
                (unsigned long long)s_tie[threadIdx.x]);
  }
}

// single block: exclusive scan of the per-tile tie totals; per-batch need
// = max(k - n_gt, 0) and prior = ties of all earlier batches
__global__ void __launch_bounds__(1024)
scan_kernel(int32_t* blk_ties, int nblk, int32_t* blk_off, const int32_t* k,
            int maxb, const int64_t* n_gt, const int64_t* ties, int64_t* need,
            int64_t* prior) {
  int running = 0;
  for (int base = 0; base < nblk; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < nblk ? blk_ties[i] : 0;
    int total;
    const int excl = block_excl_scan<1024>(v, &total);
    if (i < nblk) blk_off[i] = running + excl;
    running += total;
  }
  if (threadIdx.x == 0) {
    int64_t acc = 0;
    for (int b = 0; b < maxb; ++b) {
      prior[b] = acc;
      acc += ties[b];
      const int64_t kb = k[b] > 0 ? k[b] : 0;
      need[b] = kb - n_gt[b] > 0 ? kb - n_gt[b] : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const int64_t* __restrict__ keys, const float* __restrict__ logits,
            int64_t n, int maxb, const int32_t* __restrict__ k,
            const int64_t* __restrict__ prefix, const int64_t* __restrict__ need,
            const int64_t* __restrict__ prior,
            const int32_t* __restrict__ blk_off, uint8_t* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t running = blk_off[blockIdx.x];  // ties before this tile
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    int b, gt, tie;
    classify(keys, logits, i, n, maxb, k, prefix, &b, &gt, &tie);
    int total;
    const int excl = block_excl_scan<kThreads>(tie, &total);
    if (i < n) {
      const int64_t rank = running + excl - prior[b];
      out[i] = (uint8_t)(gt || (tie && rank < need[b]));
    }
    running += total;
  }
}

}  // namespace

// counts: int64 [4 * maxb] scratch (n_gt, ties, need, prior);
// blk: int32 [2 * ceil(n / 4096)] scratch (tile tie totals, offsets)
extern "C" int upcc_topk_mask(const void* keys_, const void* logits_,
                              const void* k_, int64_t n, int64_t maxb_,
                              void* hist_, void* prefix_, void* krem_,
                              void* counts_, void* blk_, void* out_,
                              void* stream_) {
  if (n <= 0) return 0;
  if (maxb_ < 1 || maxb_ > 1024) return (int)cudaErrorInvalidValue;
  const int maxb = (int)maxb_;
  cudaStream_t s = (cudaStream_t)stream_;
  const int64_t* keys = (const int64_t*)keys_;
  const float* logits = (const float*)logits_;
  const int32_t* k = (const int32_t*)k_;
  int32_t* hist = (int32_t*)hist_;
  int64_t* prefix = (int64_t*)prefix_;
  int64_t* krem = (int64_t*)krem_;
  int64_t* counts = (int64_t*)counts_;
  const int nblk = (int)((n + kTile - 1) / kTile);
  int32_t* blk_ties = (int32_t*)blk_;
  int32_t* blk_off = blk_ties + nblk;
  const int bgrid = (maxb + 255) / 256;

  init_kernel<<<bgrid, 256, 0, s>>>(k, maxb, prefix, krem);
  for (int j = 0; j < 4; ++j) {
    const int shift = 24 - 8 * j;
    cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int32_t) * 256 * maxb, s);
    if (e != cudaSuccess) return (int)e;
    hist_kernel<<<nblk, kThreads, 0, s>>>(keys, logits, n, maxb, shift, prefix,
                                         hist);
    select_kernel<<<bgrid, 256, 0, s>>>(hist, maxb, shift, prefix, krem);
  }
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int64_t) * 2 * maxb, s);
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<nblk, kThreads, 0, s>>>(keys, logits, n, maxb, k, prefix,
                                        counts, counts + maxb, blk_ties);
  scan_kernel<<<1, 1024, 0, s>>>(blk_ties, nblk, blk_off, k, maxb, counts,
                                 counts + maxb, counts + 2 * maxb,
                                 counts + 3 * maxb);
  mask_kernel<<<nblk, kThreads, 0, s>>>(keys, logits, n, maxb, k, prefix,
                                       counts + 2 * maxb, counts + 3 * maxb,
                                       blk_off, (uint8_t*)out_);
  return (int)cudaGetLastError();
}
