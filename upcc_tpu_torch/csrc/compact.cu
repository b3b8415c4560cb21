// K3: stable compaction for Hopper (sm_90a).
//
// Replaces upcc_tpu/ops/sparse.py::compact with its scan
// upcc_tpu/ops/scan.py::cumsum_i32 (sparse.py:81-110): the kept rows of a
// sorted int64 key array and of every payload array move to the front in
// order, truncated at out_capacity m; the tail holds SENTINEL keys and zero
// rows.  The prune of every decoder level runs through it.
//
// Formulation (as the reference): a source-index map src[m] is built from
// an exclusive scan of keep — src[j] is the input row of the j-th kept row,
// or n past the last one — and keys and payloads then move by row gathers
// through src, so every payload is read only where it is kept.
//
// What bounds it: bytes.  Reading keep (1 byte a row) twice, the kept rows
// once and writing m rows of every array once; at the finest decode level
// (~2M candidates, bf16 [.., 32] payload, m ~ 1M) ~0.2 GB, ~60 us at
// 3.35 TB/s.  Design against that: the scan is a per-tile count, one
// single-block scan of the ~500 tile totals and a per-tile block scan that
// scatters 4-byte indices (no device-wide library scan); payload rows move
// in 16-byte vectors when rows and pointers allow.  No atomics: the output
// is the same bits every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4096 (sparse.py's nblk)
constexpr int64_t kSentinel = INT64_MAX;

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

__global__ void fill_kernel(int32_t* src, int64_t m, int32_t n) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += (int64_t)gridDim.x * blockDim.x)
    src[j] = n;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ keep, int64_t n, int32_t* blk) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int c = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    if (i < n) c += keep[i] != 0;
  }
  int total;
  block_excl_scan<kThreads>(c, &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = total;
}

// single block: in-place exclusive scan of the per-tile counts
__global__ void __launch_bounds__(1024) scan_kernel(int32_t* blk, int nblk) {
  int running = 0;
  for (int base = 0; base < nblk; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < nblk ? blk[i] : 0;
    int total;
    const int excl = block_excl_scan<1024>(v, &total);
    if (i < nblk) blk[i] = running + excl;
    running += total;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ keep, int64_t n, int64_t m,
               const int32_t* __restrict__ blk_off, int32_t* __restrict__ src) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t running = blk_off[blockIdx.x];
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    const int v = i < n && keep[i] != 0;
    int total;
    const int excl = block_excl_scan<kThreads>(v, &total);
    if (v) {
      const int64_t d = running + excl;
      if (d < m) src[d] = (int32_t)i;
    }
    running += total;
  }
}

__global__ void keys_kernel(const int64_t* __restrict__ keys,
                            const int32_t* __restrict__ src, int32_t n,
                            int64_t m, int64_t* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int32_t s = src[j];
    out[j] = s < n ? keys[s] : kSentinel;
  }
}

// out[j, :] = in[src[j], :] (zeros past the kept rows), in units of T
template <typename T>
__global__ void rows_kernel(const T* __restrict__ in,
                            const int32_t* __restrict__ src, int32_t n,
                            int64_t m, int64_t words, T* __restrict__ out) {
  const int64_t total = m * words;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = e / words;
    const int32_t s = src[j];
    T v;
    if (s < n) {
      v = in[(int64_t)s * words + (e - j * words)];
    } else {
      v = T();
    }
    out[e] = v;
  }
}

inline unsigned grid_for(int64_t work) {
  int64_t g = (work + 255) / 256;
  if (g > (1 << 20)) g = 1 << 20;
  return (unsigned)(g > 0 ? g : 1);
}

}  // namespace

// keep uint8 [n]; src int32 [m] out; blk int32 [ceil(n / 4096)] scratch
extern "C" int upcc_compact_index(const void* keep, int64_t n, int64_t m,
                                  void* src, void* blk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m > 0)
    fill_kernel<<<grid_for(m), 256, 0, s>>>((int32_t*)src, m, (int32_t)n);
  if (n > 0) {
    const int nblk = (int)((n + kTile - 1) / kTile);
    count_kernel<<<nblk, kThreads, 0, s>>>((const uint8_t*)keep, n,
                                          (int32_t*)blk);
    scan_kernel<<<1, 1024, 0, s>>>((int32_t*)blk, nblk);
    scatter_kernel<<<nblk, kThreads, 0, s>>>((const uint8_t*)keep, n, m,
                                            (const int32_t*)blk, (int32_t*)src);
  }
  return (int)cudaGetLastError();
}

extern "C" int upcc_compact_keys(const void* keys, const void* src, int64_t n,
                                 int64_t m, void* out, void* stream) {
  if (m > 0)
    keys_kernel<<<grid_for(m), 256, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int32_t*)src, (int32_t)n, m,
        (int64_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int upcc_compact_rows(const void* in, const void* src, int64_t n,
                                 int64_t m, int64_t row_bytes, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  const uintptr_t align = (uintptr_t)in | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    const int64_t words = row_bytes / 16;
    rows_kernel<uint4><<<grid_for(m * words), 256, 0, s>>>(
        (const uint4*)in, (const int32_t*)src, (int32_t)n, m, words,
        (uint4*)out);
  } else if (row_bytes % 4 == 0 && align % 4 == 0) {
    const int64_t words = row_bytes / 4;
    rows_kernel<uint32_t><<<grid_for(m * words), 256, 0, s>>>(
        (const uint32_t*)in, (const int32_t*)src, (int32_t)n, m, words,
        (uint32_t*)out);
  } else {
    rows_kernel<uint8_t><<<grid_for(m * row_bytes), 256, 0, s>>>(
        (const uint8_t*)in, (const int32_t*)src, (int32_t)n, m, row_bytes,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
