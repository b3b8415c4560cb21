// K3: stable compaction for Hopper (sm_90a), one single-pass launch a call.
//
// Replaces upcc_tpu/ops/sparse.py::compact with its scan
// upcc_tpu/ops/scan.py::cumsum_i32 (sparse.py:81-110): the kept rows of a
// sorted int64 key array and of every payload array move to the front in
// order, truncated at out_capacity m; the tail holds SENTINEL keys and zero
// rows.  The prune of every decoder level runs through it.  The output
// equals the plain version (ops/sparse.py::compact_plain) bit for bit.
//
// What bounds it: bytes.  Reading keep (1 byte a row) once, the kept rows
// once and writing m rows of keys and of every payload once: the decoder's
// three calls a frame move 131, 477 and 134 MB, 0.22 ms at 3.35 TB/s.
//
// Design: one launch does the scan and moves everything.  Each block owns
// a tile of keep (256 threads x 4/8/16 consecutive bytes, read once into
// registers), counts it, publishes the count and finds its exclusive
// prefix by decoupled look-back (Merrill and Garland 2016): warp 0 reads
// the status words of the 32 tiles before it at a time and sums their
// counts back to the first that carries an inclusive prefix.  The tile's
// kept rows go to a list in shared memory, in order, and the whole block
// then moves the keys and every payload row by row: a group of 1-32 lanes
// (a power of two) takes a row, each lane 16, 4 or 1 bytes at a time
// as the row bytes and both pointers allow (the wrapper's planner picks
// them, ops/sparse.py::compact_plan).  Rows and vectors come from the loop
// structure: no division per element.  Kept rows arrive in ascending
// source order, so the reads coalesce; they use ld.global.nc.
//
// The status words live in a buffer the wrapper keeps per (device,
// stream): one 64-bit word per tile, [epoch:32 | prefix flag:1 | count:31].
// A word counts only when its epoch is the call's, so no memset is needed
// between calls (the wrapper hands out a new epoch per launch and zeroes
// the buffer when the epoch wraps).  Each word carries its own value, so
// relaxed 64-bit loads and stores suffice.  Extra blocks after the tiles
// wait for the last tile's inclusive prefix (the total) and then write
// the tail rows [total, m) once, SENTINEL keys and zero rows.  A block
// waits only for blocks before it, which the hardware dispatches first
// (as CUB's single-pass scans assume).  Atomics are not used; the output
// bits depend on no order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPayloads = 8;
constexpr int64_t kSentinel = INT64_MAX;
constexpr uint64_t kPrefixFlag = 1ull << 31;
constexpr uint64_t kCountMask = kPrefixFlag - 1;

struct Payload {
  const void* in;
  void* out;
  int64_t units;   // units of `unit` bytes a row
  int unit_log2;   // 0, 2 or 4: 1, 4 or 16 bytes a lane moves at once
  int lanes_log2;  // 0..5: lanes that move one row together
};

struct Args {
  const uint8_t* keep;
  const int64_t* keys;
  int64_t* out_keys;    // null: this launch moves payloads only
  uint64_t* status;
  int64_t n, m;
  int tiles;            // blocks [0, tiles) scan; the rest write the tail
  uint32_t epoch;
  int np;
  Payload p[kMaxPayloads];
};

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// rows [0, lim) of the tile's list: out row row0 + j <- in row src[j]; a
// group of 2^shift lanes a row, 4 rows a group in flight
template <typename U>
__device__ __forceinline__ void move_rows(const U* __restrict__ in,
                                          U* __restrict__ out, int64_t w_row,
                                          int shift, const int32_t* src,
                                          int lim, int64_t row0) {
  const int g = 1 << shift;
  const int sub = threadIdx.x & (g - 1);
  const int ngrp = kThreads >> shift;
  for (int64_t w = sub; w < w_row; w += g) {
    for (int j0 = threadIdx.x >> shift; j0 < lim; j0 += 4 * ngrp) {
      U v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * ngrp;
        if (j < lim) v[u] = __ldg(in + (int64_t)src[j] * w_row + w);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * ngrp;
        if (j < lim) out[(row0 + j) * w_row + w] = v[u];
      }
    }
  }
}

// out rows [lo, m) <- zero, spread over `parts` blocks numbered `part`
template <typename U>
__device__ __forceinline__ void zero_rows(U* __restrict__ out, int64_t w_row,
                                          int shift, int64_t lo, int64_t m,
                                          int part, int parts) {
  const int g = 1 << shift;
  const int sub = threadIdx.x & (g - 1);
  const int64_t stride = (int64_t)parts * (kThreads >> shift);
  for (int64_t w = sub; w < w_row; w += g)
    for (int64_t j = lo + (int64_t)part * (kThreads >> shift) +
                     (threadIdx.x >> shift);
         j < m; j += stride)
      out[j * w_row + w] = U();
}

__device__ __forceinline__ void move_payload(const Payload& p,
                                             const int32_t* src, int lim,
                                             int64_t row0) {
  switch (p.unit_log2) {
    case 4:
      move_rows((const uint4*)p.in, (uint4*)p.out, p.units, p.lanes_log2, src,
                lim, row0);
      break;
    case 2:
      move_rows((const uint32_t*)p.in, (uint32_t*)p.out, p.units,
                p.lanes_log2, src, lim, row0);
      break;
    default:
      move_rows((const uint8_t*)p.in, (uint8_t*)p.out, p.units, p.lanes_log2,
                src, lim, row0);
  }
}

__device__ __forceinline__ void zero_payload(const Payload& p, int64_t lo,
                                             int64_t m, int part, int parts) {
  switch (p.unit_log2) {
    case 4:
      zero_rows((uint4*)p.out, p.units, p.lanes_log2, lo, m, part, parts);
      break;
    case 2:
      zero_rows((uint32_t*)p.out, p.units, p.lanes_log2, lo, m, part, parts);
      break;
    default:
      zero_rows((uint8_t*)p.out, p.units, p.lanes_log2, lo, m, part, parts);
  }
}

// V keep bytes a thread, a tile of 256 V rows
template <int V>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const __grid_constant__ Args a) {
  extern __shared__ int32_t s_src[];  // [256 V] the tile's kept rows
  __shared__ int32_t s_warp[kWarps];
  __shared__ int64_t s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if ((int)blockIdx.x >= a.tiles) {
    // tail block: wait for the last tile's inclusive prefix (the total)
    if (tid == 0) {
      int64_t total = 0;
      if (a.tiles > 0) {
        const uint64_t* last = a.status + a.tiles - 1;
        uint64_t w;
        do {
          w = load_status(last);
        } while ((uint32_t)(w >> 32) != a.epoch || !(w & kPrefixFlag));
        total = (int64_t)(w & kCountMask);
      }
      s_prefix = total < a.m ? total : a.m;
    }
    __syncthreads();
    const int64_t lo = s_prefix;
    const int part = (int)blockIdx.x - a.tiles;
    const int parts = (int)gridDim.x - a.tiles;
    if (a.out_keys != nullptr)
      for (int64_t j = lo + (int64_t)part * kThreads + tid; j < a.m;
           j += (int64_t)parts * kThreads)
        a.out_keys[j] = kSentinel;
    for (int q = 0; q < a.np; ++q) zero_payload(a.p[q], lo, a.m, part, parts);
    return;
  }

  // the tile's keep bytes, V a thread, into a mask of kept rows
  const int tile = blockIdx.x;
  const int64_t base = (int64_t)tile * (kThreads * V) + (int64_t)tid * V;
  uint32_t mask = 0;
  if (base + V <= a.n && ((uintptr_t)a.keep & 15) == 0) {
    uint32_t w[V / 4];
    if constexpr (V == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(a.keep + base);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else if constexpr (V == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(a.keep + base);
      w[0] = x.x, w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(a.keep + base);
    }
#pragma unroll
    for (int r = 0; r < V; ++r)
      mask |= (uint32_t)(((w[r / 4] >> (8 * (r % 4))) & 0xFFu) != 0) << r;
  } else {
    for (int r = 0; r < V; ++r)
      if (base + r < a.n && a.keep[base + r]) mask |= 1u << r;
  }
  const int c = __popc(mask);

  // exclusive scan of the counts over the block
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int s = s_warp[i];
    before += i < warp ? s : 0;
    count += s;
  }
  const uint64_t tag = (uint64_t)a.epoch << 32;
  uint64_t* my_status = a.status + tile;
  if (tid == 0)  // the count at once, so later tiles need not wait
    store_status(my_status, tag | (tile == 0 ? kPrefixFlag : 0) |
                                (uint64_t)count);

  // the tile's kept rows, in order
  int at = before + x - c;
  for (uint32_t k = mask; k; k &= k - 1)
    s_src[at++] = (int32_t)(base + __ffs(k) - 1);

  // decoupled look-back: the counts of the tiles before, back to the
  // first that carries an inclusive prefix
  if (warp == 0) {
    int64_t excl = 0;
    for (int pred = tile - 1; pred >= 0; pred -= 32) {
      const int i = pred - lane;
      uint64_t w = kPrefixFlag;  // before tile 0: an inclusive prefix of 0
      bool ready = i < 0;
      while (!__all_sync(0xffffffffu, ready)) {
        if (!ready) {
          w = load_status(a.status + i);
          ready = (uint32_t)(w >> 32) == a.epoch;
        }
      }
      const unsigned pm = __ballot_sync(0xffffffffu, (w & kPrefixFlag) != 0);
      const int upto = pm ? __ffs(pm) - 1 : 31;
      int v = lane <= upto ? (int)(w & kCountMask) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      excl += v;
      if (pm) break;
    }
    if (lane == 0) {
      if (tile > 0)
        store_status(my_status, tag | kPrefixFlag | (uint64_t)(excl + count));
      s_prefix = excl;
    }
  }
  __syncthreads();

  // move the rows whose destinations fall below m
  const int64_t row0 = s_prefix;
  const int64_t room = a.m - row0;
  const int lim = room <= 0 ? 0 : (room < count ? (int)room : count);
  const long long* keys = reinterpret_cast<const long long*>(a.keys);
  if (a.out_keys != nullptr)
    for (int j0 = tid; j0 < lim; j0 += 4 * kThreads) {
      long long v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kThreads;
        if (j < lim) v[u] = __ldg(keys + s_src[j]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kThreads;
        if (j < lim) a.out_keys[row0 + j] = v[u];
      }
    }
  for (int q = 0; q < a.np; ++q) move_payload(a.p[q], s_src, lim, row0);
}

const void* kernel_of(int64_t tile) {
  switch (tile) {
    case kThreads * 16:
      return (const void*)compact_kernel<16>;
    case kThreads * 8:
      return (const void*)compact_kernel<8>;
    case kThreads * 4:
      return (const void*)compact_kernel<4>;
    default:
      return nullptr;
  }
}

}  // namespace

// The dynamic shared memory of one block of the kernel for tiles of `tile`
// rows (256 x 4, 8 or 16) and how many such blocks fit one SM (the wrapper
// holds its plan to both once per tile size).
extern "C" int upcc_compact_fit(int64_t tile, int64_t* smem, int64_t* blocks) {
  const void* kern = kernel_of(tile);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  *smem = 4 * tile;
  int nb = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, kern, kThreads, (size_t)*smem);
  *blocks = nb;
  return (int)e;
}

// keep uint8 [n]; keys int64 [n] and out_keys int64 [m] (out_keys null: a
// launch of payloads only); status: int64 [>= tiles] words whose epochs
// differ from `epoch`; desc: np x 5 int64 (in, out, row bytes, unit bytes,
// lanes), at most 8 payloads; tiles blocks of `tile` rows then `tail`
// blocks for the rows past the total
extern "C" int upcc_compact(const void* keep, const void* keys,
                            void* out_keys, int64_t n, int64_t m,
                            int64_t tile, int64_t tail, void* status,
                            int64_t epoch, int64_t np, const int64_t* desc,
                            void* stream) {
  const void* kern = kernel_of(tile);
  const int64_t tiles = (n + tile - 1) / tile;
  if (kern == nullptr || n < 0 || m < 0 || n >= (1ll << 31) ||
      m >= (1ll << 31) || np < 0 || np > kMaxPayloads || tail < 1 ||
      epoch <= 0 || epoch > (int64_t)UINT32_MAX ||
      (out_keys != nullptr && keys == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Args a;
  a.keep = (const uint8_t*)keep;
  a.keys = (const int64_t*)keys;
  a.out_keys = (int64_t*)out_keys;
  a.status = (uint64_t*)status;
  a.n = n;
  a.m = m;
  a.tiles = (int)tiles;
  a.epoch = (uint32_t)epoch;
  a.np = (int)np;
  for (int q = 0; q < np; ++q) {
    const int64_t* d = desc + 5 * q;
    const int64_t row = d[2], unit = d[3], lanes = d[4];
    const uint64_t ptrs = (uint64_t)d[0] | (uint64_t)d[1];
    if (row <= 0 || (unit != 1 && unit != 4 && unit != 16) || row % unit ||
        ptrs % unit || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
      return (int)cudaErrorInvalidValue;
    a.p[q] = Payload{(const void*)d[0], (void*)d[1], row / unit,
                     __builtin_ctzll(unit), __builtin_ctzll(lanes)};
  }
  const size_t smem = 4 * (size_t)tile;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3((unsigned)(tiles + tail)),
                                   dim3(kThreads), args, smem,
                                   (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
