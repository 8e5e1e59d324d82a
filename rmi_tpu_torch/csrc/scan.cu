// K1: inclusive running max or min of an int32 vector, forward or
// reverse; positions past the end read as the op's identity `fill`.
//
// Replaces rmi_tpu/ops/scan_kernel.py:_scan_kernel (scan_i32), which
// streams [256, 128] blocks through a TPU core in grid order and carries
// the running value in SMEM from one grid step to the next.
//
// Bound on the H100: memory.  The op is one compare per element, so the
// floor is one read and one write of 4 bytes per key (8 B/key; 1.6 GB at
// n = 200M, about 0.5 ms at 3.35 TB/s).  Blocks run in no order here, so
// nothing can carry across them; the simple design is reduce-then-scan
// in three launches: (1) each 4096-element tile reduces to one value,
// (2) one block scans the tile totals into exclusive carries, (3) each
// tile rescans itself from shared memory and applies its carry.  That
// reads the input twice and writes once (12 B/key).  A single pass with
// decoupled look-back would save one read; max and min never round, so
// either form is bit-equal to torch.cummax / torch.cummin.
//
// Reverse scans walk logical positions l = 0..n-1 at physical index
// n-1-l: neighbouring threads still touch neighbouring addresses.
// Indices are 64-bit throughout.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096 elements per block
constexpr int kWarps = kThreads / 32;

// shared-memory skew: one pad word per 32 so that a thread's kItems
// consecutive elements do not all fall in the same banks
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

template <bool IS_MAX>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return IS_MAX ? max(a, b) : min(a, b);
}

__device__ __forceinline__ int64_t phys(int64_t l, int64_t n, bool reverse) {
  return reverse ? n - 1 - l : l;
}

// Inclusive scan across a warp.
template <bool IS_MAX>
__device__ __forceinline__ int32_t warp_scan(int32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(RMI_FULL_MASK, v, off);
    if (lane >= off) v = op<IS_MAX>(v, o);
  }
  return v;
}

// (1) one total per tile
template <bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const int32_t* __restrict__ v, int64_t n, int32_t fill,
            bool reverse, int32_t* __restrict__ agg) {
  __shared__ int32_t warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int32_t acc = fill;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    if (l < n) acc = op<IS_MAX>(acc, v[phys(l, n, reverse)]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = op<IS_MAX>(acc, __shfl_down_sync(RMI_FULL_MASK, acc, off));
  if (lane == 0) warp_tot[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t = warp_tot[0];
    for (int w = 1; w < kWarps; ++w) t = op<IS_MAX>(t, warp_tot[w]);
    agg[blockIdx.x] = t;
  }
}

// (2) exclusive scan of the nb tile totals, in place, by one block
template <bool IS_MAX>
__global__ void __launch_bounds__(1024)
tile_carry(int32_t* __restrict__ agg, int64_t nb, int32_t fill) {
  __shared__ int32_t warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t running = fill;
  for (int64_t base = 0; base < nb; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int32_t x = i < nb ? agg[i] : fill;
    const int32_t inc = warp_scan<IS_MAX>(x, lane);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int32_t wt = warp_scan<IS_MAX>(lane < nw ? warp_tot[lane] : fill, lane);
      warp_tot[lane] = wt;
    }
    __syncthreads();
    int32_t before = __shfl_up_sync(RMI_FULL_MASK, inc, 1);
    if (lane == 0) before = fill;
    if (warp > 0) before = op<IS_MAX>(before, warp_tot[warp - 1]);
    const int32_t chunk_total = warp_tot[nw - 1];
    if (i < nb) agg[i] = op<IS_MAX>(running, before);
    running = op<IS_MAX>(running, chunk_total);
    __syncthreads();   // warp_tot is rewritten by the next chunk
  }
}

// (3) rescan each tile from shared memory and apply its carry
template <bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
tile_apply(const int32_t* __restrict__ v, int32_t* __restrict__ out,
           int64_t n, int32_t fill, bool reverse,
           const int32_t* __restrict__ carry) {
  __shared__ int32_t tile[kTile + kTile / 32];
  __shared__ int32_t warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    tile[skew(k)] = l < n ? v[phys(l, n, reverse)] : fill;
  }
  __syncthreads();

  // serial inclusive scan of this thread's kItems consecutive elements
  const int first = threadIdx.x * kItems;
  int32_t items[kItems];
  int32_t acc = fill;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc = op<IS_MAX>(acc, tile[skew(first + k)]);
    items[k] = acc;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t inc = warp_scan<IS_MAX>(acc, lane);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      warp_tot[w] = op<IS_MAX>(warp_tot[w - 1], warp_tot[w]);
  }
  __syncthreads();
  int32_t before = __shfl_up_sync(RMI_FULL_MASK, inc, 1);
  if (lane == 0) before = fill;
  if (warp > 0) before = op<IS_MAX>(before, warp_tot[warp - 1]);
  before = op<IS_MAX>(before, carry[blockIdx.x]);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    tile[skew(first + k)] = op<IS_MAX>(items[k], before);
  __syncthreads();

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    if (l < n) out[phys(l, n, reverse)] = tile[skew(k)];
  }
}

template <bool IS_MAX>
void launch(const int32_t* v, int32_t* out, int64_t n, int32_t fill,
            bool reverse, int32_t* scratch, cudaStream_t s) {
  const int64_t nb = (n + kTile - 1) / kTile;
  tile_reduce<IS_MAX><<<(unsigned int)nb, kThreads, 0, s>>>(v, n, fill, reverse, scratch);
  tile_carry<IS_MAX><<<1, 1024, 0, s>>>(scratch, nb, fill);
  tile_apply<IS_MAX><<<(unsigned int)nb, kThreads, 0, s>>>(v, out, n, fill, reverse, scratch);
}

}  // namespace

// scratch: ceil(n / 4096) int32 tile carries (rmi_scan_tiles)
RMI_API int rmi_scan_i32(const int32_t* v, int32_t* out, int64_t n,
                         int32_t is_max, int32_t fill, int32_t reverse,
                         int32_t* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (is_max)
      launch<true>(v, out, n, fill, reverse != 0, scratch, s);
    else
      launch<false>(v, out, n, fill, reverse != 0, scratch, s);
  }
  return (int)cudaGetLastError();
}
