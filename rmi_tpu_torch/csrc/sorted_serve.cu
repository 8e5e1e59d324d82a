// K5: exact lower bounds searchsorted(keys, q, side="left") for a
// NON-DECREASING batch of int64 query images, by window counts:
//   lb1 = lo_b + #(stripe_first[lo_b : hi_b] < q)     (the block's window)
//   row = max(lb1 - 1, 0)
//   lb  = min(64 * row + #(keys[64 row : 64 row + 64] < q), n)
// with stripe_first = keys[::64] and [lo_b, hi_b] the window bounds of
// the query's block (block b holds queries [b * kq, (b + 1) * kq)).
// lb1 is exact when lo_b <= lb1 <= hi_b for every query of the block;
// rmi_tpu_torch/lookup_fast.py derives such bounds from the leaf rows
// of each block's first and last query.  Bounds are clamped to
// 0 <= lo_b <= hi_b <= nrows0, as the plain version clamps them.
//
// Replaces rmi_tpu/ops/sorted_serve_kernel.py:_serve_sorted_direct_kernel.
// That kernel DMAs a fixed-size window of [W0, 256] u32 level-0 rows per
// 2048-query block into VMEM, compares 16-bit chunks in f32 lanes and
// picks each query's stripe row with byte-plane one-hot matmuls; a host
// tier lattice chooses the window size and sparse batches fall back to
// gathers.  Here keys compare as int64, the window holds only the
// stripe-first keys, and the stripe itself is read where it lies.
//
// Bound on the H100: the stripe reads.  Per query, a binary search over
// the 64 keys of its stripe makes 6 dependent loads from device memory
// (about 5 distinct 32-byte sectors, 160 B); neighbouring threads hold
// neighbouring sorted queries, so their stripes are neighbours too.  The
// window search runs in shared memory: a block copies its window of
// stripe-first keys (at 200M keys and 2^22 uniform queries about 760
// keys, 6 KB, for 1024 queries) with coalesced loads, about 25 MB per
// batch.  A block whose window exceeds kWindowCap keys (a sparse batch)
// binary-searches stripe_first between its bounds in device memory
// instead: the same answer, so nothing is declined and no host round
// trip chooses a size.  No TMA and no warp specialisation yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kWindowCap = 4096;     // 32 KB of int64 stripe-first keys
constexpr int64_t kStripe = 64;

// First i in [0, len) with a[i] >= q, else len: the count of a[.] < q
// for sorted a.  `a` may point to shared or device memory.
__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t len,
                                               int64_t q) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
serve_sorted(const int64_t* __restrict__ q, int64_t nq,
             const int64_t* __restrict__ stripe_first, int64_t nrows0,
             const int64_t* __restrict__ keys, int64_t n,
             const int64_t* __restrict__ lo_b, const int64_t* __restrict__ hi_b,
             int64_t kq, int64_t* __restrict__ out) {
  __shared__ int64_t window[kWindowCap];
  const int64_t b = blockIdx.x;
  const int64_t lo = min(max(lo_b[b], (int64_t)0), nrows0);
  const int64_t hi = min(max(hi_b[b], lo), nrows0);
  const int64_t len = hi - lo;
  const bool in_shared = len <= kWindowCap;
  if (in_shared) {
    for (int64_t i = threadIdx.x; i < len; i += blockDim.x) {
      window[i] = stripe_first[lo + i];
    }
  }
  __syncthreads();
  const int64_t* win = in_shared ? window : stripe_first + lo;

  const int64_t q_end = min((b + 1) * kq, nq);
  for (int64_t i = b * kq + threadIdx.x; i < q_end; i += blockDim.x) {
    const int64_t qv = q[i];
    const int64_t lb1 = lo + lower_bound(win, len, qv);
    const int64_t row = lb1 > 0 ? lb1 - 1 : 0;
    const int64_t s0 = row * kStripe;
    const int64_t s_len = min(s0 + kStripe, n) - s0;
    out[i] = min(s0 + lower_bound(keys + s0, s_len, qv), n);
  }
}

}  // namespace

RMI_API int rmi_serve_sorted(const int64_t* q, int64_t nq,
                             const int64_t* stripe_first, int64_t nrows0,
                             const int64_t* keys, int64_t n,
                             const int64_t* lo_b, const int64_t* hi_b,
                             int64_t kq, int64_t* out, void* stream) {
  if (nq > 0) {
    const int64_t blocks = (nq + kq - 1) / kq;
    serve_sorted<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        q, nq, stripe_first, nrows0, keys, n, lo_b, hi_b, kq, out);
  }
  return (int)cudaGetLastError();
}
