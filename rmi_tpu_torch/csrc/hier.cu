// The hierarchical plan's resolve: exact lower bounds from lookup's
// (guess, err) through the plan's levels (lookup_fast's "hier" plan;
// ops/hier_kernel.resolve_plain is the plain version).
//
//   rmi_hier_resolve   out[i] = #(keys < queries[i]), with level K's lower
//                      limit LB = ceil(clamp(guess - err, 0, n) / 64^K),
//                      then for each level k = K..0 the count of its
//                      entries below q over the 128 that start at
//                      64 clamp(LB >> 6, 0, nrows - 1) (nrows =
//                      ceil(len / 64); entries past the level's end count
//                      as not below q), capped at the level's length, and
//                      the next level's limit max(64 lb - 63, 0).
//
// Replaces rmi_tpu/lookup_fast.py:resolve (:396-413) and _count_row
// (:388-393), which rmi_tpu's _fast_search_df64 (:524-551) runs in the
// same XLA program as K4 (rmi_tpu/ops/eval_kernel.py:_eval_kernel); no
// Pallas kernel stands behind it.  Level 0 is the key array, read where
// it lies; levels 1..K (keys[::64^k]) lie in one int64 tensor, `upper`,
// level k from index[2 (k - 1)] with index[2 (k - 1) + 1] entries
// (ops/hier_kernel.pack_levels), n / 63 entries in all.
//
// Bound on the H100: what a query needs is its key, guess and error
// read and its answer written (32 B) and, at level 0, the sectors that
// hold keys[lb - 1] and keys[lb]; the upper levels (25 MB at 200M keys)
// stay in L2.  Each level's count is over a sorted 128-entry row, so it
// equals the row's lower bound, which a thread finds by halving steps in
// 8 reads of one key each: at level 0 a query reads ~5 sectors where a
// count of the whole row reads 32 (1 KB, 4.4 GB for 2^22 queries).  A
// thread takes one query through every level in order (each limit is the
// count above it), so the kernel is bound by the latency of 8 (K + 1)
// dependent reads a query, which the threads in flight, 2048 an SM, hide.
// All arithmetic is int64, as the plain version's.  The first design, a
// warp a query counting the row in coalesced 32-byte lane loads (PERF.md
// §6), moved the whole rows and took 2.30 ms on path 8's 2^22 queries.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFan = 64;          // lookup_fast.LEVEL_FAN
constexpr int64_t kWidth = 128;       // entries of one level's count
constexpr int kMaxK = 10;             // 64^K fits in int64

// 64 r + #(level[64 r : 64 r + 128] < q), r = row clipped to the level's
// rows, capped at its length (the plain version's _count_row and clamp);
// entries past the level's end count as not below q.  The level is
// sorted, so the count is the row's lower bound: the largest c with
// level[start + c - 1] < q, by halving steps from 128.
__device__ __forceinline__ int64_t count_row(const int64_t* __restrict__ level, int64_t len,
                                             int64_t row, int64_t q) {
  const int64_t nrows = len > 0 ? (len + kFan - 1) / kFan : 1;
  row = row < 0 ? 0 : (row > nrows - 1 ? nrows - 1 : row);
  const int64_t start = row * kFan;
  const int64_t w = len - start < kWidth ? len - start : kWidth;   // entries in the level
  int64_t c = 0;
#pragma unroll
  for (int64_t step = kWidth; step > 0; step >>= 1) {
    if (c + step <= w && __ldg(level + start + c + step - 1) < q) c += step;
  }
  const int64_t lb = start + c;
  return lb < len ? lb : len;
}

__global__ void __launch_bounds__(kThreads)
resolve(const int64_t* __restrict__ queries, const int64_t* __restrict__ guess,
        const int64_t* __restrict__ err, const int64_t* __restrict__ keys, int64_t n0,
        const int64_t* __restrict__ upper, const int64_t* __restrict__ index, int K,
        int64_t sK, int64_t* __restrict__ out, int64_t m, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m; i += stride) {
    const int64_t q = __ldg(queries + i);
    // guess - err wraps as torch's int64 does
    int64_t lo = (int64_t)((uint64_t)__ldg(guess + i) - (uint64_t)__ldg(err + i));
    lo = lo < 0 ? 0 : (lo > n ? n : lo);
    int64_t LB = (lo + sK - 1) / sK;
    int64_t lb = 0;
    for (int k = K; k >= 0; --k) {
      if (k < K) {
        LB = lb * kFan - (kFan - 1);
        LB = LB < 0 ? 0 : LB;
      }
      const int64_t* level = k == 0 ? keys : upper + __ldg(index + 2 * (k - 1));
      const int64_t len = k == 0 ? n0 : __ldg(index + 2 * (k - 1) + 1);
      lb = count_row(level, len, LB >> 6, q);
    }
    out[i] = lb;
  }
}

}  // namespace

// out[i]: the lower bound of queries[i] in keys[0 : n0] from guess[i] and
// err[i] through levels 0..K (the keys, then upper as index says); n the
// plan's key count, which clamps guess - err.  A K outside [0, 10] or a
// missing level is refused with cudaErrorInvalidValue.
RMI_API int rmi_hier_resolve(const int64_t* queries, const int64_t* guess, const int64_t* err,
                             const int64_t* keys, int64_t n0, const int64_t* upper,
                             const int64_t* index, int64_t K, int64_t* out, int64_t m,
                             int64_t n, void* stream) {
  if (K < 0 || K > kMaxK || n0 < 1 || n < 0 || m < 0 ||
      (K > 0 && (upper == nullptr || index == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int64_t sK = 1;
  for (int64_t k = 0; k < K; ++k) sK *= kFan;
  if (m > 0) {
    resolve<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        queries, guess, err, keys, n0, upper, index, (int)K, sK, out, m, n);
  }
  return (int)cudaGetLastError();
}
