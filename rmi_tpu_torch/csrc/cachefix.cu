// The cachefix serving path: the bounded lower bound and the spline's
// interpolation (ops/cachefix_kernel.py; bounded_lower_bound_plain and
// cachefix_interp_plain are the plain versions).
//
//   rmi_bounded_lower_bound  out[i] = the first j in [lo, hi) with
//                            keys[j] >= queries[i], where lo = clamp(guess -
//                            err, 0, n) and hi = clamp(guess + err + 1, 0, n),
//                            by at most `iters` halving steps (hi where the
//                            window holds no such key); with `exact`, an
//                            answer j that is not the lower bound (keys[j -
//                            1] >= q, or j < n and keys[j] < q) is replaced
//                            by the search of [0, n): a cachefix index's
//                            window covers its keys, not the queries
//                            between them;
//   rmi_cachefix_interp      the same search over the spline's knot images
//                            around the RMI's (start, err), then the knot
//                            pair, the lerp of their values, quantized to
//                            the cache line; total_keys - 1 past the last
//                            knot.
//
// Replace two XLA steps of rmi_tpu that have no Pallas call:
// _bounded_search_jit over bounded_lower_bound (rmi_tpu/lookup.py:67-95)
// and _cachefix_interp (rmi_tpu/lookup.py:97-140), which rmi_tpu jits
// beside K4 (rmi_tpu/ops/eval_kernel.py:_eval_kernel).
//
// Semantics kept from the plain versions, bit for bit:
//   - the fixed-trip halving search: a step where lo == hi changes
//     nothing, so a thread stops there; it never runs more than `iters`
//     steps, so a trip count too short for the window answers what the
//     plain version answers;
//   - int64 compares of the images and int64 index arithmetic; a key read
//     at clamp(mid, 0, n - 1);
//   - the knot pair r - 1, r with r = clamp(res, 1, num_pts - 1) as
//     torch.clamp takes it (max wins when num_pts = 1), index -1 read as
//     the last knot, as Python's indexing reads it;
//   - the DOUBLE-ROUNDED lerp (1 - t) v0 + t v1, t = (q - k1) / max(k2 -
//     k1, 1), in f64 with the u64 -> f64 conversion of keys.as_float: the
//     library is compiled with -fmad=false and this file calls no fma(),
//     so no multiply and add fuse (the reference's fused std::fma is not
//     what rmi_tpu computes; ROADMAP's Port conventions);
//   - eps = total_keys 2^-40 (the caller's double) toward the upper line,
//     floor, clamp at 0, times line_size.
//
// Bound on the H100: a query needs its key, guess and error read and its
// answer written (32 B) and the sectors that decide it: the window's
// halving steps are dependent random reads, the first ones far apart
// (a knot array of 200 MB, or 1.6 GB of keys, does not fit L2), the last
// ones in one or two sectors; the interpolation adds the sectors of the
// two knots and their two values.  The time is set by how many dependent
// reads are in flight, not by bytes: one thread a query, as many resident
// threads as the card holds, a grid-stride loop over the batch; each
// thread's key, guess and error are read once, coalesced.  A simple
// kernel that is right; the hier plan's resolve (csrc/hier.cu) shows what
// interpolated sector reads would save.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// the first j in [lo, hi) with keys[j] >= q, at most `iters` steps
__device__ __forceinline__ int64_t lower_bound_in(const int64_t* __restrict__ keys, int64_t n,
                                                  int64_t q, int64_t lo, int64_t hi,
                                                  int64_t iters) {
  for (int64_t it = 0; it < iters && lo < hi; ++it) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t at = mid < 0 ? 0 : (mid > n - 1 ? n - 1 : mid);
    if (__ldg(keys + at) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// whether j is the lower bound of q in keys[0 : n]
__device__ __forceinline__ bool is_lower_bound(const int64_t* __restrict__ keys, int64_t n,
                                               int64_t q, int64_t j) {
  return (j == 0 || __ldg(keys + j - 1) < q) && (j == n || __ldg(keys + j) >= q);
}

// halving steps that cover [0, n): the bits of n, and one more
__device__ __forceinline__ int64_t full_trips(int64_t n) {
  return n > 0 ? 65 - __clzll((long long)n) : 1;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
    bounded(const int64_t* __restrict__ keys, const int64_t* __restrict__ queries,
            const int64_t* __restrict__ guess, const int64_t* __restrict__ err,
            int64_t* __restrict__ out, int64_t m, int64_t n, int64_t iters, bool exact) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const int64_t g = guess[i], e = err[i], q = queries[i];
    int64_t j = lower_bound_in(keys, n, q, clamp64(g - e, 0, n), clamp64(g + e + 1, 0, n),
                               iters);
    if (exact && !is_lower_bound(keys, n, q, j)) {
      j = lower_bound_in(keys, n, q, 0, n, full_trips(n));
    }
    out[i] = j;
  }
}

__global__ void __launch_bounds__(kThreads)
    interp(const int64_t* __restrict__ knots, const int64_t* __restrict__ vals, int64_t num_pts,
           const int64_t* __restrict__ queries, const int64_t* __restrict__ start,
           const int64_t* __restrict__ err, int64_t* __restrict__ out, int64_t m,
           int64_t line_size, int64_t total_keys, double eps, int64_t iters) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const double line = (double)line_size;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const int64_t q = queries[i], s = start[i], e = err[i];
    const int64_t res = lower_bound_in(knots, num_pts, q, clamp64(s - e, 0, num_pts),
                                       clamp64(s + e + 1, 0, num_pts), iters);
    if (res >= num_pts) {
      out[i] = total_keys - 1;
      continue;
    }
    // torch.clamp(res, 1, num_pts - 1): the upper limit wins
    const int64_t lower = res < 1 ? 1 : res;
    const int64_t r = lower > num_pts - 1 ? num_pts - 1 : lower;
    const int64_t r0 = r - 1 < 0 ? r - 1 + num_pts : r - 1;
    const double k1 = decoded<RmiKey::kU64>(__ldg(knots + r0));
    const double k2 = decoded<RmiKey::kU64>(__ldg(knots + r));
    const double v0 = (double)__ldg(vals + r0);
    const double v1 = (double)__ldg(vals + r);
    double d = k2 - k1;
    d = d < 1.0 ? 1.0 : d;
    const double t = (decoded<RmiKey::kU64>(q) - k1) / d;
    const double a = (1.0 - t) * v0;
    const double b = t * v1;
    const double v = a + b;
    const int64_t cell = (int64_t)floor((v + eps) / line);
    out[i] = (cell < 0 ? 0 : cell) * line_size;
  }
}

}  // namespace

// out[i]: the first index j in [clamp(guess[i] - err[i], 0, n),
// clamp(guess[i] + err[i] + 1, 0, n)) with keys[j] >= queries[i], by at
// most `iters` halving steps over keys[0 : n] (n_keys entries in all);
// with `exact` nonzero, the lower bound of queries[i] in keys[0 : n]
// wherever that answer is not.  An n above n_keys or a negative count is
// refused with cudaErrorInvalidValue.
RMI_API int rmi_bounded_lower_bound(const int64_t* keys, int64_t n_keys, const int64_t* queries,
                                    const int64_t* guess, const int64_t* err, int64_t* out,
                                    int64_t m, int64_t n, int64_t iters, int64_t exact,
                                    void* stream) {
  if (m < 0 || n < 0 || n > n_keys || iters < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  bounded<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      keys, queries, guess, err, out, m, n, iters, exact != 0);
  return (int)cudaGetLastError();
}

// out[i]: the cachefix position of queries[i] from the RMI's (start[i],
// err[i]) over the num_pts knot images `knots` with values `vals`
// (rmi_tpu's _cachefix_interp); eps = max(total_keys, 1) 2^-40 from the
// caller.  num_pts < 1, line_size < 1 or a negative count is refused with
// cudaErrorInvalidValue.
RMI_API int rmi_cachefix_interp(const int64_t* knots, const int64_t* vals, int64_t num_pts,
                                const int64_t* queries, const int64_t* start,
                                const int64_t* err, int64_t* out, int64_t m,
                                int64_t line_size, int64_t total_keys, double eps,
                                int64_t iters, void* stream) {
  if (m < 0 || num_pts < 1 || line_size < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  interp<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      knots, vals, num_pts, queries, start, err, out, m, line_size, total_keys, eps, iters);
  return (int)cudaGetLastError();
}
