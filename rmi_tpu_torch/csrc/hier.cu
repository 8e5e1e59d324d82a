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
//                      the next level's limit max(64 lb - 63, 0); a
//                      query at or below keys[0] is answered 0 and one
//                      above keys[n0 - 1] n0 without the levels.
//
// Replaces rmi_tpu/lookup_fast.py:resolve (:396-413) and _count_row
// (:388-393), which rmi_tpu's _fast_search_df64 (:524-551) runs in the
// same XLA program as K4 (rmi_tpu/ops/eval_kernel.py:_eval_kernel); no
// Pallas kernel stands behind it.  Level 0 is the key array, read where
// it lies; levels 1..K (keys[::64^k]) lie in one int64 tensor, `upper`,
// level k from index[2 (k - 1)] with index[2 (k - 1) + 1] entries
// (ops/hier_kernel.pack_levels: each level starts on a 32-byte boundary
// of `upper`), n / 63 entries in all.
//
// Bound on the H100: what a query needs is its key, guess and error
// read and its answer written (32 B) and, at level 0, the sectors that
// hold keys[lb - 1] and keys[lb]; the upper levels (25 MB at 200M keys)
// stay in L2.  A thread takes one query through every level in order
// (each limit is the count above it).  The levels are sorted, so each
// count is its window's lower bound.  What sets the pace is the count of
// dependent random reads, not their latency: the earlier design, 8
// halving steps a level at 27 registers and 2048 threads an SM, took
// 1.12 ms on path 8's 2^22 queries (PERF.md §6).  This design cuts the
// reads:
//   - the bracket: below level K, a count strictly inside its window
//     (0 < c < w) pins the next level's answer to (64 (lb - 1), 64 lb],
//     since level k + 1 is level k's every 64th entry, and gives the
//     values at both ends; there the kernel reads inside those 63
//     entries only.  A count at a window's edge (a guess whose bound
//     fails) leaves the next level to its whole window, as the plain
//     version counts it, so the result is the plain version's on every
//     input;
//   - the ends: a window (level K, or after an edge) reads its first and
//     last entries and, when q lies between, becomes a bracket;
//   - interpolation: inside a bracket, the first read is the aligned
//     32-byte sector (two 16-byte loads) where the ends' values place q;
//     one that misses narrows the bracket and a second is placed the
//     same way, then halving steps finish, their last three entries one
//     sector;
//   - a persistent grid: the blocks resident at once loop over the
//     queries, so that a warp whose queries finish early takes new ones
//     rather than idling until the slowest thread of its block is done.
// All arithmetic is int64, as the plain version's (the interpolation's
// double only places a read).  The first design, a warp a query counting
// the row in coalesced 32-byte lane loads, took 2.30 ms on path 8.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFan = 64;          // lookup_fast.LEVEL_FAN
constexpr int64_t kWidth = 128;       // entries of one level's count
constexpr int kMaxK = 10;             // 64^K fits in int64
constexpr int kRounds = 2;            // interpolated reads inside a bracket before halving

// v[0..3] = p[0..3]: two 16-byte loads where p is 16-byte aligned
// (`vec`), four independent loads where it is not
__device__ __forceinline__ void ld4(const int64_t* p, bool vec, int64_t v[4]) {
  if (vec) {
    const longlong2* s = reinterpret_cast<const longlong2*>(p);
    const longlong2 a = __ldg(s), b = __ldg(s + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(p + j);
  }
}

// entry i of v[0..3] by selects, so that v stays in registers (an array
// indexed by a variable lives in local memory)
__device__ __forceinline__ int64_t pick(const int64_t* v, int i) {
  return i < 2 ? (i == 0 ? v[0] : v[1]) : (i == 2 ? v[2] : v[3]);
}

// One interpolated read inside the bracket (p, p + span + 1] whose ends
// hold lov < q <= hiv: the sector from the 4-aligned index where q
// should fall.  Returns true with the answer in *ans when it straddles
// q; otherwise narrows the bracket past it.  The entries read lie in
// [0, len): s <= p + span <= len - 2, and where s + 4 > len, s >= 4
// (len >= p + span + 2 >= 6).
__device__ __forceinline__ bool interp_read(const int64_t* __restrict__ a, int64_t len,
                                            int64_t& p, int64_t& span, int64_t q, bool vec,
                                            int64_t& lov, int64_t& hiv, int64_t* ans) {
  double f = ((double)q - (double)lov) / ((double)hiv - (double)lov);
  f = fmin(fmax(f, 0.0), 1.0);         // fmax(NaN, 0) is 0
  int64_t j = p + 1 + (int64_t)(f * (double)span);
  j = j > p + span ? p + span : j;
  int64_t s = j & ~(int64_t)3;
  if (s + 4 > len) s -= 4;
  int64_t v[4];
  ld4(a + s, vec, v);
  const int below = (v[0] < q) + (v[1] < q) + (v[2] < q) + (v[3] < q);
  if (below == 4) {
    if (s + 3 > p) {
      span -= s + 3 - p;
      p = s + 3;
      lov = v[3];
    }
  } else if (below == 0) {
    if (s > p && s <= p + span) {
      span = s - 1 - p;
      hiv = v[0];
    }
  } else {
    lov = pick(v, below - 1);
    hiv = pick(v, below);
    *ans = s + below;
    return true;
  }
  return false;
}

// One level's lower bound of q among a[p + 1 .. p + span]:
// p + 1 + #{j in 1..span : a[p + j] < q}, the level being sorted.  a[p]
// is below q where p >= 0, and a[p + span + 1] is not where it is read,
// so only the entries between are read.  lov and hiv follow the values
// on the answer's two sides, which the next level's interpolation reads.
// `bracket`: the answer is known to lie in (p, p + 64] with lov = a[p]
// and hiv = a[p + 64]; otherwise the window's two ends are read first.
// `vec`: the level starts on a 16-byte boundary.
__device__ __forceinline__ int64_t search(const int64_t* __restrict__ a, int64_t len, int64_t p,
                                          int64_t span, int64_t q, bool bracket, bool vec,
                                          int64_t& lov, int64_t& hiv) {
  if (!bracket) {
    const int64_t a0 = __ldg(a + p + 1), a1 = __ldg(a + p + span);
    if (a0 >= q) {
      hiv = a0;
      return p + 1;
    }
    if (a1 < q) {
      lov = a1;
      return p + span + 1;
    }
    lov = a0;
    hiv = a1;
    p += 1;
    span -= 2;
  }
#pragma unroll 1
  for (int r = 0; r < kRounds && span > 3; ++r) {
    int64_t ans;
    if (interp_read(a, len, p, span, q, vec, lov, hiv, &ans)) return ans;
  }
  int64_t c = 0;                               // a[p + 1 .. p + c] are below q
#pragma unroll
  for (int64_t step = kWidth; step >= 4; step >>= 1) {
    if (c + step <= span) {
      const int64_t v = __ldg(a + p + c + step);
      if (v < q) {
        c += step;
        lov = v;
      } else {
        hiv = v;
      }
    }
  }
  // a[p + c + 1 .. p + c + r] are left, r <= 3
  const int64_t r = span - c < 3 ? span - c : 3;
  if (r > 0) {
    const int64_t first = p + c + 1;
    const int64_t s = first & ~(int64_t)3;
    int64_t v[4];
    int cnt = 0;
    if (first + r <= s + 4 && s + 4 <= len) {   // one sector holds them
      ld4(a + s, vec, v);
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        if (s + j >= first && s + j < first + r && v[j] >= q) hiv = v[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s + j >= first && s + j < first + r && v[j] < q) {
          ++cnt;
          lov = v[j];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = j < r ? __ldg(a + first + j) : 0;
#pragma unroll
      for (int j = 2; j >= 0; --j) {
        if (j < r && v[j] >= q) hiv = v[j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < r && v[j] < q) {
          ++cnt;
          lov = v[j];
        }
      }
    }
    c += cnt;
  }
  return p + 1 + c;
}

__global__ void __launch_bounds__(kThreads, 1)
resolve(const int64_t* __restrict__ queries, const int64_t* __restrict__ guess,
        const int64_t* __restrict__ err, const int64_t* __restrict__ keys, int64_t n0,
        const int64_t* __restrict__ upper, const int64_t* __restrict__ index, int K,
        int64_t sK, int64_t* __restrict__ out, int64_t m, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // the keys' range: a query outside it is answered by its end
  const int64_t kfirst = __ldg(keys), klast = __ldg(keys + n0 - 1);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m; i += stride) {
    const int64_t q = __ldg(queries + i);
    if (q <= kfirst || q > klast) {
      out[i] = q <= kfirst ? 0 : n0;
      continue;
    }
    // guess - err wraps as torch's int64 does
    int64_t lo = (int64_t)((uint64_t)__ldg(guess + i) - (uint64_t)__ldg(err + i));
    lo = lo < 0 ? 0 : (lo > n ? n : lo);
    int64_t LB = (lo + sK - 1) / sK;
    int64_t lb = 0, lov = 0, hiv = 0;
    bool inside = false;
    for (int k = K; k >= 0; --k) {
      const int64_t* level = k == 0 ? keys : upper + __ldg(index + 2 * (k - 1));
      const int64_t len = k == 0 ? n0 : __ldg(index + 2 * (k - 1) + 1);
      const bool bracket = k < K && inside;
      int64_t p, span, start = 0, w = 0;
      if (bracket) {
        p = kFan * (lb - 1);
        span = kFan - 1;
      } else {
        if (k < K) {
          LB = lb * kFan - (kFan - 1);
          LB = LB < 0 ? 0 : LB;
        }
        const int64_t nrows = len > 0 ? (len + kFan - 1) / kFan : 1;
        int64_t row = LB >> 6;
        row = row < 0 ? 0 : (row > nrows - 1 ? nrows - 1 : row);
        start = row * kFan;
        w = len - start < kWidth ? len - start : kWidth;   // entries in the level
        p = start - 1;
        span = w;
      }
      const bool vec = (reinterpret_cast<uintptr_t>(level) & 15) == 0;
      lb = search(level, len, p, span, q, bracket, vec, lov, hiv);
      // a bracket's answer lies strictly inside its window (0 < c < 65 <= w)
      inside = bracket || (lb > start && lb < start + w);
      lb = lb < len ? lb : len;
    }
    out[i] = lb;
  }
}

// the blocks of `resolve` resident on the current device at once, asked
// once per device
cudaError_t resident_blocks(int* blocks) {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resolve, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    counts[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = counts[dev];
  return cudaSuccess;
}

}  // namespace

// out[i]: the lower bound of queries[i] in keys[0 : n0] from guess[i] and
// err[i] through levels 0..K (the keys, then upper as index says); n the
// plan's key count, which clamps guess - err.  A query at or below
// keys[0] answers 0 and one above keys[n0 - 1] n0, whatever its guess
// (ops/hier_kernel.resolve_plain says why).  A K outside [0, 10] or a
// missing level is refused with cudaErrorInvalidValue.  One persistent
// grid: the blocks resident at once, or fewer for a small batch.
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
  if (m == 0) return (int)cudaGetLastError();
  int fit = 0;
  const cudaError_t e = resident_blocks(&fit);
  if (e != cudaSuccess) return (int)e;
  const unsigned int blocks = rmi_grid(m, kThreads);
  resolve<<<blocks < (unsigned int)fit ? blocks : (unsigned int)fit, kThreads, 0,
            (cudaStream_t)stream>>>(queries, guess, err, keys, n0, upper, index, (int)K, sK,
                                    out, m, n);
  return (int)cudaGetLastError();
}
