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
//   - the fixed-trip halving search: a halving search of [lo, hi) ends
//     after bit_length(hi - lo) steps, and where `iters` reaches that,
//     every exact search of the sorted window answers what it answers, so
//     the kernel searches as below; where `iters` falls short (an answer
//     inside the window that need not be the lower bound) it runs those
//     `iters` halving steps, as the plain version does.  The interpolation's
//     trip count (interp_iters) always covers its window;
//   - int64 compares of the images and int64 index arithmetic; guess - err
//     wraps as torch's int64 does;
//   - only entries inside the window decide an answer: a sector read may
//     bring keys beside it (past n, or outside [lo, hi)), never used;
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
// answer written (32 B) and the sectors that decide it.  The keys (1.6 GB
// at 200M) and the knots (200 MB at cache_fix_osm's 24.9M) do not fit L2,
// so every read of them is a random 32-byte sector of device memory, and
// the card serves ~3e10 of those a second (PERF.md §6): the count of
// sectors a query reads sets the time.  The first design halved one entry
// a step (~20 reads over path 8's windows, ~8 sectors a query over
// cache_fix_osm's knots and their values).  This one reads whole sectors
// and places them:
//   - a search knows a bracket (p, r] around the answer, with the values
//     at its ends where it has read them; each read is the aligned 32-byte
//     sector (two 16-byte loads) that holds one chosen entry, and every
//     entry of it inside the bracket narrows it;
//   - a window wider than kEndsAbove entries reads the sectors of its two
//     ends first, together; a narrower one starts in its middle, where the
//     guess lies;
//   - with both ends' values known, the next read is placed where they put
//     q (interpolation, kInterpRounds at most), else in the middle; the
//     one sector left is read whole;
//   - the interpolation's knots are searched first in `sample`
//     (knots[::stride], cached on the index: 6 MB at 24.9M knots, which L2
//     keeps) where the window holds more than `stride` knots, so that the
//     knots' own reads start inside a bracket of stride entries with both
//     values known;
//   - a thread a query, a grid-stride loop over the batch: a persistent
//     grid of the blocks resident at once, and two queries a thread with
//     their reads interleaved, both took longer on the card.
// The reads a query, by shape, are tools/count_torch_cachefix_reads.py's,
// a host mirror of this search.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kEndsAbove = 32;   // a window wider than this reads its two ends first
constexpr int kInterpRounds = 4;     // interpolated reads in a search, then the middle

// What a search knows: the answer lies in (p, r]; a[p] < q with value lov
// where has_lo, a[r] >= q with value hiv where has_hi.  An end not read is
// the window's edge (lo - 1, or hi), whose entry is never read.
struct Bracket {
  int64_t p, r, lov, hiv;
  bool has_lo, has_hi;
};

// the first entry of the 32-byte sector that holds a[j], by its address
// (a is 8-byte aligned)
__device__ __forceinline__ int64_t sector_of(const int64_t* a, int64_t j) {
  const int64_t off = (int64_t)((reinterpret_cast<uintptr_t>(a) >> 3) & 3);
  return ((j + off) & ~(int64_t)3) - off;
}

// v[0..3] = a[s .. s + 3] for the sector at s: two 16-byte loads where it
// lies inside a[0 : len), else a load for each entry that does (the others
// 0, outside every bracket)
__device__ __forceinline__ void load_sector(const int64_t* __restrict__ a, int64_t len,
                                            int64_t s, int64_t v[4]) {
  if (s >= 0 && s + 4 <= len) {
    const longlong2* p = reinterpret_cast<const longlong2*>(a + s);
    const longlong2 x = __ldg(p), y = __ldg(p + 1);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = s + t >= 0 && s + t < len ? __ldg(a + s + t) : 0;
  }
}

// b narrowed by the entries of the sector at s that lie inside it, a
// being sorted there
__device__ __forceinline__ void narrow(const int64_t v[4], int64_t s, int64_t q, Bracket& b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int64_t j = s + t;
    if (j > b.p && j < b.r) {
      if (v[t] < q) {
        b.p = j;
        b.lov = v[t];
        b.has_lo = true;
      } else {
        b.r = j;
        b.hiv = v[t];
        b.has_hi = true;
      }
    }
  }
}

// b narrowed to r = p + 1, the answer r: the first j in (p, r] with a[j]
// >= q (r where no entry inside is).  Each read is one sector: the one
// left where one holds what is inside, else the one where the ends'
// values place q (at most kInterpRounds times), else the middle one.
__device__ __forceinline__ void finish(const int64_t* __restrict__ a, int64_t len, int64_t q,
                                       Bracket& b) {
  int rounds = kInterpRounds;
#pragma unroll 1
  while (b.r - b.p > 1) {
    const int64_t first = b.p + 1, last = b.r - 1;
    int64_t j;
    if (sector_of(a, first) == sector_of(a, last)) {
      j = first;
    } else if (b.has_lo && b.has_hi && rounds > 0) {
      --rounds;
      // the differences as u64 are exact (lov < q <= hiv) and keep a u32
      // key's gaps, which its image, near -2^63, loses in a double
      double f = (double)((uint64_t)q - (uint64_t)b.lov) /
                 (double)((uint64_t)b.hiv - (uint64_t)b.lov);
      f = fmin(fmax(f, 0.0), 1.0);
      j = first + (int64_t)(f * (double)(b.r - b.p - 1));
      j = j > last ? last : j;
    } else {
      j = b.p + ((b.r - b.p) >> 1);
    }
    const int64_t s = sector_of(a, j);
    int64_t v[4];
    load_sector(a, len, s, v);
    narrow(v, s, q, b);
  }
}

// the search of the window [lo, hi) of a[0 : len), sorted there: its
// bracket, narrowed to one entry
__device__ __forceinline__ Bracket window(const int64_t* __restrict__ a, int64_t len, int64_t q,
                                          int64_t lo, int64_t hi) {
  Bracket b{lo - 1, hi, 0, 0, false, false};
  if (hi - lo > kEndsAbove) {        // the two ends' sectors, together
    const int64_t s0 = sector_of(a, lo), s1 = sector_of(a, hi - 1);
    int64_t v0[4], v1[4];
    load_sector(a, len, s0, v0);
    load_sector(a, len, s1, v1);
    narrow(v0, s0, q, b);
    narrow(v1, s1, q, b);
  }
  finish(a, len, q, b);
  return b;
}

// the first j in [lo, hi) with keys[j] >= q, at most `iters` halving steps
// (the plain version's search, where `iters` does not cover the window)
__device__ __forceinline__ int64_t halving(const int64_t* __restrict__ keys, int64_t n,
                                           int64_t q, int64_t lo, int64_t hi, int64_t iters) {
  for (int64_t it = 0; it < iters && lo < hi; ++it) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// halving steps that end a search of w entries
__device__ __forceinline__ int64_t bit_length(int64_t w) {
  return w > 0 ? 64 - __clzll((long long)w) : 0;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the window [lo, hi) of guess g and error e over [0, n), g - e and
// g + e + 1 wrapping as int64; hi no lower than lo (a window with hi < lo
// answers lo, as an empty one does)
__device__ __forceinline__ void window_of(int64_t g, int64_t e, int64_t n, int64_t& lo,
                                          int64_t& hi) {
  lo = clamp64((int64_t)((uint64_t)g - (uint64_t)e), 0, n);
  hi = clamp64((int64_t)((uint64_t)g + (uint64_t)e + 1), lo, n);
}

__global__ void __launch_bounds__(kThreads)
    bounded(const int64_t* __restrict__ keys, int64_t n_keys,
            const int64_t* __restrict__ queries, const int64_t* __restrict__ guess,
            const int64_t* __restrict__ err, int64_t* __restrict__ out, int64_t m, int64_t n,
            int64_t iters, bool exact) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m; i += stride) {
    const int64_t q = __ldg(queries + i);
    int64_t lo, hi;
    window_of(__ldg(guess + i), __ldg(err + i), n, lo, hi);
    const bool covered = iters >= bit_length(hi - lo);
    int64_t j = covered ? window(keys, n_keys, q, lo, hi).r : halving(keys, n, q, lo, hi, iters);
    // whether j is the lower bound in keys[0 : n]: where the search covered
    // the window, only the key beyond an edge can say it is not
    if (exact && !(covered ? (j > lo || lo == 0 || __ldg(keys + lo - 1) < q) &&
                                 (j < hi || hi == n || __ldg(keys + hi) >= q)
                           : (j == 0 || __ldg(keys + j - 1) < q) &&
                                 (j == n || __ldg(keys + j) >= q))) {
      j = window(keys, n_keys, q, 0, n).r;
    }
    out[i] = j;
  }
}

__global__ void __launch_bounds__(kThreads)
    interp(const int64_t* __restrict__ knots, const int64_t* __restrict__ vals, int64_t num_pts,
           const int64_t* __restrict__ sample, int64_t n_sample, int64_t sample_stride,
           const int64_t* __restrict__ queries, const int64_t* __restrict__ start,
           const int64_t* __restrict__ err, int64_t* __restrict__ out, int64_t m,
           int64_t line_size, int64_t total_keys, double eps, int64_t iters) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const double line = (double)line_size;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m; i += stride) {
    const int64_t q = __ldg(queries + i);
    int64_t lo, hi;
    window_of(__ldg(start + i), __ldg(err + i), num_pts, lo, hi);
    int64_t res;
    if (iters < bit_length(hi - lo)) {
      res = halving(knots, num_pts, q, lo, hi, iters);
    } else if (hi - lo <= sample_stride) {
      res = window(knots, num_pts, q, lo, hi).r;
    } else {
      // the sample's entries inside the window bracket the answer within
      // sample_stride knots, with the values at the bracket's ends
      const int64_t k0 = (lo + sample_stride - 1) / sample_stride;
      const Bracket s = window(sample, n_sample, q, k0, (hi - 1) / sample_stride + 1);
      Bracket b{s.has_lo ? s.p * sample_stride : lo - 1, s.has_hi ? s.r * sample_stride : hi,
                s.lov, s.hiv, s.has_lo, s.has_hi};
      finish(knots, num_pts, q, b);
      res = b.r;
    }
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
// most `iters` halving steps over keys[0 : n] (n_keys entries in all,
// sorted); with `exact` nonzero, the lower bound of queries[i] in keys[0 :
// n] wherever that answer is not.  An n above n_keys or a negative count is
// refused with cudaErrorInvalidValue.
RMI_API int rmi_bounded_lower_bound(const int64_t* keys, int64_t n_keys, const int64_t* queries,
                                    const int64_t* guess, const int64_t* err, int64_t* out,
                                    int64_t m, int64_t n, int64_t iters, int64_t exact,
                                    void* stream) {
  if (m < 0 || n < 0 || n > n_keys || iters < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  bounded<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      keys, n_keys, queries, guess, err, out, m, n, iters, exact != 0);
  return (int)cudaGetLastError();
}

// out[i]: the cachefix position of queries[i] from the RMI's (start[i],
// err[i]) over the num_pts sorted knot images `knots` with values `vals`
// (rmi_tpu's _cachefix_interp); sample = knots[::sample_stride] (n_sample
// = ceil(num_pts / sample_stride) entries); eps = max(total_keys, 1) 2^-40
// from the caller.  num_pts < 1, line_size < 1, sample_stride < 1, a
// sample of another length or a negative count is refused with
// cudaErrorInvalidValue.
RMI_API int rmi_cachefix_interp(const int64_t* knots, const int64_t* vals, int64_t num_pts,
                                const int64_t* sample, int64_t n_sample, int64_t sample_stride,
                                const int64_t* queries, const int64_t* start,
                                const int64_t* err, int64_t* out, int64_t m,
                                int64_t line_size, int64_t total_keys, double eps,
                                int64_t iters, void* stream) {
  if (m < 0 || num_pts < 1 || line_size < 1 || iters < 0 || sample_stride < 1 ||
      n_sample != (num_pts + sample_stride - 1) / sample_stride) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaGetLastError();
  interp<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      knots, vals, num_pts, sample, n_sample, sample_stride, queries, start, err, out, m,
      line_size, total_keys, eps, iters);
  return (int)cudaGetLastError();
}
