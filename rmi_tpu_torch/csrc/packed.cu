// The packed plan's search and K5's window bounds (ops/packed_kernel.py;
// packed_search_plain and sorted_bounds_plain are the plain versions).
//
//   rmi_packed_search  out[i] = #(keys < queries[i]), the exact lower
//                      bound, through the plan's leaf rows: the query,
//                      clipped to [kmin, kmax], routed through the top to
//                      its leaf; the leaf row's count of samples below it
//                      gives LB1 = base + (c1 - 1) F, a lower limit of
//                      lb1 = #(stripe-first keys < q) within F of it; with
//                      F = 1 LB1 names the stripe, with F > 1 a count over
//                      128 stripe-first keys from 64 (LB1 >> 6) finds lb1;
//                      a count over the stripe's 64 keys finishes;
//   rmi_sorted_bounds  K5's window [lo, hi] of each block of kq sorted
//                      queries: lo = clamp(LB1(first) - 1, 0, nrows0),
//                      hi = clamp(LB1(last) + F, 0, nrows0).
//
// Replace two XLA steps of rmi_tpu that have no Pallas call:
// _fast_search_packed and _fast_search_packed_wide (rmi_tpu/
// lookup_fast.py:420-521), one jit program each, and _sorted_stats_direct
// (:683), the anchors of rmi_tpu's K5.  Both entries share LB1 (struct
// Plan); the port ran it as a chain of eager torch launches with [q, S],
// [q, 128] and [q, 64] temporaries.
//
// Routing is two_layer.top_assignment of the clipped image, bit for bit,
// with the evaluators of rmi_lookup_* (csrc/eval.cu): an affine top is
// its leaf kernel's rmi_leaf on row 0 of its table, on the key decoded
// by key_kind and normalized, clamped by rmi_clamp_floor to B - 1; an
// integer top is RmiIntTopEval (csrc/int_top.cuh) on the key's u64 bits,
// its operand read where the route says: radix and bradix read none, a
// hint table's narrowed entries are read in place (the folded route is
// refused: it would need the plan's rows by bucket, S + 1 int64 a row
// for each of up to 2^28 buckets), a histogram's pivots in place or
// staged in each block's shared memory as their search tree (route 1,
// over a persistent grid).  A lognormal top routes on max(ln x, 0),
// whose CUDA log differs from glibc's on a few keys, so its caller
// passes the leaf ids (computed in torch) and the kernel skips the top.
//
// The counts: each run counted is non-decreasing (a leaf row's samples
// keys[64 (base + i F)], padded with IMAGE_MAX; stripe-first keys; keys),
// so #(a[0 : len] < q) is the lower bound of q in it, where the plain
// version compares every entry.  Positions past an array's end count as
// not below q, as count_from has it.  A leaf row and the wide plan's
// window of stripe-first keys are counted by halving steps until at most
// 8 entries are left, then those 8 read at once (count_below); the
// stripe's 64 keys through K5's sample level group_first = keys[::8]:
// its 8 entries of the stripe, one 64-byte read, name the 8-key group
// that holds the lower bound, a second 64-byte read (count_stripe).
//
// Bound on the H100: a query needs its image read and its answer
// written (16 B) and the sectors that decide it: one of the leaf row's
// sectors around q (path 1's rows, 35.7 MB, stay in L2 for the most
// part), the wide plan's stripe-first sectors, and one or two 32-byte
// sectors of the keys' 64-key stripe, which lie in device memory.  The
// reads of one query depend on each other, so the time is set by how
// many are in flight and how many round trips a query takes: a thread a
// query, as many resident threads as the card holds, a grid-stride loop
// over the batch, and the rounds cut where the design above can (path
// 1's row: 2 instead of 5; the stripe: 2 reads of 64 bytes, each within
// one 64-byte block of device memory, instead of 7 halving steps over
// ~5 of its 16 sectors, the first design's 1.0221 ms for 2^22 queries).
#include "common.cuh"
#include "int_top.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kStripe = 64;        // keys a stripe (lookup_fast.STRIDE)
constexpr int64_t kWidth = 128;        // stripe-first keys of the wide plan's count
constexpr int64_t kMaxSamples = 127;   // samples a leaf row (rmi_tpu's 255 u32 lanes)
constexpr int64_t kMaxSpacing = 64;    // stripes between samples (_WIDE_MAX_STRIDE)

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// #(p[0 : min(avail, 8)] < q): the entries read at once, two to a
// 16-byte load where p lies on a 16-byte boundary; entries past `avail`
// count as not below q
__device__ __forceinline__ int64_t count8(const int64_t* __restrict__ p, int64_t avail,
                                          int64_t q) {
  int64_t v[8];
  if (avail >= 8 && ((uintptr_t)p & 15) == 0) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(p) + h);
      v[2 * h] = t.x;
      v[2 * h + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < avail ? __ldg(p + k) : INT64_MAX;
  }
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) c += v[k] < q ? 1 : 0;
  return c;
}

// #(a[0 : len] < q) of a non-decreasing run.  The count c lies in
// [lo, hi] (a[lo - 1] < q, and hi = len or a[hi] >= q); a halving step
// reads a[mid - 1] and keeps the half that holds c, until fewer than 8
// entries, a[lo : hi], are left, which count8 reads at once
__device__ __forceinline__ int64_t count_below(const int64_t* __restrict__ a, int64_t len,
                                               int64_t q) {
  int64_t lo = 0, hi = len;
  while (hi - lo >= 8) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (__ldg(a + mid - 1) < q) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo + count8(a + lo, hi - lo, q);
}

// The plan the counts read, and the clipping of the routed query
struct Plan {
  const int64_t* rows;           // [B, 1 + S]: base, then S samples
  int64_t S, F;
  const int64_t* stripe_first;   // keys[::64], nrows0 of them
  const int64_t* group_first;    // keys[::8], ng of them
  const int64_t* keys;
  int64_t n, nrows0, ng;
  int64_t kmin, kmax;

  // LB1 of query q routed to `leaf`: base + (c1 - 1) F, c1 the row's
  // samples below q
  __device__ __forceinline__ int64_t lb1(int64_t leaf, int64_t q) const {
    const int64_t* row = rows + leaf * (1 + S);
    return __ldg(row) + (count_below(row + 1, S, q) - 1) * F;
  }

  // start + #(arr[start : start + width] < q), arr of m entries
  __device__ __forceinline__ int64_t count_from(const int64_t* arr, int64_t m, int64_t start,
                                                int64_t width, int64_t q) const {
    const int64_t len = m - start < width ? m - start : width;
    return start + count_below(arr + start, len > 0 ? len : 0, q);
  }

  // 64 row + #(keys[64 row : 64 row + 64] < q), row < nrows0: the
  // stripe's 8 group-first keys name the group of 8 keys past the last
  // one below q (none below: the count is 0), whose 8 keys finish it
  __device__ __forceinline__ int64_t count_stripe(int64_t row, int64_t q) const {
    const int64_t g0 = row * (kStripe / 8);
    const int64_t c = count8(group_first + g0, ng - g0, q);
    if (c == 0) return row * kStripe;
    const int64_t at = (g0 + c - 1) * 8;
    return at + count8(keys + at, n - at, q);
  }

  // the lower bound of q from its LB1 (lookup_fast._packed_search)
  __device__ __forceinline__ int64_t search(int64_t LB1, int64_t q) const {
    int64_t row;
    if (F == 1) {
      row = clamp64(LB1, 0, nrows0 - 1);          // lb1 - 1 <= LB1 <= lb1
    } else {
      const int64_t r1 = clamp64(LB1, 0, nrows0) >> 6;
      const int64_t lb = count_from(stripe_first, nrows0, r1 * kStripe, kWidth, q);
      row = clamp64((lb < nrows0 ? lb : nrows0) - 1, 0, nrows0 - 1);
    }
    const int64_t lb = count_stripe(row, q);
    return lb < n ? lb : n;
  }
};

// The routes of a clipped image to its leaf.  Each is made once a
// thread, its operands read then.

// an affine top: its leaf kernel's rmi_leaf on row 0 of its table
template <RmiKey KK>
struct AffineTop {
  int64_t kind;               // RmiLeaf
  double w[4];
  double offset, scale, bound;

  __device__ __forceinline__ AffineTop(const double* top_w, int64_t top_kind, double off,
                                       double s, double last)
      : kind(top_kind), w{0.0, 0.0, 0.0, 0.0}, offset(off), scale(s), bound(last) {
    // every index constant, so the row stays in registers
    const int width = rmi_leaf_width((RmiLeaf)kind);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = k < width ? __ldg(top_w + k) : 0.0;
  }

  __device__ __forceinline__ int64_t leaf(int64_t, int64_t image) const {
    const double x = normalized<KK>(image, offset, scale);
    double v;
    switch (kind) {
      case (int64_t)RmiLeaf::kCubic: v = rmi_leaf<RmiLeaf::kCubic>(w, 0, x); break;
      case (int64_t)RmiLeaf::kLoglinear: v = rmi_leaf<RmiLeaf::kLoglinear>(w, 0, x); break;
      case (int64_t)RmiLeaf::kNormal: v = rmi_leaf<RmiLeaf::kNormal>(w, 0, x); break;
      default: v = rmi_leaf<RmiLeaf::kLinear>(w, 0, x); break;
    }
    return rmi_clamp_floor(v, bound);
  }
};

// an integer top (int_top.cuh), its operand where route R reads it
template <RmiKey KK, RmiRoute R>
struct IntTop {
  RmiIntTopEval t;
  const int64_t* tree;        // the staged pivots (route 1)

  __device__ __forceinline__ int64_t leaf(int64_t, int64_t image) const {
    const uint64_t u[1] = {int_bits<KK>(image)};
    int64_t l[1];
    t.leaves<R>(u, tree, l);
    return l[0];
  }
};

// the caller's leaf ids (a lognormal top's, computed in torch)
struct GivenLeaves {
  const int64_t* ids;

  __device__ __forceinline__ int64_t leaf(int64_t i, int64_t) const { return __ldg(ids + i); }
};

// What a launch computes: the lower bound of each query (Search), or
// the window of each block of kq sorted queries (Bounds), per item i
struct Search {
  const int64_t* queries;
  int64_t* out;
  int64_t m;

  __host__ __device__ int64_t items() const { return m; }

  template <class Top>
  __device__ __forceinline__ void item(const Plan& p, const Top& top, int64_t i) const {
    const int64_t q = __ldg(queries + i);
    out[i] = p.search(p.lb1(top.leaf(i, clamp64(q, p.kmin, p.kmax)), q), q);
  }
};

// item i < nb anchors block i at its first query, item nb + b block b
// at its last (the caller's leaf ids in that order)
struct Bounds {
  const int64_t* queries;
  int64_t* lo;
  int64_t* hi;
  int64_t nq, kq, nb;

  __host__ __device__ int64_t items() const { return 2 * nb; }

  template <class Top>
  __device__ __forceinline__ void item(const Plan& p, const Top& top, int64_t i) const {
    const bool first = i < nb;
    const int64_t b = first ? i : i - nb;
    const int64_t at = first ? b * kq : (b * kq + kq - 1 < nq - 1 ? b * kq + kq - 1 : nq - 1);
    const int64_t q = __ldg(queries + at);
    const int64_t LB1 = p.lb1(top.leaf(i, clamp64(q, p.kmin, p.kmax)), q);
    if (first) {
      lo[b] = clamp64(LB1 - 1, 0, p.nrows0);
    } else {
      hi[b] = clamp64(LB1 + p.F, 0, p.nrows0);
    }
  }
};

template <class Work, class Top>
__device__ __forceinline__ void walk(const Work& w, const Plan& p, const Top& top) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < w.items(); i += stride) {
    w.item(p, top, i);
  }
}

// How the launch routes: by an affine top, an integer top in place or
// staged in a block, or by given leaf ids
enum class Via { kAffine, kIntInPlace, kIntBlock, kGiven };

struct TopArgs {
  const double* top_w;
  int64_t top_kind;
  RmiIntTopArgs int_top;
  const int64_t* leaf_ids;
  double offset, scale;
};

template <class Work, RmiKey KK, Via V>
__global__ void __launch_bounds__(kThreads)
packed(const Work w, const Plan p, const TopArgs a) {
  if constexpr (V == Via::kAffine) {
    const AffineTop<KK> top(a.top_w, a.top_kind, a.offset, a.scale,
                            (double)a.int_top.last);
    walk(w, p, top);
  } else if constexpr (V == Via::kGiven) {
    walk(w, p, GivenLeaves{a.leaf_ids});
  } else {
    extern __shared__ int64_t tree[];
    const IntTop<KK, V == Via::kIntBlock ? RmiRoute::kBlock : RmiRoute::kInPlace> top{
        RmiIntTopEval(a.int_top), tree};
    if constexpr (V == Via::kIntBlock) {
      rmi_stage_tree(tree, top.t.pivots, top.t.len, top.t.levels);
      __syncthreads();
    }
    walk(w, p, top);
  }
}

// One launch: a grid covering the items (at most rmi_grid's blocks, each
// thread then taking several), or under a staged operand the blocks
// resident at once (each stages it once), fewer for a short batch
template <class Work, RmiKey KK, Via V>
cudaError_t start(const Work& w, const Plan& p, const TopArgs& a, size_t smem, void* stream) {
  const auto kernel = packed<Work, KK, V>;
  unsigned int blocks = rmi_grid(w.items(), kThreads);
  if (V == Via::kIntBlock) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    }
    if (e != cudaSuccess) return e;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = blocks < (unsigned int)(sms * per_sm) ? blocks : (unsigned int)(sms * per_sm);
  }
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(w, p, a);
  return cudaGetLastError();
}

template <class Work, RmiKey KK>
cudaError_t start_by_top(const Work& w, const Plan& p, const TopArgs& a, int64_t route,
                         size_t smem, void* stream) {
  if (a.leaf_ids != nullptr) return start<Work, KK, Via::kGiven>(w, p, a, 0, stream);
  if (a.top_kind <= (int64_t)RmiLeaf::kNormal) {
    return start<Work, KK, Via::kAffine>(w, p, a, 0, stream);
  }
  if (route == (int64_t)RmiRoute::kBlock) {
    return start<Work, KK, Via::kIntBlock>(w, p, a, smem, stream);
  }
  return start<Work, KK, Via::kIntInPlace>(w, p, a, 0, stream);
}

// The arguments both entries share, checked: the key kind, the plan's
// shape (1 <= S <= 127, F a power of two <= 64, B >= 1, n >= 1, kmin <=
// kmax; the counts' arrays, which only the search reads, its caller
// checks), and the top: given leaf ids, or an affine top's row (route 0),
// or an integer top by a route it can take other than the folded one
// (rmi_int_route_ok; smem the bytes a block stages).  Items of work
// only when all hold.
template <class Work>
int launch(const Work& w, int64_t key_kind, const double* top_w, int64_t top_kind,
           const int64_t* top_int, const int32_t* top_table, const int64_t* pivots,
           int64_t top_len, int64_t route, const int64_t* leaf_ids, const int64_t* rows,
           int64_t S, int64_t F, const int64_t* stripe_first, const int64_t* group_first,
           const int64_t* keys, int64_t B, int64_t n, double offset, double scale, int64_t kmin,
           int64_t kmax, void* stream) {
  const RmiIntTopArgs int_top{top_kind, top_int, top_table, pivots, top_len, (uint64_t)(B - 1)};
  size_t smem = 0;
  bool top_ok;
  if (leaf_ids != nullptr) {
    top_ok = true;
  } else if (top_kind >= 0 && top_kind <= (int64_t)RmiLeaf::kNormal) {
    top_ok = top_w != nullptr && route == (int64_t)RmiRoute::kInPlace;
  } else {
    top_ok = route != (int64_t)RmiRoute::kFolded && rmi_int_route_ok(int_top, route, &smem);
  }
  if (!top_ok || B < 1 || n < 1 || S < 1 || S > kMaxSamples || F < 1 || F > kMaxSpacing ||
      (F & (F - 1)) != 0 || kmin > kmax || rows == nullptr ||
      (key_kind != (int64_t)RmiKey::kU64 && key_kind != (int64_t)RmiKey::kF64)) {
    return (int)cudaErrorInvalidValue;
  }
  if (w.items() == 0) return (int)cudaGetLastError();
  const Plan p{rows, S, F, stripe_first, group_first, keys, n, (n + kStripe - 1) / kStripe,
               (n + 7) / 8, kmin, kmax};
  const TopArgs a{top_w, top_kind, int_top, leaf_ids, offset, scale};
  const cudaError_t e = key_kind == (int64_t)RmiKey::kF64
                            ? start_by_top<Work, RmiKey::kF64>(w, p, a, route, smem, stream)
                            : start_by_top<Work, RmiKey::kU64>(w, p, a, route, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// out[i]: the lower bound of queries[i] in keys[0 : n] through the plan
// (its leaf rows [B, 1 + S], sample spacing F, stripe-first keys of
// ceil(n / 64) entries, group-first keys keys[::8] of ceil(n / 8),
// routing domain [kmin, kmax]), the query routed
// as key_kind and the top say (rmi_lookup_*'s top arguments; a folded
// route refused), or by leaf_ids[i] where leaf_ids is not empty.  A
// count, a top or a plan it cannot take is refused with
// cudaErrorInvalidValue.
RMI_API int rmi_packed_search(const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, int64_t S, int64_t F,
                              const int64_t* stripe_first, const int64_t* group_first,
                              const int64_t* keys, int64_t* out, int64_t m, int64_t B, int64_t n,
                              double offset, double scale, int64_t kmin, int64_t kmax,
                              void* stream) {
  if (m < 0 || keys == nullptr || group_first == nullptr ||
      (F > 1 && stripe_first == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(Search{queries, out, m}, key_kind, top_w, top_kind, top_int, top_table, pivots,
                top_len, route, leaf_ids, rows, S, F, stripe_first, group_first, keys, B, n,
                offset, scale, kmin, kmax, stream);
}

// lo[b], hi[b]: K5's window of block b of the nq sorted queries, kq a
// block (the last may be short), ceil(nq / kq) blocks; leaf_ids, where
// not empty, the leaves of each block's first query, then of each
// block's last.  Arguments as rmi_packed_search's; kq < 1 is refused.
RMI_API int rmi_sorted_bounds(const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, int64_t S, int64_t F, int64_t* lo,
                              int64_t* hi, int64_t nq, int64_t kq, int64_t B, int64_t n,
                              double offset, double scale, int64_t kmin, int64_t kmax,
                              void* stream) {
  if (nq < 0 || kq < 1) return (int)cudaErrorInvalidValue;
  return launch(Bounds{queries, lo, hi, nq, kq, (nq + kq - 1) / kq}, key_kind, top_w, top_kind,
                top_int, top_table, pivots, top_len, route, leaf_ids, rows, S, F, nullptr,
                nullptr, nullptr, B, n, offset, scale, kmin, kmax, stream);
}
