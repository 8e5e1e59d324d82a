// The packed plan's search and K5's window bounds (ops/packed_kernel.py;
// packed_search_plain and sorted_bounds_plain are the plain versions).
//
//   rmi_packed_search  out[i] = #(keys < queries[i]), the exact lower
//                      bound, through the plan's leaf rows: the query,
//                      clipped to [kmin, kmax], routed through the top to
//                      its leaf; the leaf row's count c1 of samples below
//                      it gives LB1 = base + (c1 - 1) F, a lower limit of
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
// Bound on the H100: a query needs its image read and its answer written
// (16 B) and the sectors that decide it: its leaf row's (path 1's rows,
// 33.5 MB, and their bases, 2 MB, live in L2 for the most part), the wide
// plan's stripe-first keys around lb1, and the keys around lb, which lie
// in device memory (1.6 GB at 200M keys).  Device memory serves ~3e10
// random 32-byte sectors a second, so the sectors of device memory a
// query reads, and the dependent rounds it waits for them, set the time.
// The design before this one read the row by halving steps (2-3 rounds
// in L2) and the stripe through K5's sample level keys[::8] (64 bytes)
// and then one 8-key group (64 bytes): four sectors of device memory in
// two dependent rounds, ~3.4e10 sectors a second on path 1.  This one:
//   - the row in one round: the samples of a row are padded to an even
//     count Sp (plan.rows, [B, Sp], IMAGE_MAX past S) on 16-byte
//     boundaries, the base kept apart (plan.base, [B]); a row of up to 16
//     samples (path 1's: 128 bytes, one L2 line) is read whole beside its
//     base; a longer one (path 5's ~50) reads the last sample of each
//     16-sample chunk first, then the one chunk that holds c1 (two rounds);
//   - every count after it knows a bracket (p, r] around its answer, with
//     the values at the ends it knows: the row's samples on either side
//     of q are the stripe's first key and the next stripe's first key
//     (F = 1), or the stripe-first keys at LB1 and LB1 + F (F > 1), then
//     those around lb1 the stripe's;
//   - each read is the aligned 64-byte block (kBlock entries, placed by
//     the array's address, so a view off a 16-byte boundary reads whole
//     blocks too) that holds one chosen entry, and every entry of it
//     inside the bracket narrows it; with both ends' values known the
//     entry is placed where they put q (interpolation, the differences
//     from the lower end taken as u64, exact, then rounded: a u32 key's
//     image lies near -2^63, where a double's step is 2048; the ends
//     never equal, since lov < q <= hiv), at most kInterpRounds times,
//     then in the middle (halving by blocks), the last block read whole;
//   - the keys' blocks are loaded with an L2 evict_first policy: read
//     once a query, they leave L2 before the rows do;
//   - a thread a query, a grid-stride loop over the batch.
// On books-like keys one block decides the stripe for 65% of queries:
// path 1's query reads 2.71 sectors of device memory in 1.36 rounds after
// its row's one, where the design before read 4 in 2 after 2.45 (tools/
// count_torch_packed_reads.py, a host mirror of this search at 2^24 keys).
// Timed on the card (PERF.md §6), 32-byte blocks (1.72 sectors, 1.72
// rounds) took as long and 128-byte ones (4.64, 1.16) longer: a read costs
// by its count and its bytes both.
#include "common.cuh"
#include "int_top.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kStripe = 64;        // keys a stripe (lookup_fast.STRIDE)
constexpr int64_t kWidth = 128;        // stripe-first keys of the wide plan's count
constexpr int64_t kMaxSamples = 127;   // samples a leaf row (rmi_tpu's 255 u32 lanes)
constexpr int64_t kMaxSpacing = 64;    // stripes between samples (_WIDE_MAX_STRIDE)
constexpr int kChunk = 16;             // samples a row read: 128 bytes
constexpr int kMaxPivots = (kMaxSamples + 1) / kChunk - 1;   // chunks' last samples read first
constexpr int kBlock = 8;              // entries a read of the keys or stripe-first keys
constexpr int kInterpRounds = 3;       // interpolated reads in a count, then the middle

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// What a count knows: its answer, the first j with a[j] >= q, lies in
// (p, r]; a[p] < q with value lov where has_lo, a[r] >= q with value hiv
// where has_hi.  An end not read is the run's edge, never read.
struct Bracket {
  int64_t p, r, lov, hiv;
  bool has_lo, has_hi;

  // narrowed by entry j of value v, where j lies inside
  __device__ __forceinline__ void narrow(int64_t j, int64_t v, int64_t q) {
    if (j > p && j < r) {
      if (v < q) {
        p = j;
        lov = v;
        has_lo = true;
      } else {
        r = j;
        hiv = v;
        has_hi = true;
      }
    }
  }
};

// the first entry of the kBlock-entry block that holds a[j], by its
// address (a is 8-byte aligned)
__device__ __forceinline__ int64_t block_of(const int64_t* a, int64_t j) {
  const int64_t off = (int64_t)((reinterpret_cast<uintptr_t>(a) >> 3) & (kBlock - 1));
  return ((j + off) & ~(int64_t)(kBlock - 1)) - off;
}

// a 16-byte load whose line L2 evicts first (kOnce: the keys, read once
// a query, so that the rows stay in L2), else an ordinary read-only one
template <bool kOnce>
__device__ __forceinline__ longlong2 load2(const longlong2* p, uint64_t policy) {
  if constexpr (!kOnce) return __ldg(p);
  longlong2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.s64 {%0, %1}, [%2], %3;"
               : "=l"(v.x), "=l"(v.y) : "l"(p), "l"(policy));
  return v;
}

// b narrowed to r = p + 1 over a[0 : len), sorted there: each round reads
// the block that holds the entries left where one does, else the one
// where the ends' values place q (kInterpRounds at most), else the middle
// one; a block that crosses a's ends reads the entries inside only
template <bool kOnce>
__device__ __forceinline__ void finish(const int64_t* __restrict__ a, int64_t len, int64_t q,
                                       Bracket& b) {
  uint64_t policy = 0;
  if constexpr (kOnce) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  }
  int rounds = kInterpRounds;
#pragma unroll 1
  while (b.r - b.p > 1) {
    const int64_t first = b.p + 1, last = b.r - 1;
    int64_t j;
    if (block_of(a, first) == block_of(a, last)) {
      j = first;
    } else if (b.has_lo && b.has_hi && rounds > 0) {
      --rounds;
      double f = (double)((uint64_t)q - (uint64_t)b.lov) /
                 (double)((uint64_t)b.hiv - (uint64_t)b.lov);
      f = fmin(fmax(f, 0.0), 1.0);
      j = first + (int64_t)(f * (double)(b.r - b.p - 1));
      j = j > last ? last : j;
    } else {
      j = b.p + ((b.r - b.p) >> 1);
    }
    const int64_t s = block_of(a, j);
    int64_t v[kBlock];
    if (s >= 0 && s + kBlock <= len) {
      const longlong2* p2 = reinterpret_cast<const longlong2*>(a + s);
#pragma unroll
      for (int h = 0; h < kBlock / 2; ++h) {
        const longlong2 t = load2<kOnce>(p2 + h, policy);
        v[2 * h] = t.x;
        v[2 * h + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int t = 0; t < kBlock; ++t) v[t] = s + t >= 0 && s + t < len ? __ldg(a + s + t) : 0;
    }
#pragma unroll
    for (int t = 0; t < kBlock; ++t) b.narrow(s + t, v[t], q);
  }
}

// The row's count: c1 = #(row[0 : Sp] < q) as the bracket (c1 - 1, c1]
// with the samples on either side where the row holds them.  A row of
// Sp <= kChunk samples is read whole; a longer one reads the last sample
// of each chunk but the last first, then the chunk that holds c1.  The
// row lies on a 16-byte boundary and Sp is even.
__device__ __forceinline__ Bracket count_row(const int64_t* __restrict__ row, int64_t Sp,
                                             int64_t q) {
  Bracket b{-1, Sp, 0, 0, false, false};
  int64_t at = 0;
  if (Sp > kChunk) {
    const int64_t chunks = (Sp + kChunk - 1) / kChunk;
    int64_t v[kMaxPivots];
#pragma unroll
    for (int k = 0; k < kMaxPivots; ++k) {
      v[k] = k < chunks - 1 ? __ldg(row + (int64_t)kChunk * k + kChunk - 1) : INT64_MAX;
    }
#pragma unroll
    for (int k = 0; k < kMaxPivots; ++k) b.narrow((int64_t)kChunk * k + kChunk - 1, v[k], q);
    at = b.p + 1;
  }
  const longlong2* p2 = reinterpret_cast<const longlong2*>(row + at);
  const int64_t len = Sp - at < kChunk ? Sp - at : kChunk;
  int64_t v[kChunk];
#pragma unroll
  for (int h = 0; h < kChunk / 2; ++h) {
    if (2 * h < len) {
      const longlong2 t = __ldg(p2 + h);
      v[2 * h] = t.x;
      v[2 * h + 1] = t.y;
    } else {
      v[2 * h] = v[2 * h + 1] = INT64_MAX;
    }
  }
#pragma unroll
  for (int t = 0; t < kChunk; ++t) b.narrow(at + t, v[t], q);
  return b;
}

// The plan the counts read, and the clipping of the routed query
struct Plan {
  const int64_t* rows;           // [B, Sp]: S samples, IMAGE_MAX past them
  const int64_t* bases;          // [B]: each row's stripe base
  int64_t S, Sp, F;
  const int64_t* stripe_first;   // keys[::64], nrows0 of them
  const int64_t* keys;
  int64_t n, nrows0;
  int64_t kmin, kmax;

  // the row of `leaf` counted at q, and LB1 = base + (c1 - 1) F
  __device__ __forceinline__ Bracket row_count(int64_t leaf, int64_t q, int64_t& LB1) const {
    const int64_t base = __ldg(bases + leaf);
    const Bracket rb = count_row(rows + leaf * Sp, Sp, q);
    LB1 = base + (rb.r - 1) * F;
    return rb;
  }

  __device__ __forceinline__ int64_t lb1(int64_t leaf, int64_t q) const {
    int64_t LB1;
    row_count(leaf, q, LB1);
    return LB1;
  }

  // the lower bound of q routed to `leaf` (lookup_fast._packed_search):
  // the bracket of lb1 over the stripe-first keys, then the stripe's
  // over the keys.  Row sample c1 - 1 is stripe-first key LB1 and sample
  // c1 stripe-first key LB1 + F where c1 < S and LB1 + F < nrows0 (a
  // sample past S or past n holds IMAGE_MAX, no key)
  __device__ __forceinline__ int64_t search(int64_t leaf, int64_t q) const {
    int64_t LB1;
    const Bracket rb = row_count(leaf, q, LB1);
    const bool hi_known = rb.has_hi && rb.r < S && LB1 + F < nrows0;
    Bracket sb;
    if (F == 1) {   // lb1 - 1 <= LB1 <= lb1: the stripe is LB1's
      sb = {LB1, LB1 + 1, rb.lov, rb.hiv, rb.has_lo, hi_known};
    } else {        // the plain version's window of 128 stripe-first keys
      const int64_t r1 = clamp64(LB1, 0, nrows0) >> 6;
      sb = {r1 * kStripe - 1, r1 * kStripe + kWidth < nrows0 ? r1 * kStripe + kWidth : nrows0,
            0, 0, false, false};
      if (rb.has_lo) sb.narrow(LB1, rb.lov, q);
      if (hi_known) sb.narrow(LB1 + F, rb.hiv, q);
      finish<false>(stripe_first, nrows0, q, sb);
    }
    const int64_t row = clamp64((sb.r < nrows0 ? sb.r : nrows0) - 1, 0, nrows0 - 1);
    const int64_t end = row * kStripe + kStripe;
    Bracket kb{row * kStripe - 1, end < n ? end : n, 0, 0, false, false};
    if (sb.has_lo && sb.p == row) {
      kb.p = row * kStripe;
      kb.lov = sb.lov;
      kb.has_lo = true;
    }
    if (sb.has_hi && sb.r == row + 1) {
      kb.hiv = sb.hiv;
      kb.has_hi = true;
    }
    finish<true>(keys, n, q, kb);
    return kb.r;
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
    out[i] = p.search(top.leaf(i, clamp64(q, p.kmin, p.kmax)), q);
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
// kmax, rows and bases given, the rows on a 16-byte boundary; the counts'
// arrays, which only the search reads, its caller checks), and the top:
// given leaf ids, or an affine top's row (route 0), or an integer top by
// a route it can take other than the folded one (rmi_int_route_ok; smem
// the bytes a block stages).  Items of work only when all hold.
template <class Work>
int launch(const Work& w, int64_t key_kind, const double* top_w, int64_t top_kind,
           const int64_t* top_int, const int32_t* top_table, const int64_t* pivots,
           int64_t top_len, int64_t route, const int64_t* leaf_ids, const int64_t* rows,
           const int64_t* bases, int64_t S, int64_t F, const int64_t* stripe_first,
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
      (F & (F - 1)) != 0 || kmin > kmax || rows == nullptr || bases == nullptr ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0 ||
      (key_kind != (int64_t)RmiKey::kU64 && key_kind != (int64_t)RmiKey::kF64)) {
    return (int)cudaErrorInvalidValue;
  }
  if (w.items() == 0) return (int)cudaGetLastError();
  const Plan p{rows, bases, S, (S + 1) & ~(int64_t)1, F, stripe_first, keys, n,
               (n + kStripe - 1) / kStripe, kmin, kmax};
  const TopArgs a{top_w, top_kind, int_top, leaf_ids, offset, scale};
  const cudaError_t e = key_kind == (int64_t)RmiKey::kF64
                            ? start_by_top<Work, RmiKey::kF64>(w, p, a, route, smem, stream)
                            : start_by_top<Work, RmiKey::kU64>(w, p, a, route, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// out[i]: the lower bound of queries[i] in keys[0 : n] through the plan
// (its leaf rows [B, Sp] of S samples, Sp = S rounded up to even, on a
// 16-byte boundary, their bases [B], sample spacing F, stripe-first keys
// of ceil(n / 64) entries, routing domain [kmin, kmax]), the query routed
// as key_kind and the top say (rmi_lookup_*'s top arguments; a folded
// route refused), or by leaf_ids[i] where leaf_ids is not empty.  A
// count, a top or a plan it cannot take is refused with
// cudaErrorInvalidValue.
RMI_API int rmi_packed_search(const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, const int64_t* bases, int64_t S, int64_t F,
                              const int64_t* stripe_first, const int64_t* keys, int64_t* out,
                              int64_t m, int64_t B, int64_t n, double offset, double scale,
                              int64_t kmin, int64_t kmax, void* stream) {
  if (m < 0 || keys == nullptr || (F > 1 && stripe_first == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(Search{queries, out, m}, key_kind, top_w, top_kind, top_int, top_table, pivots,
                top_len, route, leaf_ids, rows, bases, S, F, stripe_first, keys, B, n, offset,
                scale, kmin, kmax, stream);
}

// lo[b], hi[b]: K5's window of block b of the nq sorted queries, kq a
// block (the last may be short), ceil(nq / kq) blocks; leaf_ids, where
// not empty, the leaves of each block's first query, then of each
// block's last.  Arguments as rmi_packed_search's; kq < 1 is refused.
RMI_API int rmi_sorted_bounds(const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, const int64_t* bases, int64_t S, int64_t F,
                              int64_t* lo, int64_t* hi, int64_t nq, int64_t kq, int64_t B,
                              int64_t n, double offset, double scale, int64_t kmin, int64_t kmax,
                              void* stream) {
  if (nq < 0 || kq < 1) return (int)cudaErrorInvalidValue;
  return launch(Bounds{queries, lo, hi, nq, kq, (nq + kq - 1) / kq}, key_kind, top_w, top_kind,
                top_int, top_table, pivots, top_len, route, leaf_ids, rows, bases, S, F, nullptr,
                nullptr, B, n, offset, scale, kmin, kmax, stream);
}
