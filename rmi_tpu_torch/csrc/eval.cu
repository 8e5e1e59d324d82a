// K4: clamped integer leaf predictions for linear, cubic, loglinear and
// normal leaves, in two forms.
//
//   rmi_leaf_eval_*   out[i] = clip(floor(leaf(w[leaf[i]], x[i])), 0, bound)
//                     with NaN -> 0: the build's epsilon probes (bound n,
//                     one element per leaf) and lookup's leaf step where
//                     the leaves are lognormal (x = max(ln x, 0)).
//   rmi_lookup_*      lookup(key, &err) whole: from the int64 key image,
//                     the normalized key, the top's leaf (its prediction
//                     clamped to [0, B - 1]), the leaf's prediction
//                     clamped to [0, n - 1] and the leaf's error, for
//                     every affine top and leaf (all but lognormal).
//
// Replaces rmi_tpu/ops/eval_kernel.py:_eval_kernel (leaf_eval_clamped),
// which takes parameter columns that XLA gathered beforehand and
// evaluates them in float-float.  Here the row gather, the evaluation
// and the clamp are one pass, and in rmi_lookup_* the key conversion and
// the top's evaluation too: the eight elementwise passes of as_float, the
// normalization, the top's FMAs and predict_clamped no longer write [m]
// tensors between them.
//
// Bound on the H100: device memory, at 24 bytes a lookup (an 8-byte key
// in, an 8-byte guess and error out) and 20 an element of the per-element
// form (x and a leaf id in, 4 bytes out).  What binds first is L2: each
// random row gather moves whole 32-byte sectors, and random gathers
// through L2 run at 4.6-4.9 TB/s of sectors on an H100 whatever the
// family (tools/tune_torch_eval.py; PERF.md).  So the per-element form
// costs 8 + 8 + 4 streamed bytes plus the sectors of its row (one for
// linear, loglinear and cubic rows, one or two for a 24-byte normal row),
// and lookup gathers each leaf's row and error from one row of a table
// packed for it (lookup_table: the row, the error's bits, padding to
// whole 32-byte sectors: one for all but cubic leaves, two for those).
// Two 16-byte loads of one sector from two instructions may each move
// the sector from L2, depending on how far apart the compiler puts them;
// so lookup reads every sector of a row with ONE instruction: the two
// lanes of a pair (lane, lane ^ 1) each load one 16-byte half of the
// same sector for the pair's four rows, and swap halves with a shuffle.
//
// Each thread takes one 16-byte pair of consecutive elements, which a
// warp reads and writes coalesced through the read-only path, and starts
// the gathers of both elements before any leaf arithmetic, so that their
// latencies, and normal's two f64 divisions, overlap.  A head element
// before the first 16-byte boundary and an odd last element go through
// the same arithmetic one at a time.  The top kind is a kernel argument:
// the branch on it is the same in every thread.
//
// Every value keeps the bits of the plain PyTorch chain: the key image
// converts as keys.as_float does (hi * 2^32 is exact, one rounding in the
// add), then (f - offset) * scale, as two_layer.normalize; the top and
// the leaf are rmi_leaf from leaf_eval.cuh, the function the error sweep
// (sweep.cu) measured the bounds with, and the clamps rmi_clamp_floor.
// The top's row is row 0 of its own table: every affine top model's
// prediction is its leaf kernel's (tests/test_torch_lookup_kernel.py).
#include "common.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <RmiLeaf L>
using Row = double[rmi_leaf_width(L)];

// f64 values of one lookup row: the leaf's row, the bits of its int64
// error, and padding to whole 32-byte sectors (ops/eval_kernel.lookup_table):
// 4 values, one sector, for every leaf family but cubic (8, two sectors)
__host__ __device__ constexpr int lookup_width(RmiLeaf L) {
  return (rmi_leaf_width(L) + 1 + 3) & ~3;
}

template <RmiLeaf L>
using LookupRow = double[lookup_width(L)];

// kW consecutive f64 from p: two per 16-byte load where kW is even (p on
// a 16-byte boundary), else one by one
template <int kW>
__device__ __forceinline__ void load_f64(const double* __restrict__ p, double (&r)[kW]) {
  if constexpr (kW % 2 == 0) {
    const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int h = 0; h < kW / 2; ++h) {
      const double2 a = __ldg(v + h);
      r[2 * h] = a.x;
      r[2 * h + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int h = 0; h < kW; ++h) r[h] = __ldg(p + h);
  }
}

// K elements: every row gathered, then every leaf evaluated and clamped
template <RmiLeaf L, int K>
__device__ __forceinline__ void eval_elems(const double* __restrict__ w,
                                           const double (&x)[K],
                                           const int64_t (&leaf)[K],
                                           double bound, int32_t (&out)[K]) {
  Row<L> r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_f64<rmi_leaf_width(L)>(w + rmi_leaf_width(L) * leaf[k], r[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = rmi_clamp_floor(rmi_leaf<L>(r[k], 0, x[k]), bound);
}

// keys.as_float then two_layer.normalize, on one int64 key image
__device__ __forceinline__ double normalized(int64_t image, double offset, double scale) {
  const uint64_t u = (uint64_t)image ^ 0x8000000000000000ull;
  const double f = (double)(u >> 32) * 4294967296.0 + (double)(u & 0xffffffffull);
  return (f - offset) * scale;
}

// The scalar ends and the 16-byte pairs between them.  Elements [0, head)
// lie before the first 16-byte boundary (head is 0 or 1); pair p < npairs
// holds elements head + 2p and head + 2p + 1; an odd last element follows
// them.  Block 0's threads 0 and 1 take the two ends; thread t of block b
// takes pair b * kThreads + t, and a block's threads all run the same
// passes, those past npairs too (op.pair stores nothing for them), so
// that every lane of a warp reaches op.pair's shuffles.
template <class Op>
__device__ __forceinline__ void walk(const Op& op, int64_t m, int head) {
  const int64_t npairs = (m - head) >> 1;
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    const int64_t i = threadIdx.x == 0 ? (head ? 0 : m) : head + 2 * npairs;
    if (i < m) op.one(i);
  }
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < npairs;
       base += (int64_t)gridDim.x * kThreads) {
    op.pair(base + threadIdx.x, npairs);
  }
}

// --- the per-element form ----------------------------------------------------

template <RmiLeaf L>
struct LeafEvalOp {
  const double* x;
  const double* w;
  const int64_t* leaf;
  int32_t* out;
  double bound;
  int head;

  __device__ __forceinline__ void one(int64_t i) const {
    const double xi[1] = {__ldg(x + i)};
    const int64_t li[1] = {__ldg(leaf + i)};
    int32_t o[1];
    eval_elems<L, 1>(w, xi, li, bound, o);
    out[i] = o[0];
  }

  __device__ __forceinline__ void pair(int64_t p, int64_t npairs) const {
    const bool ok = p < npairs;
    const double2 a = ok ? __ldg(reinterpret_cast<const double2*>(x + head) + p)
                         : make_double2(0.0, 0.0);
    const longlong2 b = ok ? __ldg(reinterpret_cast<const longlong2*>(leaf + head) + p)
                           : make_longlong2(0, 0);
    const double xs[2] = {a.x, a.y};
    const int64_t ls[2] = {b.x, b.y};
    int32_t o[2];
    eval_elems<L, 2>(w, xs, ls, bound, o);
    if (ok) reinterpret_cast<int2*>(out + head)[p] = make_int2(o[0], o[1]);
  }
};

template <RmiLeaf L>
__global__ void __launch_bounds__(kThreads)
leaf_eval(const LeafEvalOp<L> op, int64_t m) {
  walk(op, m, op.head);
}

// --- lookup --------------------------------------------------------------------

template <RmiLeaf L>
struct LookupOp {
  static constexpr int kW = lookup_width(L);
  static constexpr int kS = kW / 4;        // 32-byte sectors a lookup row

  const int64_t* keys;
  const double* top_w;    // [1, width]: the top's row
  const double* rows;     // [B, kW]: row and error of each leaf
  int64_t* guess;
  int64_t* err;
  double offset, scale;
  double top_bound;       // B - 1
  double guess_bound;     // n - 1
  RmiLeaf top;            // the top's leaf kernel, whose rmi_leaf evaluates it
  int head;

  // the leaves of K normalized keys under a top of kind T
  template <RmiLeaf T, int K>
  __device__ __forceinline__ void leaves_of(const double (&x)[K], int64_t (&leaf)[K]) const {
    Row<T> r;
    load_f64<rmi_leaf_width(T)>(top_w, r);
#pragma unroll
    for (int k = 0; k < K; ++k) leaf[k] = rmi_clamp_floor(rmi_leaf<T>(r, 0, x[k]), top_bound);
  }

  template <int K>
  __device__ __forceinline__ void leaves(const double (&x)[K], int64_t (&leaf)[K]) const {
    switch (top) {
      case RmiLeaf::kCubic: leaves_of<RmiLeaf::kCubic>(x, leaf); break;
      case RmiLeaf::kLoglinear: leaves_of<RmiLeaf::kLoglinear>(x, leaf); break;
      case RmiLeaf::kNormal: leaves_of<RmiLeaf::kNormal>(x, leaf); break;
      default: leaves_of<RmiLeaf::kLinear>(x, leaf); break;
    }
  }

  // K leaves evaluated on their rows: guesses and errors
  template <int K>
  __device__ __forceinline__ void finish(LookupRow<L> (&r)[K], const double (&x)[K],
                                         int64_t (&g)[K], int64_t (&e)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k] = __double_as_longlong(r[k][rmi_leaf_width(L)]);
      g[k] = rmi_clamp_floor(rmi_leaf<L>(r[k], 0, x[k]), guess_bound);
    }
  }

  __device__ __forceinline__ void one(int64_t i) const {
    const double x[1] = {normalized(__ldg(keys + i), offset, scale)};
    int64_t leaf[1];
    leaves(x, leaf);
    LookupRow<L> r[1];
    load_f64<kW>(rows + kW * leaf[0], r[0]);
    int64_t g[1], e[1];
    finish(r, x, g, e);
    guess[i] = g[0];
    err[i] = e[0];
  }

  // This lane's two rows, with one instruction per sector: the pair's
  // four rows are the even lane's two leaves, then the odd lane's; for
  // each row and sector the even lane loads the sector's first 16 bytes
  // and the odd lane its second, and each lane then sends the partner the
  // halves of the partner's rows.  Every lane of the warp takes part.
  __device__ __forceinline__ void load_rows(const int64_t (&leaf)[2],
                                            LookupRow<L> (&r)[2]) const {
    const int odd = threadIdx.x & 1;
    int64_t four[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t other = __shfl_xor_sync(RMI_FULL_MASK, leaf[k], 1);
      four[k] = odd ? other : leaf[k];
      four[2 + k] = odd ? leaf[k] : other;
    }
    double2 h[4][kS];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const double2* row = reinterpret_cast<const double2*>(rows + kW * four[q]);
#pragma unroll
      for (int s = 0; s < kS; ++s) h[q][s] = __ldg(row + 2 * s + odd);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const double2 mine = odd ? h[2 + k][s] : h[k][s];
        const double2 send = odd ? h[k][s] : h[2 + k][s];
        double2 got;
        got.x = __shfl_xor_sync(RMI_FULL_MASK, send.x, 1);
        got.y = __shfl_xor_sync(RMI_FULL_MASK, send.y, 1);
        const double2 lo = odd ? got : mine, hi = odd ? mine : got;
        r[k][4 * s] = lo.x;
        r[k][4 * s + 1] = lo.y;
        r[k][4 * s + 2] = hi.x;
        r[k][4 * s + 3] = hi.y;
      }
    }
  }

  __device__ __forceinline__ void pair(int64_t p, int64_t npairs) const {
    const bool ok = p < npairs;
    const longlong2 v = ok ? __ldg(reinterpret_cast<const longlong2*>(keys + head) + p)
                           : make_longlong2(0, 0);
    const double x[2] = {normalized(v.x, offset, scale), normalized(v.y, offset, scale)};
    int64_t leaf[2];
    leaves(x, leaf);
    LookupRow<L> r[2];
    load_rows(leaf, r);
    int64_t g[2], e[2];
    finish(r, x, g, e);
    if (ok) {
      reinterpret_cast<longlong2*>(guess + head)[p] = make_longlong2(g[0], g[1]);
      reinterpret_cast<longlong2*>(err + head)[p] = make_longlong2(e[0], e[1]);
    }
  }
};

template <RmiLeaf L>
__global__ void __launch_bounds__(kThreads)
lookup(const LookupOp<L> op, int64_t m) {
  walk(op, m, op.head);
}

// 0 or 1: elements of 8 bytes before the first 16-byte boundary
inline int head_of(const void* p) { return ((uintptr_t)p & 15) ? 1 : 0; }

inline unsigned int blocks_for(int64_t m) {
  return rmi_grid(m / 2 + 1, kThreads);
}

template <RmiLeaf L>
int launch_leaf_eval(const double* x, const double* w, const int64_t* leaf,
                     int32_t* out, int64_t m, int64_t bound, void* stream) {
  const int head = head_of(x);
  // x and leaf on one 16-byte phase, out + head on an 8-byte boundary, the
  // table on a 16-byte boundary (ops/eval_kernel.py allocates out so)
  if (head_of(leaf) != head || ((uintptr_t)(out + head) & 7) || ((uintptr_t)w & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (m > 0) {
    const LeafEvalOp<L> op{x, w, leaf, out, (double)bound, head};
    leaf_eval<L><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(op, m);
  }
  return (int)cudaGetLastError();
}

template <RmiLeaf L>
int launch_lookup(const int64_t* keys, const double* top_w, int64_t top_kind,
                  const double* rows, int64_t* guess, int64_t* err, int64_t m,
                  int64_t B, int64_t n, double offset, double scale, void* stream) {
  if (top_kind < 0 || top_kind > (int64_t)RmiLeaf::kNormal || B < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int head = head_of(keys);
  // guess and err on the keys' 16-byte phase, the rows and the top's row
  // on 16-byte boundaries
  if (head_of(guess) != head || head_of(err) != head || ((uintptr_t)rows & 15) ||
      ((uintptr_t)top_w & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (m > 0) {
    const LookupOp<L> op{keys, top_w, rows, guess, err, offset, scale, (double)(B - 1),
                         (double)(n - 1), (RmiLeaf)top_kind, head};
    lookup<L><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(op, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define RMI_LEAF_EVAL_ENTRY(name, L)                                                  \
  RMI_API int rmi_leaf_eval_##name(const double* x, const double* w,                  \
                                   const int64_t* leaf, int32_t* out, int64_t m,      \
                                   int64_t bound, void* stream) {                     \
    return launch_leaf_eval<L>(x, w, leaf, out, m, bound, stream);                    \
  }

// guess[i], err[i] of key image keys[i]; top_kind the RmiLeaf of the top's
// leaf kernel, top_w its [1, width] row; rows the [B, lookup_width] lookup
// rows of the leaves; offset and scale the normalization, n the keys
// indexed
#define RMI_LOOKUP_ENTRY(name, L)                                                     \
  RMI_API int rmi_lookup_##name(const int64_t* keys, const double* top_w,             \
                                int64_t top_kind, const double* rows, int64_t* guess, \
                                int64_t* err, int64_t m, int64_t B, int64_t n,        \
                                double offset, double scale, void* stream) {          \
    return launch_lookup<L>(keys, top_w, top_kind, rows, guess, err, m, B, n, offset, \
                            scale, stream);                                           \
  }

RMI_LEAF_EVAL_ENTRY(linear, RmiLeaf::kLinear)
RMI_LEAF_EVAL_ENTRY(cubic, RmiLeaf::kCubic)
RMI_LEAF_EVAL_ENTRY(loglinear, RmiLeaf::kLoglinear)
RMI_LEAF_EVAL_ENTRY(normal, RmiLeaf::kNormal)
RMI_LOOKUP_ENTRY(linear, RmiLeaf::kLinear)
RMI_LOOKUP_ENTRY(cubic, RmiLeaf::kCubic)
RMI_LOOKUP_ENTRY(loglinear, RmiLeaf::kLoglinear)
RMI_LOOKUP_ENTRY(normal, RmiLeaf::kNormal)
