// K4: clamped integer leaf predictions for linear, cubic, loglinear and
// normal leaves, in two forms.
//
//   rmi_leaf_eval_*   out[i] = clip(floor(leaf(w[leaf[i]], x[i])), 0, bound)
//                     with NaN -> 0: the build's epsilon probes (bound n,
//                     one element per leaf) and lookup's leaf step where
//                     the leaves are lognormal (x = max(ln x, 0)).
//   rmi_lookup_*      lookup(key, &err) whole: from the int64 key image,
//                     the top's leaf (its prediction clamped to
//                     [0, B - 1]), the leaf's prediction on the normalized
//                     key clamped to [0, n - 1] and the leaf's error, for
//                     every top but lognormal (the affine ones and the
//                     integer-output ones) over every affine leaf.
//
// Replaces rmi_tpu/ops/eval_kernel.py:_eval_kernel (leaf_eval_clamped),
// which takes parameter columns that XLA gathered beforehand and
// evaluates them in float-float; rmi_tpu's lookup is one jax.jit program
// around it (rmi_tpu/lookup.py:39-63, _rmi_eval; the df64 form
// _rmi_eval_df64 :162-190).  Here the row gather, the evaluation and the
// clamp are one pass, and in rmi_lookup_* the key conversion and the
// top's evaluation too: the eight elementwise passes of as_float, the
// normalization, the top's FMAs and predict_clamped, or an integer top's
// ~25 torch launches, no longer write [m] tensors between them.
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
// the branch on it is the same in every thread.  The key kind is a
// template parameter, so the u64 instantiation is the decode it always
// was and the f64 one adds no branch.
//
// An integer-output top (int_top.cuh) reads the key's u64 bits, of an
// f64 key keys.as_int of its value, while the leaf reads the normalized
// key: the kernel decodes each key both ways.  Its parameters come packed
// in one small int64 tensor, beside a hint table's entries or a
// histogram's pivots, and it has a kernel of its own, int_lookup, so the
// affine tops' kernels carry no integer branch.  What binds that kernel
// is L2's rate of random 32-byte sectors (PERF.md §6): a hint-table entry
// read through L2 costs a sector of its own before the leaf's row, and
// the histogram's halving steps (log2 of the pivots a key) mostly miss L1
// within a warp.  So the caller's route (ops/eval_kernel.top_route, from
// the operand's size alone) takes the operand out of L2 where it can:
//   - a hint table whose rows fit 16 MB is folded into them: the caller
//     passes one lookup row a bucket, the row of the leaf its entry names,
//     and the key's bucket is its row, one sector a key as under an
//     affine top (path 5: 8 MB of rows for a 2^18-entry table);
//   - a histogram's pivots are staged in each block's shared memory as a
//     complete search tree, a step a level, no L1 miss;
//   - the rest is read in place: a hint table narrowed to 16-bit entries
//     (32 where B > 2^16), radix and bradix reading no operand.
// The staged and folded routes run a persistent grid, the blocks
// resident at once staging once and each thread loading its next round's
// keys before this round's reads; in place, a block takes one round.
// The bound adds the table or the pivots once a call.
//
// Every value keeps the bits of the plain PyTorch chain: the key image
// converts as keys.as_float does (of a u64 key hi * 2^32 is exact, one
// rounding in the add; of an f64 key the sign fix undone and the bits
// reinterpreted, no arithmetic), then (f - offset) * scale, as
// two_layer.normalize; the top and
// the leaf are rmi_leaf from leaf_eval.cuh, the function the error sweep
// (sweep.cu) measured the bounds with, and the clamps rmi_clamp_floor.
// The top's row is row 0 of its own table: every affine top model's
// prediction is its leaf kernel's (tests/test_torch_lookup_kernel.py).
// The integer tops are the torch code of models/radix.py and
// models/histogram.py, bit for bit (int_top.cuh).
#include "common.cuh"
#include "int_top.cuh"
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

// A lookup's leaf step over its rows (ops/eval_kernel.lookup_table): each
// leaf's row and error gathered, the leaf evaluated on the normalized key
// and clamped to [0, n - 1]
template <RmiLeaf L>
struct LeafRows {
  static constexpr int kW = lookup_width(L);
  static constexpr int kS = kW / 4;        // 32-byte sectors a lookup row

  const double* rows;     // [B, kW]: row and error of each leaf
  double guess_bound;     // n - 1

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

  __device__ __forceinline__ void load_one(int64_t leaf, LookupRow<L>& r) const {
    load_f64<kW>(rows + kW * leaf, r);
  }

  // This lane's K rows, with one instruction per sector: the pair's 2K
  // rows are the even lane's K leaves, then the odd lane's; for each row
  // and sector the even lane loads the sector's first 16 bytes and the odd
  // lane its second, and each lane then sends the partner the halves of
  // the partner's rows.  Every lane of the warp takes part.
  template <int K>
  __device__ __forceinline__ void load(const int64_t (&leaf)[K], LookupRow<L> (&r)[K]) const {
    const int odd = threadIdx.x & 1;
    int64_t both[2 * K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t other = __shfl_xor_sync(RMI_FULL_MASK, leaf[k], 1);
      both[k] = odd ? other : leaf[k];
      both[K + k] = odd ? leaf[k] : other;
    }
    double2 h[2 * K][kS];
#pragma unroll
    for (int q = 0; q < 2 * K; ++q) {
      const double2* row = reinterpret_cast<const double2*>(rows + kW * both[q]);
#pragma unroll
      for (int s = 0; s < kS; ++s) h[q][s] = __ldg(row + 2 * s + odd);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const double2 mine = odd ? h[K + k][s] : h[k][s];
        const double2 send = odd ? h[k][s] : h[K + k][s];
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
};

// lookup under an affine top: its leaf kernel's rmi_leaf on row 0 of its
// own table; the integer tops have a kernel of their own (int_lookup), so
// that these carry no integer branch (in one body it cost them registers
// and a stack frame)
template <RmiLeaf L, RmiKey KK>
struct LookupOp {
  const int64_t* keys;
  const double* top_w;    // [1, width]: the top's row
  LeafRows<L> step;
  int64_t* guess;
  int64_t* err;
  double offset, scale;
  double top_bound;       // B - 1
  int64_t top;            // the top kind: the top's leaf kernel (RmiLeaf)
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
      case (int64_t)RmiLeaf::kCubic: leaves_of<RmiLeaf::kCubic>(x, leaf); break;
      case (int64_t)RmiLeaf::kLoglinear: leaves_of<RmiLeaf::kLoglinear>(x, leaf); break;
      case (int64_t)RmiLeaf::kNormal: leaves_of<RmiLeaf::kNormal>(x, leaf); break;
      default: leaves_of<RmiLeaf::kLinear>(x, leaf); break;
    }
  }

  __device__ __forceinline__ void one(int64_t i) const {
    const double x[1] = {normalized<KK>(__ldg(keys + i), offset, scale)};
    int64_t leaf[1];
    leaves(x, leaf);
    LookupRow<L> r[1];
    step.load_one(leaf[0], r[0]);
    int64_t g[1], e[1];
    step.finish(r, x, g, e);
    guess[i] = g[0];
    err[i] = e[0];
  }

  __device__ __forceinline__ void pair(int64_t p, int64_t npairs) const {
    const bool ok = p < npairs;
    const longlong2 v = ok ? __ldg(reinterpret_cast<const longlong2*>(keys + head) + p)
                           : make_longlong2(0, 0);
    const double x[2] = {normalized<KK>(v.x, offset, scale),
                         normalized<KK>(v.y, offset, scale)};
    int64_t leaf[2];
    leaves(x, leaf);
    LookupRow<L> r[2];
    step.load(leaf, r);
    int64_t g[2], e[2];
    step.finish(r, x, g, e);
    if (ok) {
      reinterpret_cast<longlong2*>(guess + head)[p] = make_longlong2(g[0], g[1]);
      reinterpret_cast<longlong2*>(err + head)[p] = make_longlong2(e[0], e[1]);
    }
  }
};

template <RmiLeaf L, RmiKey KK>
__global__ void __launch_bounds__(kThreads)
lookup(const LookupOp<L, KK> op, int64_t m) {
  walk(op, m, op.head);
}

// lookup under an integer top (int_top.cuh).  Each round a thread takes
// int_pairs 16-byte pairs of keys int_threads pairs apart, so that their
// top reads, then their row reads, are in flight together.  Read in
// place, a block takes one round (the grid covers the batch) in the
// geometry of the affine tops' kernel, a pair a thread; staged in a block
// or folded into the rows, the grid is persistent: the blocks resident at
// once stage the operand once and loop over the rounds, each thread
// loading its next round's keys before this round's reads, two pairs a
// thread where a lookup row is one sector (one for cubic leaves, whose
// two-sector rows would cost the registers).
constexpr int kStagedThreads = 512;

template <RmiRoute R>
__host__ __device__ constexpr int int_threads() {
  return R == RmiRoute::kInPlace ? kThreads : kStagedThreads;
}

template <RmiLeaf L, RmiRoute R>
__host__ __device__ constexpr int int_pairs() {
  return R != RmiRoute::kInPlace && lookup_width(L) == 4 ? 2 : 1;
}

template <RmiLeaf L, RmiKey KK, RmiRoute R>
struct IntLookupOp {
  static constexpr int T = int_threads<R>();
  static constexpr int P = int_pairs<L, R>();

  const int64_t* keys;
  RmiIntTopArgs top;
  LeafRows<L> step;       // under a folded table, one row a bucket
  int64_t* guess;
  int64_t* err;
  double offset, scale;
  int head;

  // the keys of pairs first, first + T, ... (0 past npairs)
  __device__ __forceinline__ void load_keys(int64_t first, int64_t npairs,
                                            longlong2 (&v)[P]) const {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int64_t p = first + (int64_t)j * T;
      v[j] = p < npairs ? __ldg(reinterpret_cast<const longlong2*>(keys + head) + p)
                        : make_longlong2(0, 0);
    }
  }

  // the leaves of K keys (images), and their normalized values
  template <int K>
  __device__ __forceinline__ void leaves(const RmiIntTopEval& t, const int64_t* tree,
                                         const int64_t (&image)[K], double (&x)[K],
                                         int64_t (&leaf)[K]) const {
    uint64_t u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = normalized<KK>(image[k], offset, scale);
      u[k] = int_bits<KK>(image[k]);
    }
    t.leaves<R>(u, tree, leaf);
  }

  __device__ __forceinline__ void one(const RmiIntTopEval& t, const int64_t* tree,
                                      int64_t i) const {
    const int64_t image[1] = {__ldg(keys + i)};
    double x[1];
    int64_t leaf[1];
    leaves(t, tree, image, x, leaf);
    LookupRow<L> r[1];
    step.load_one(leaf[0], r[0]);
    int64_t g[1], e[1];
    step.finish(r, x, g, e);
    guess[i] = g[0];
    err[i] = e[0];
  }

  // the pairs of load_keys(first): those past npairs store nothing
  __device__ __forceinline__ void round(const RmiIntTopEval& t, const int64_t* tree,
                                        const longlong2 (&v)[P], int64_t first,
                                        int64_t npairs) const {
    int64_t image[2 * P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      image[2 * j] = v[j].x;
      image[2 * j + 1] = v[j].y;
    }
    double x[2 * P];
    int64_t leaf[2 * P];
    leaves(t, tree, image, x, leaf);
    LookupRow<L> r[2 * P];
    step.load(leaf, r);
    int64_t g[2 * P], e[2 * P];
    step.finish(r, x, g, e);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int64_t p = first + (int64_t)j * T;
      if (p < npairs) {
        reinterpret_cast<longlong2*>(guess + head)[p] = make_longlong2(g[2 * j], g[2 * j + 1]);
        reinterpret_cast<longlong2*>(err + head)[p] = make_longlong2(e[2 * j], e[2 * j + 1]);
      }
    }
  }
};

// The ends and the pairs as walk takes them: the blocks take rounds of
// int_threads * int_pairs pairs (in place, one round each), each block's
// threads all through the same rounds (every lane reaches the row loads'
// shuffles), the next round's keys loaded before this round's work.  The
// histogram's tree is staged first (route 1).
template <RmiLeaf L, RmiKey KK, RmiRoute R>
__global__ void __launch_bounds__(R == RmiRoute::kInPlace ? kThreads : kStagedThreads)
int_lookup(const IntLookupOp<L, KK, R> op, int64_t m) {
  constexpr int P = IntLookupOp<L, KK, R>::P;
  extern __shared__ int64_t tree[];
  const RmiIntTopEval t(op.top);
  if constexpr (R == RmiRoute::kBlock) {
    rmi_stage_tree(tree, t.pivots, t.len, t.levels);
    __syncthreads();
  }
  const int64_t npairs = (m - op.head) >> 1;
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    const int64_t i = threadIdx.x == 0 ? (op.head ? 0 : m) : op.head + 2 * npairs;
    if (i < m) op.one(t, tree, i);
  }
  const int64_t per_round = (int64_t)int_threads<R>() * P;
  int64_t first = (int64_t)blockIdx.x * per_round + threadIdx.x;
  longlong2 v[P];
  op.load_keys(first, npairs, v);
  if constexpr (R == RmiRoute::kInPlace) {      // the grid covers the batch
    op.round(t, tree, v, first, npairs);
    return;
  }
  const int64_t stride = (int64_t)gridDim.x * per_round;
  for (int64_t base = (int64_t)blockIdx.x * per_round; base < npairs; base += stride) {
    longlong2 cur[P];
#pragma unroll
    for (int j = 0; j < P; ++j) cur[j] = v[j];
    op.load_keys(first + stride, npairs, v);
    op.round(t, tree, cur, first, npairs);
    first += stride;
  }
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

// The blocks of int_lookup<L, KK, R> resident on the current device at
// once with `smem` bytes of shared memory a block, asked of the card once
// per device and smem; a staged kernel is first allowed `smem` bytes (the
// card refuses more than a block may hold).  A card that holds no such
// block is refused.
template <RmiLeaf L, RmiKey KK, RmiRoute R>
cudaError_t resident(size_t smem, int* count) {
  struct Fit {
    size_t smem;
    int count;
  };
  static Fit fits[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Fit& f = fits[dev];
  if (f.count == 0 || f.smem != smem) {
    const auto kernel = int_lookup<L, KK, R>;
    if (R == RmiRoute::kBlock) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    }
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, int_threads<R>(),
                                                          smem);
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    f = Fit{smem, sms * per_sm};
  }
  *count = f.count;
  return cudaSuccess;
}

// One int_lookup launch: a block a round of the batch in place, else
// the blocks resident at once, or fewer for a small batch (at least one,
// for the ends)
template <RmiLeaf L, RmiKey KK, RmiRoute R>
cudaError_t start_int_lookup(const IntLookupOp<L, KK, R>& op, int64_t m, size_t smem,
                             void* stream) {
  const int64_t per_block = (int64_t)int_threads<R>() * int_pairs<L, R>();
  int64_t blocks = ((m - op.head) / 2 + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : blocks;
  if (R != RmiRoute::kInPlace) {
    int fit = 0;
    const cudaError_t e = resident<L, KK, R>(smem, &fit);
    if (e != cudaSuccess) return e;
    blocks = blocks < fit ? blocks : fit;
  }
  int_lookup<L, KK, R><<<(unsigned int)blocks, int_threads<R>(), smem,
                         (cudaStream_t)stream>>>(op, m);
  return cudaGetLastError();
}

// An affine top's lookup, or an integer top's by its route
template <RmiLeaf L, RmiKey KK>
cudaError_t start_lookup(const int64_t* keys, const double* top_w, int64_t top_kind,
                         const RmiIntTopArgs& int_top, int64_t route, size_t smem,
                         const double* rows, int64_t* guess, int64_t* err, int64_t m,
                         int64_t B, int64_t n, double offset, double scale, int head,
                         void* stream) {
  const LeafRows<L> step{rows, (double)(n - 1)};
  if (top_kind <= (int64_t)RmiLeaf::kNormal) {
    const LookupOp<L, KK> op{keys, top_w, step, guess, err, offset, scale, (double)(B - 1),
                             top_kind, head};
    lookup<L, KK><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(op, m);
    return cudaGetLastError();
  }
  if (route == 1) {
    const IntLookupOp<L, KK, RmiRoute::kBlock> op{keys, int_top, step, guess, err, offset,
                                                  scale, head};
    return start_int_lookup(op, m, smem, stream);
  }
  if (route == 2) {
    const IntLookupOp<L, KK, RmiRoute::kFolded> op{keys, int_top, step, guess, err, offset,
                                                   scale, head};
    return start_int_lookup(op, m, 0, stream);
  }
  const IntLookupOp<L, KK, RmiRoute::kInPlace> op{keys, int_top, step, guess, err, offset,
                                                  scale, head};
  return start_int_lookup(op, m, 0, stream);
}

template <RmiLeaf L>
int launch_lookup(const int64_t* keys, int64_t key_kind, const double* top_w,
                  int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                  const int64_t* pivots, int64_t top_len, int64_t route, const double* rows,
                  int64_t* guess, int64_t* err, int64_t m, int64_t B, int64_t n,
                  double offset, double scale, void* stream) {
  const RmiIntTopArgs int_top{top_kind, top_int, top_table, pivots, top_len,
                              (uint64_t)(B - 1)};
  const bool affine = top_kind >= 0 && top_kind <= (int64_t)RmiLeaf::kNormal;
  size_t smem = 0;
  if ((affine ? top_w == nullptr || route != 0 : !rmi_int_route_ok(int_top, route, &smem)) ||
      B < 1 || n < 1 ||
      (key_kind != (int64_t)RmiKey::kU64 && key_kind != (int64_t)RmiKey::kF64)) {
    return (int)cudaErrorInvalidValue;
  }
  const int head = head_of(keys);
  // guess and err on the keys' 16-byte phase, the rows and the top's row
  // on 16-byte boundaries
  if (head_of(guess) != head || head_of(err) != head || ((uintptr_t)rows & 15) ||
      ((uintptr_t)top_w & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaError_t e = cudaSuccess;
  if (m > 0 && key_kind == (int64_t)RmiKey::kF64) {
    e = start_lookup<L, RmiKey::kF64>(keys, top_w, top_kind, int_top, route, smem, rows, guess,
                                      err, m, B, n, offset, scale, head, stream);
  } else if (m > 0) {
    e = start_lookup<L, RmiKey::kU64>(keys, top_w, top_kind, int_top, route, smem, rows, guess,
                                      err, m, B, n, offset, scale, head, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

#define RMI_LEAF_EVAL_ENTRY(name, L)                                                  \
  RMI_API int rmi_leaf_eval_##name(const double* x, const double* w,                  \
                                   const int64_t* leaf, int32_t* out, int64_t m,      \
                                   int64_t bound, void* stream) {                     \
    return launch_leaf_eval<L>(x, w, leaf, out, m, bound, stream);                    \
  }

// guess[i], err[i] of key image keys[i], decoded as key_kind (RmiKey) says.
// top_kind: an affine top's leaf kernel (RmiLeaf), top_w its [1, width]
// row; or an RmiIntTop, top_int its packed parameters, top_table a hint
// table's entries and pivots a histogram's, top_len their count (the
// other operands empty: null), route where it is read (rmi_int_route_ok; 0
// for an affine top).  rows: the [B, lookup_width] lookup rows of the
// leaves (under a folded table, [top_len, lookup_width], one a bucket);
// offset and scale the normalization, n the keys indexed.  An unknown
// key or top kind, a top without its operands or a route it cannot take
// is refused with cudaErrorInvalidValue, and a launch the card refuses
// (shared memory it cannot hold) returns the card's error.  One entry
// serves every top, the top kind an argument as it always was, so the
// binding's table of parameter kinds stays one row per leaf kernel.
#define RMI_LOOKUP_ENTRY(name, L)                                                      \
  RMI_API int rmi_lookup_##name(const int64_t* keys, int64_t key_kind,                 \
                                const double* top_w, int64_t top_kind,                 \
                                const int64_t* top_int, const int32_t* top_table,      \
                                const int64_t* pivots, int64_t top_len, int64_t route, \
                                const double* rows, int64_t* guess, int64_t* err,      \
                                int64_t m, int64_t B, int64_t n, double offset,        \
                                double scale, void* stream) {                          \
    return launch_lookup<L>(keys, key_kind, top_w, top_kind, top_int, top_table, pivots, \
                            top_len, route, rows, guess, err, m, B, n, offset, scale,    \
                            stream);                                                     \
  }

RMI_LEAF_EVAL_ENTRY(linear, RmiLeaf::kLinear)
RMI_LEAF_EVAL_ENTRY(cubic, RmiLeaf::kCubic)
RMI_LEAF_EVAL_ENTRY(loglinear, RmiLeaf::kLoglinear)
RMI_LEAF_EVAL_ENTRY(normal, RmiLeaf::kNormal)
RMI_LOOKUP_ENTRY(linear, RmiLeaf::kLinear)
RMI_LOOKUP_ENTRY(cubic, RmiLeaf::kCubic)
RMI_LOOKUP_ENTRY(loglinear, RmiLeaf::kLoglinear)
RMI_LOOKUP_ENTRY(normal, RmiLeaf::kNormal)
