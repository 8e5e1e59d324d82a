// Stage A of the build (train/two_layer.py, the rmi.build.assign range)
// after FixDups: the model's float input, the cubic top's whole fit and
// the leaf assignment, in four entries (csrc/top_fit.cu has the other
// tops' fits).
//
//   rmi_key_normalize   x[i] = (as_float(key[i]) - offset) * scale, f64:
//                       the normalized key (models.base.normalize) that
//                       the top fit, the assignment and stages B and C
//                       read;
//   rmi_top_cubic_candidates
//                       one block: the cubic top's endpoints (or the
//                       top's ep_y), the two global searches of _slopes,
//                       the clamped slopes, _coeffs and both candidates
//                       (models/cubic.py _candidates), into a [kCand]
//                       buffer with the aux statistics fit_cubic_aux
//                       returns (kC* below);
//   rmi_top_l1_cubic    the whole-array sums
//                         c = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
//                         l = sum |fma(beta, x, alpha) - y|
//                       of the buffer's two candidates, with y =
//                       trunc(yfix * sf) (two_layer._scale; yfix itself
//                       where sf does not scale); its last block keeps the
//                       linear spline where l < c (cubic_spline.rs:113-135)
//                       and writes the chosen row and its case
//                       (choose_candidates), so the top's fit is two
//                       launches with no host step between them;
//   rmi_top_l1_partial  the same two sums over one rank's shard of the keys
//                       in the data-parallel build, without the choice: the
//                       shard's partial sums in the same fixed tree, which
//                       parallel/dp_trainer.py adds across ranks in rank
//                       order before it chooses (rmi_tpu's
//                       _dist_fit_cubic_top, rmi_tpu/parallel/
//                       dp_trainer.py:275, sums the two [m] error arrays in
//                       XLA; the port's dp build took the scaled targets, two
//                       predictions, their errors and two prefix sums in
//                       eager torch, [m] f64 arrays all);
//   rmi_top_assign      t[i] = min(B - 1, predict_to_int(top(x[i]))), int32:
//                       each key's leaf (two_layer.rs:49).
//
// Replaces no Pallas call: rmi_tpu computes the stage as one XLA program
// (rmi_tpu/train/two_layer.py:176, _assign_body: as_float, the
// normalization, FixDups, the top fit and predict_top_assignment).  In
// eager torch, their plain versions, the same work is a chain of
// [n]-sized passes: as_float's eight and the normalization's two, the
// scaled targets, each L1 sum's predict, subtraction, abs and sum (K6
// puts a warp on a leaf and cannot take one 200M-key segment), the
// assignment's three FMAs, floor, isnan, clamp, where and two casts.
//
// Bound on the H100: memory.  Normalize reads an 8-byte image and writes
// an 8-byte x a key, the sums read x and a 4-byte yfix, the assignment x
// and writes a 4-byte leaf id (16, 12 and 12 bytes a key: 0.955, 0.716
// and 0.716 ms at 200M keys and 3.35 TB/s).  Each is a grid-stride loop
// with kUnroll elements in flight a thread, neighbouring threads on
// neighbouring 8-byte elements (a warp's load is eight whole sectors),
// the arithmetic in registers: nothing [n]-sized between the steps.
//
// Every value keeps the bits of its plain PyTorch chain: the decode and
// the normalization are common.cuh's normalized<K> (the fused lookup's),
// the targets two roundings (the product, then trunc: -fmad=false keeps
// them apart), the top and the candidates rmi_leaf of leaf_eval.cuh on
// the top's row, the clamps rmi_clamp_floor, an integer top int_top.cuh's
// RmiIntTopEval on its operands read in place.  The sums alone round
// otherwise than the plain whole-array sum (segments.whole_array_sum, XLA's
// order on the CPU): each thread adds its keys in sequence, i, i + S,
// i + 2S, ... (S the grid's threads), a fixed warp and block tree adds
// the threads' sums, and a second launch of one block adds the blocks'
// partial sums by a fixed tree.  The grid is a function of n alone
// (l1_blocks), not of the card, and no float atomic is used, so every
// run gives the same bits.
//
// The candidates are the plain chain's bits: its searches are aten's
// (the same midpoints, so the same answer on any input, NaN included),
// every quotient and square root is IEEE-rounded as torch's, the
// reciprocal that torch takes for a scalar over a tensor (3 / sqrt(.) is
// reciprocal(sqrt(.)) * 3) is kept, and each addcmul is an fma().  One
// block of two warps does it, in place of ~180 [1]- and [2]-sized torch
// operators each issued by the host: warp 0 searches for the first point
// with x > xmin, warp 1 for the last with x < xmax, at once, then one
// thread finishes the chain.  A warp walks aten's binary search
// kSearchLevels steps a round: the steps a round can take form a tree of
// 2^kSearchLevels - 1 brackets, each with its midpoint; the lanes read
// all of those midpoints at once (one a lane), ballot each one's step,
// and every lane walks the tree on the ballots.  So each search takes aten's midpoints and its
// answer on any input, NaN included, in ceil(log2(n + 1) / kSearchLevels)
// rounds of reads (6 at 200M keys) where one thread took log2(n + 1)
// dependent reads (28); a warp reading evenly spaced probes would need a
// midpoint walk of its own wherever NaN breaks x's order (keys.f64_image
// puts NaN keys first).  A lane holds one bracket: a deeper tree (8 steps,
// 255 brackets, 8 a lane) spent on the brackets what it saved in reads.
//
// The assignment has two kernels behind its entry, as the fused lookup
// has (eval.cu): one for the affine tops (linear, robust_linear,
// linear_spline, loglinear, cubic, normal; the top kind, warp-uniform, a
// runtime branch) and one for the integer tops (radix, bradix, the hint
// tables, histogram), whose branch in one body cost the fused lookup's
// affine route registers and a stack frame.  The integer kernel reads the
// integer-key images (keys.int_image) and the top's operands in place:
// a hint table's entries as lookup takes them (eval_kernel.narrow_table:
// clamp_int(entry, B - 1), the clamp the kernel takes again, in 16 bits
// where B - 1 fits them), a histogram's pivots by halving through L1 and
// L2.  A lognormal top stays in torch (ops/top_kernel.py).
#include "common.cuh"
#include "int_top.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // elements in flight a thread
constexpr int kPer = kThreads * kUnroll;    // elements of a block's round
// the L1 sums' first pass: at least kL1Keys keys a block, at most
// kL1Blocks blocks, whatever the card
constexpr int64_t kL1Keys = 2048;
constexpr int64_t kL1Blocks = 1024;
// the candidates buffer (ops/top_kernel.CAND): the cubic row (a, b, c, d),
// the spline's (intercept, slope), then the aux statistics and the
// container's constant case (1.0 or 0.0)
constexpr int kCand = 16;
enum : int { kCubicRow = 0, kLinRow = 4, kCXmin = 6, kCXmax = 7, kCYmin = 8, kCYmax = 9,
             kCM1 = 10, kCM2 = 11, kCConst = 12 };
// convert.CUBIC_CASE_*
constexpr int32_t kCaseCubic = 0, kCaseLinear = 1, kCaseConst = 2;

int64_t l1_blocks(int64_t n) {
  const int64_t b = (n + kL1Keys - 1) / kL1Keys;
  return b < 1 ? 1 : b > kL1Blocks ? kL1Blocks : b;
}

template <RmiKey K>
__global__ void __launch_bounds__(kThreads)
key_normalize(const int64_t* __restrict__ keys, double* __restrict__ x, int64_t n,
              double offset, double scale) {
  const int64_t stride = (int64_t)gridDim.x * kPer;
  for (int64_t i0 = (int64_t)blockIdx.x * kPer + threadIdx.x; i0 < n; i0 += stride) {
    int64_t v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      v[k] = i < n ? __ldg(keys + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      if (i < n) x[i] = normalized<K>(v[k], offset, scale);
    }
  }
}

// the scaled target of FixDups position y (two_layer._scale)
__device__ __forceinline__ double target(int32_t y, double sf, bool scaled) {
  return scaled ? trunc((double)y * sf) : (double)y;
}

// steps of aten's binary search a round of search_f64 takes: the round's
// tree holds 2^kSearchLevels - 1 brackets, node k (heap-numbered from 1)
// lane k - 1's
constexpr int kSearchLevels = 5;

// aten's step at a midpoint read m: whether the search goes right of it
template <bool kRight>
__device__ __forceinline__ bool goes_right(double m, double v) {
  return kRight ? !(m > v) : !(m >= v);
}

// torch.searchsorted of v in x[0:n], left (lower) or right (upper), in
// every lane of the warp: aten's binary search, kSearchLevels steps a round
// (the file's header)
template <bool kRight>
__device__ int64_t search_f64(const double* __restrict__ x, int64_t n, double v, int lane) {
  const int k = lane + 1;                   // lane 31: node 32, past the tree
  const int depth = 31 - __clz(k);
  int64_t lo = 0, hi = n;
  while (lo < hi) {                         // warp-uniform
    // node k's bracket down the tree (the bits of k below its leading one,
    // a right step for a 1), then its midpoint, read where it is not empty
    long long a = lo, b = hi;
#pragma unroll
    for (int d = kSearchLevels - 2; d >= 0; --d) {
      if (d < depth) {
        const long long mid = a + ((b - a) >> 1);
        if ((k >> d) & 1) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
    }
    const bool live = lane < 31 && a < b;
    const double m = live ? __ldg(x + a + ((b - a) >> 1)) : 0.0;
    const unsigned int right = __ballot_sync(RMI_FULL_MASK, live && goes_right<kRight>(m, v));
    const unsigned int lives = __ballot_sync(RMI_FULL_MASK, live);
    // aten's walk through the tree: it leaves at an empty bracket, where its
    // loop ends, or at a child of the last level, one step below its parent
    int w = 1;
    while (w < 32 && ((lives >> (w - 1)) & 1)) w = 2 * w + ((right >> (w - 1)) & 1);
    const int src = w < 32 ? w - 1 : (w >> 1) - 1;
    const long long pa = __shfl_sync(RMI_FULL_MASK, a, src);
    const long long pb = __shfl_sync(RMI_FULL_MASK, b, src);
    if (w < 32) {
      lo = pa;
      hi = pb;
    } else {
      const long long mid = pa + ((pb - pa) >> 1);
      lo = w & 1 ? mid + 1 : pa;
      hi = w & 1 ? pb : mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// fit_cubic_aux's whole-array candidates (models/cubic.py _candidates,
// _slopes, slopes_from_points, _coeffs, candidates_from_slopes,
// linear.spline_from_endpoints), operation for operation: the two global
// searches a warp each, the rest one thread
template <RmiKey K>
__global__ void __launch_bounds__(64)
cubic_candidates(const double* __restrict__ x, const int32_t* __restrict__ y,
                 const int64_t* __restrict__ keys, int64_t n, double sf, bool scaled,
                 bool has_ep, double ep_first, double ep_last, double* __restrict__ cand) {
  __shared__ int64_t found[2];
  const int lane = threadIdx.x & 31;
  const double xmin = x[0], xmax = x[n - 1];
  // read before the searches, where their loads wait beside them
  const double ymin = has_ep ? ep_first : target(y[0], sf, scaled);
  const double ymax = has_ep ? ep_last : target(y[n - 1], sf, scaled);
  const double key_min = keys == nullptr ? xmin : decoded<K>(keys[0]);
  const double key_max = keys == nullptr ? xmax : decoded<K>(keys[n - 1]);
  // the first point with x > xmin and the last with x < xmax, global
  if (threadIdx.x < 32) {
    const int64_t i = search_f64<true>(x, n, xmin, lane);
    if (lane == 0) found[0] = clamp_index(i, n);
  } else {
    const int64_t i = search_f64<false>(x, n, xmax, lane);
    if (lane == 0) found[1] = clamp_index(i - 1, n);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool degenerate = xmin == xmax;
  const int64_t i1 = found[0], i2 = found[1];
  const double x1 = x[i1], y1 = target(y[i1], sf, scaled);
  const double x2 = x[i2], y2 = target(y[i2], sf, scaled);
  // slopes_from_points
  const double safe_span = degenerate ? 1.0 : xmax - xmin;
  const double safe_yspan = ymax == ymin ? 1.0 : ymax - ymin;
  const double sxn = (x1 - xmin) / safe_span;
  const double sxp = (x2 - xmin) / safe_span;
  const double syp = (y2 - ymin) / safe_yspan;
  double m1 = (y1 - ymin) / (safe_yspan * (sxn == 0.0 ? 1.0 : sxn));
  double m2 = (1.0 - syp) / (sxp == 1.0 ? 1.0 : 1.0 - sxp);
  const double norm2 = fma(m1, m1, m2 * m2);
  // 3 / sqrt(norm2) as torch takes a scalar over a tensor: reciprocal,
  // then * 3 (the plain chain's clamp to 1e-300 never acts above 9)
  const double tau = norm2 > 9.0 ? (1.0 / sqrt(norm2)) * 3.0 : 1.0;
  m1 = m1 * tau;
  m2 = m2 * tau;
  // _coeffs
  const double span = xmax - xmin;
  const double span3 = span * span * span;
  const double xx = xmax * xmax, nn = xmin * xmin, xn = xmax * xmin;
  const double a = (m1 + m2 - 2.0) / span3;
  const double b = -fma(xmax, 2.0 * m1 + m2 - 3.0, xmin * (m1 + 2.0 * m2 - 3.0)) / span3;
  const double c = fma(xn, 2.0 * m1 + 2.0 * m2 - 6.0, fma(m1, xx, m2 * nn)) / span3;
  const double d = -xmin * fma(xmin, xmin, fma(m1, xx, xn * (m2 - 3.0))) / span3;
  const double ys = ymax - ymin;
  // candidates_from_slopes: n >= 1 points, so never the empty case
  const bool const_case = n == 1 || degenerate;
  cand[kCubicRow] = const_case ? 0.0 : a * ys;
  cand[kCubicRow + 1] = const_case ? 0.0 : b * ys;
  cand[kCubicRow + 2] = const_case ? 0.0 : c * ys;
  cand[kCubicRow + 3] = const_case ? ymin : fma(d, ys, ymin);
  // spline_from_endpoints (fused)
  const double slope = degenerate ? 0.0 : (ymin - ymax) / (xmin - xmax);
  const double intercept = fma(-slope, xmin, ymin);
  cand[kLinRow] = n == 1 || degenerate ? ymin : intercept;
  cand[kLinRow + 1] = n <= 1 || degenerate ? 0.0 : slope;
  cand[kCXmin] = key_min;
  cand[kCXmax] = key_max;
  cand[kCYmin] = ymin;
  cand[kCYmax] = ymax;
  cand[kCM1] = m1;
  cand[kCM2] = m2;
  cand[kCConst] = const_case ? 1.0 : 0.0;
#pragma unroll
  for (int k = kCConst + 1; k < kCand; ++k) cand[k] = 0.0;
}

// a and b summed over the block by a fixed tree; thread 0 gets the totals
__device__ __forceinline__ void block_sum(double& a, double& b) {
  __shared__ double sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(RMI_FULL_MASK, a, off);
    b += __shfl_down_sync(RMI_FULL_MASK, b, off);
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0;
    b = lane < kWarps ? sb[lane] : 0.0;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      a += __shfl_down_sync(RMI_FULL_MASK, a, off);
      b += __shfl_down_sync(RMI_FULL_MASK, b, off);
    }
  }
}

// pass 1: each block's two partial sums, partials[2 j] (cubic) and
// partials[2 j + 1] (linear) of block j
__global__ void __launch_bounds__(kThreads)
top_l1_blocks(const double* __restrict__ x, const int32_t* __restrict__ y, int64_t n,
              double sf, bool scaled, const double* __restrict__ cand,
              double* __restrict__ partials) {
  double cw[4], lw[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) cw[k] = __ldg(cand + kCubicRow + k);
  lw[0] = __ldg(cand + kLinRow);
  lw[1] = __ldg(cand + kLinRow + 1);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  double sc = 0.0, sl = 0.0;
  // kUnroll keys loaded together, then added in their order
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    double xi[kUnroll];
    int32_t yi[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      xi[k] = __ldg(x + i + k * stride);
      yi[k] = __ldg(y + i + k * stride);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const double t = target(yi[k], sf, scaled);
      sc += fabs(rmi_cubic_leaf(cw, 0, xi[k]) - t);
      sl += fabs(rmi_linear_leaf(lw, 0, xi[k]) - t);
    }
  }
  for (; i < n; i += stride) {
    const double t = target(__ldg(y + i), sf, scaled);
    const double xi = __ldg(x + i);
    sc += fabs(rmi_cubic_leaf(cw, 0, xi) - t);
    sl += fabs(rmi_linear_leaf(lw, 0, xi) - t);
  }
  block_sum(sc, sl);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sc;
    partials[2 * blockIdx.x + 1] = sl;
  }
}

// pass 2, one block: thread k adds the partials of blocks k, k + kThreads,
// ... in order, then the block's tree; sums[0] cubic, sums[1] linear;
// then, where row is given, the choice (models/cubic.py choose_candidates
// and fit_cubic_aux's case): row the cubic, or the spline as (0, 0, slope,
// intercept) where l < c, and its case
__global__ void __launch_bounds__(kThreads)
top_l1_total(const double* __restrict__ partials, int64_t blocks,
             const double* __restrict__ cand, double* __restrict__ sums,
             double* __restrict__ row, int32_t* __restrict__ top_case) {
  double sc = 0.0, sl = 0.0;
  for (int64_t j = threadIdx.x; j < blocks; j += kThreads) {
    sc += partials[2 * j];
    sl += partials[2 * j + 1];
  }
  block_sum(sc, sl);
  if (threadIdx.x == 0) {
    sums[0] = sc;
    sums[1] = sl;
    if (row == nullptr) return;
    const bool use_lin = sl < sc;
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = cand[kCubicRow + k];
    if (use_lin) {
      row[0] = 0.0;
      row[1] = 0.0;
      row[2] = cand[kLinRow + 1];
      row[3] = cand[kLinRow];
    }
    *top_case = cand[kCConst] != 0.0 ? kCaseConst : (use_lin ? kCaseLinear : kCaseCubic);
  }
}

// t[i] of an affine top of kind T: its leaf evaluation on its row
template <RmiLeaf T>
__device__ __forceinline__ void assign_affine(const double* __restrict__ x,
                                              const double* __restrict__ top_w,
                                              int32_t* __restrict__ t, int64_t n,
                                              double bound) {
  double r[rmi_leaf_width(T)];
#pragma unroll
  for (int k = 0; k < rmi_leaf_width(T); ++k) r[k] = __ldg(top_w + k);
  const int64_t stride = (int64_t)gridDim.x * kPer;
  for (int64_t i0 = (int64_t)blockIdx.x * kPer + threadIdx.x; i0 < n; i0 += stride) {
    double v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      v[k] = i < n ? __ldg(x + i) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      if (i < n) t[i] = rmi_clamp_floor(rmi_leaf<T>(r, 0, v[k]), bound);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
top_assign_affine(const double* __restrict__ x, const double* __restrict__ top_w,
                  int64_t kind, int32_t* __restrict__ t, int64_t n, double bound) {
  switch (kind) {      // the same in every thread
    case (int64_t)RmiLeaf::kCubic: assign_affine<RmiLeaf::kCubic>(x, top_w, t, n, bound); break;
    case (int64_t)RmiLeaf::kLoglinear:
      assign_affine<RmiLeaf::kLoglinear>(x, top_w, t, n, bound);
      break;
    case (int64_t)RmiLeaf::kNormal: assign_affine<RmiLeaf::kNormal>(x, top_w, t, n, bound); break;
    default: assign_affine<RmiLeaf::kLinear>(x, top_w, t, n, bound); break;
  }
}

// t[i] of an integer top on integer-key images: clamp_int(top(u), B - 1)
__global__ void __launch_bounds__(kThreads)
top_assign_int(const int64_t* __restrict__ images, const RmiIntTopArgs top,
               int32_t* __restrict__ t, int64_t n) {
  const RmiIntTopEval e(top);
  const int64_t stride = (int64_t)gridDim.x * kPer;
  for (int64_t i0 = (int64_t)blockIdx.x * kPer + threadIdx.x; i0 < n; i0 += stride) {
    uint64_t u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      u[k] = int_bits<RmiKey::kU64>(i < n ? __ldg(images + i) : 0);
    }
    int64_t leaf[kUnroll];
    e.leaves<RmiRoute::kInPlace>(u, nullptr, leaf);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      if (i < n) t[i] = (int32_t)leaf[k];
    }
  }
}

}  // namespace

// x[i] of key image keys[i], decoded as key_kind (RmiKey) says; an unknown
// kind is refused
RMI_API int rmi_key_normalize(const int64_t* keys, int64_t key_kind, double* x, int64_t n,
                              double offset, double scale, void* stream) {
  if (key_kind != (int64_t)RmiKey::kU64 && key_kind != (int64_t)RmiKey::kF64) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const unsigned int blocks = rmi_grid((n + kUnroll - 1) / kUnroll, kThreads);
    if (key_kind == (int64_t)RmiKey::kF64) {
      key_normalize<RmiKey::kF64><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          keys, x, n, offset, scale);
    } else {
      key_normalize<RmiKey::kU64><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          keys, x, n, offset, scale);
    }
  }
  return (int)cudaGetLastError();
}

// cand[kCand]: the candidates of the cubic fit over the n points of x and
// the FixDups positions y (the targets y scaled by sf where scale_targets
// is nonzero); has_ep: the endpoints' targets are ep_first and ep_last
// (the top's), else y's; keys (null: x's) the key images whose first and
// last give the aux's xmin and xmax, decoded as key_kind says.  n < 1 or
// an unknown kind is refused.
RMI_API int rmi_top_cubic_candidates(const double* x, const int32_t* y, const int64_t* keys,
                                     int64_t key_kind, int64_t n, double sf,
                                     int64_t scale_targets, int64_t has_ep, double ep_first,
                                     double ep_last, double* cand, void* stream) {
  if (n < 1 || (key_kind != (int64_t)RmiKey::kU64 && key_kind != (int64_t)RmiKey::kF64)) {
    return (int)cudaErrorInvalidValue;
  }
  if (key_kind == (int64_t)RmiKey::kF64) {
    cubic_candidates<RmiKey::kF64><<<1, 64, 0, (cudaStream_t)stream>>>(
        x, y, keys, n, sf, scale_targets != 0, has_ep != 0, ep_first, ep_last, cand);
  } else {
    cubic_candidates<RmiKey::kU64><<<1, 64, 0, (cudaStream_t)stream>>>(
        x, y, keys, n, sf, scale_targets != 0, has_ep != 0, ep_first, ep_last, cand);
  }
  return (int)cudaGetLastError();
}

// sums[0] (cubic) and sums[1] (linear) over the n keys of x and y, the
// targets y scaled by sf where scale_targets is nonzero, of the candidates
// in cand (rmi_top_cubic_candidates' buffer); row[4] the chosen row and
// top_case[0] its case; partials a scratch of 2 * capacity values, refused
// if it holds fewer than l1_blocks(n) blocks' (ops/top_kernel.L1_BLOCKS
// is kL1Blocks)
RMI_API int rmi_top_l1_cubic(const double* x, const int32_t* y, int64_t n, double sf,
                             int64_t scale_targets, const double* cand, double* partials,
                             int64_t capacity, double* sums, double* row, int32_t* top_case,
                             void* stream) {
  const int64_t blocks = l1_blocks(n);
  if (n < 1 || capacity < blocks) return (int)cudaErrorInvalidValue;
  top_l1_blocks<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, sf, scale_targets != 0, cand, partials);
  top_l1_total<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, blocks, cand, sums, row,
                                                         top_case);
  return (int)cudaGetLastError();
}

// sums[0] (cubic) and sums[1] (linear) over the n keys of one shard, as
// rmi_top_l1_cubic takes them but with no choice: n may be 0 (sums 0.0);
// partials as rmi_top_l1_cubic's
RMI_API int rmi_top_l1_partial(const double* x, const int32_t* y, int64_t n, double sf,
                               int64_t scale_targets, const double* cand, double* partials,
                               int64_t capacity, double* sums, void* stream) {
  const int64_t blocks = l1_blocks(n);
  if (n < 0 || capacity < blocks) return (int)cudaErrorInvalidValue;
  top_l1_blocks<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, sf, scale_targets != 0, cand, partials);
  top_l1_total<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, blocks, cand, sums, nullptr,
                                                         nullptr);
  return (int)cudaGetLastError();
}

// t[i], the leaf of key i under the top of kind top_kind
// (ops/eval_kernel.TOP_KINDS): an affine top's leaf kernel (RmiLeaf) on
// x, top_w its [1, width] row; or an RmiIntTop on the integer-key images,
// top_int its packed parameters, top_table a hint table's narrowed
// entries (eval_kernel.narrow_table) and pivots a histogram's, top_len
// their count (the other operands empty: null), read in place.  B - 1
// must fit int32.  A top without its operands or an unknown kind is
// refused.
RMI_API int rmi_top_assign(const double* x, const int64_t* images, const double* top_w,
                           int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                           const int64_t* pivots, int64_t top_len, int32_t* t, int64_t n,
                           int64_t B, void* stream) {
  const RmiIntTopArgs int_top{top_kind, top_int, top_table, pivots, top_len,
                              (uint64_t)(B - 1)};
  const bool affine = top_kind >= 0 && top_kind <= (int64_t)RmiLeaf::kNormal;
  size_t smem = 0;
  if (B < 1 || B - 1 > INT32_MAX ||
      (affine ? top_w == nullptr || (n > 0 && x == nullptr)
              : !rmi_int_route_ok(int_top, 0, &smem) || (n > 0 && images == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const unsigned int blocks = rmi_grid((n + kUnroll - 1) / kUnroll, kThreads);
    if (affine) {
      top_assign_affine<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, top_w, top_kind, t,
                                                                       n, (double)(B - 1));
    } else {
      top_assign_int<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(images, int_top, t, n);
    }
  }
  return (int)cudaGetLastError();
}
