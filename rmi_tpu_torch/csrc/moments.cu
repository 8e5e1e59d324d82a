// K2: per-leaf centered moments of the data-parallel build's
// linear-family, loglinear and normal leaf fits (the one-card build takes
// rmi_aug_fit_moments and rmi_aug_fit_log_moments below),
//   m2[j] = sum (x[i] - mean_x[j])^2
//   c[j]  = sum (x[i] - mean_x[j]) * (y[i] - mean_y[j])
// over the leaf's overlap-augmented range [aug_starts[j], aug_ends[j]),
// in three variants, one C entry point each:
//   rmi_aug_moments           both sums (linear and robust_linear leaves);
//   rmi_aug_moments_weighted  both sums, each term times its 0/1 weight
//                             w[i] after the product is rounded (loglinear
//                             leaves, which drop keys whose ln y is not
//                             finite);
//   rmi_aug_moments_xx        m2 alone, reading x only (normal and
//                             lognormal leaves: the variance, x is y).
//
// Replaces rmi_tpu/ops/select_kernel.py:_moments_kernel (window_moments,
// its plain, has_w and xx_only forms) together with the per-leaf sums
// that follow it in rmi_tpu/utils/segments.py:683-720.  The TPU kernel
// selects each key's leaf means from a DMA'd window by one-hot matmul and
// writes the per-key products in float-float to HBM for XLA to
// range-sum.  The card has f64, so this kernel fuses product and sum: the
// per-key products never reach device memory.
//
// Bound on the H100: memory.  Per key it reads x and y (16 B), plus w
// (8 B) in the weighted variant, x alone (8 B) in the xx variant: at
// n = 200M 3.2, 4.8 and 1.6 GB, about 0.96, 1.43 and 0.48 ms at
// 3.35 TB/s, plus 48 B per leaf.  Simple design: one warp per leaf walks
// its range in a fixed order (lane-strided, then a shuffle tree), with
// no atomics, so every run gives the same bits.  The range holds the
// leaf's own keys plus at most one overlap key on each side, exactly the
// interior-plus-edge terms of segments.aug_centered_moments.  Known
// weakness: a leaf with millions of keys keeps one warp busy while the
// rest of the card idles; it is slow, never wrong.
//
// The first two also read the int32 FixDups targets in place of an f64 y
// (y_targets given, y and w null): rmi_aug_moments takes each as a
// double, rmi_aug_moments_weighted its log as models/linear.log_targets
// does (ln y, or 0 where it is not finite, weighted 1, or 0), so the
// data-parallel build (parallel/dp_trainer.py), whose leaf moments take
// means summed across ranks, makes no [m] f64 copy of y, ln y or the
// weights for them: 12 B a key in place of 16 and 24.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 leaves per block

// kWeighted reads w; kXxOnly reads neither y nor mean_y and writes no c;
// kTargets reads the int32 targets yt in place of y (and, weighted, of w)
template <bool kWeighted, bool kXxOnly, bool kTargets>
__global__ void __launch_bounds__(kThreads)
aug_moments(const double* __restrict__ x, const double* __restrict__ y,
            const double* __restrict__ w, const int32_t* __restrict__ yt,
            const double* __restrict__ mean_x, const double* __restrict__ mean_y,
            const int64_t* __restrict__ aug_starts,
            const int64_t* __restrict__ aug_ends,
            double* __restrict__ m2, double* __restrict__ c, int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j = warp; j < B; j += nwarps) {      // warp-uniform
    const int64_t lo = aug_starts[j], hi = aug_ends[j];
    const double mx = mean_x[j];
    const double my = kXxOnly ? 0.0 : mean_y[j];
    double sxx = 0.0, sxy = 0.0;
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const double dx = x[i] - mx;
      double yi = 0.0, wi = 1.0;
      if constexpr (kTargets && kWeighted) {
        const double ln = log((double)yt[i]);
        const bool keep = isfinite(ln);
        yi = keep ? ln : 0.0;
        wi = keep ? 1.0 : 0.0;
      } else if constexpr (kTargets) {
        yi = (double)yt[i];
      } else {
        if constexpr (!kXxOnly) yi = y[i];
        if constexpr (kWeighted) wi = w[i];
      }
      double xx = dx * dx;
      if constexpr (kWeighted) xx = xx * wi;
      sxx += xx;
      if constexpr (!kXxOnly) {
        double xy = dx * (yi - my);
        if constexpr (kWeighted) xy = xy * wi;
        sxy += xy;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sxx += __shfl_down_sync(RMI_FULL_MASK, sxx, off);
      if constexpr (!kXxOnly) sxy += __shfl_down_sync(RMI_FULL_MASK, sxy, off);
    }
    if (lane == 0) {
      m2[j] = sxx;
      if constexpr (!kXxOnly) c[j] = sxy;
    }
  }
}

template <bool kWeighted, bool kXxOnly, bool kTargets>
int launch_moments(const double* x, const double* y, const double* w, const int32_t* yt,
                   const double* mean_x, const double* mean_y,
                   const int64_t* aug_starts, const int64_t* aug_ends,
                   double* m2, double* c, int64_t B, void* stream) {
  if (B > 0) {
    aug_moments<kWeighted, kXxOnly, kTargets>
        <<<rmi_grid(B * 32, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
            x, y, w, yt, mean_x, mean_y, aug_starts, aug_ends, m2, c, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y (f64) or y_targets (int32 FixDups targets), the other empty (null);
// both given is refused
RMI_API int rmi_aug_moments(const double* x, const double* y, const int32_t* y_targets,
                            const double* mean_x, const double* mean_y,
                            const int64_t* aug_starts, const int64_t* aug_ends,
                            double* m2, double* c, int64_t B, void* stream) {
  if (y != nullptr && y_targets != nullptr) return (int)cudaErrorInvalidValue;
  if (y_targets != nullptr) {
    return launch_moments<false, false, true>(x, nullptr, nullptr, y_targets, mean_x, mean_y,
                                              aug_starts, aug_ends, m2, c, B, stream);
  }
  return launch_moments<false, false, false>(x, y, nullptr, nullptr, mean_x, mean_y,
                                             aug_starts, aug_ends, m2, c, B, stream);
}

// y and w (f64), or y_targets (int32 FixDups targets: ln y and its weight
// taken per key) with y and w empty (null)
RMI_API int rmi_aug_moments_weighted(const double* x, const double* y,
                                     const double* w, const int32_t* y_targets,
                                     const double* mean_x, const double* mean_y,
                                     const int64_t* aug_starts,
                                     const int64_t* aug_ends, double* m2,
                                     double* c, int64_t B, void* stream) {
  const bool targets = y_targets != nullptr;
  if (targets && (y != nullptr || w != nullptr)) return (int)cudaErrorInvalidValue;
  if (targets) {
    return launch_moments<true, false, true>(x, nullptr, nullptr, y_targets, mean_x, mean_y,
                                             aug_starts, aug_ends, m2, c, B, stream);
  }
  return launch_moments<true, false, false>(x, y, w, nullptr, mean_x, mean_y, aug_starts,
                                            aug_ends, m2, c, B, stream);
}

RMI_API int rmi_aug_moments_xx(const double* x, const double* mean_x,
                               const int64_t* aug_starts,
                               const int64_t* aug_ends, double* m2, int64_t B,
                               void* stream) {
  return launch_moments<false, true, false>(x, nullptr, nullptr, nullptr, mean_x, nullptr,
                                            aug_starts, aug_ends, m2, nullptr, B, stream);
}

// ---------------------------------------------------------------------------
// rmi_aug_fit_moments and rmi_aug_fit_log_moments: a leaf fit's whole
// per-leaf statistics in one entry, from the keys' x and their int32
// FixDups targets y, over [aug_starts[j], aug_ends[j]), in three forms:
//   rmi_aug_fit_moments (the linear-family and normal leaf fits)
//     mean_x[j] = sum x / max(cnt, 1)      mean_y[j] = sum y / max(cnt, 1)
//     m2[j]     = sum (x - mean_x[j])^2    c[j] = sum (x - mean_x[j]) (y - mean_y[j])
//   cnt the range's length; with xx_only, x alone: mean_x and m2 (normal
//   and lognormal leaves).  out is [4, B] (mean_x, mean_y, m2, c) or
//   [2, B] (mean_x, m2).
//   rmi_aug_fit_log_moments (the loglinear leaf fit) the same sums of x
//   and ln y over the keys whose ln y is finite (models/linear.log_targets:
//   FixDups targets are >= 0, so the keys dropped are the first run's,
//   y = 0), cnt their count; out is [5, B] (cnt, mean_x, mean_y, m2, c).
// sum y adds the int32 targets in int64, exactly, and converts once; each
// mean is one IEEE division; the centered terms are K2's above
// (-fmad=false: each product rounded, then added; a dropped key adds no
// term, where K2 weighted adds its product times 0).  ln y is CUDA's
// log() of the target as a double, as torch.log's on the card.
//
// Replaces rmi_tpu/ops/select_kernel.py:_moments_kernel (window_moments,
// its plain and has_w forms) with the range sums before it
// (rmi_tpu/models/linear.py:89-93 and rmi_tpu/utils/segments.py:88,
// range_sum_blocked on the TPU route; for loglinear leaves
// _loglinear_fit_leaves, rmi_tpu/models/linear.py:316-330, its
// _log_targets and masked sums): the fits that K2 above served with their
// means made in eager torch, two or three f64 prefix sums over the whole
// array (utils/segments.py:87-119 and :183-193, each a padded
// [rows, 1024] copy, a row scan and a recursive fix-up), yfix.double()
// and, for loglinear leaves, ln y and a 0/1 weight as two more [n] f64
// tensors.  Here nothing [n]-sized is written.
//
// Bound on the H100: memory for the linear and xx forms.  x (8 B) and y
// (4 B) a key, x alone in the xx form, plus 16 B of bounds and 32 (16,
// the log form 40) B of output a leaf: at 200M keys 2.4 GB, 0.72 ms at
// 3.35 TB/s.  The log form reads the same 12 B a key and takes ln y,
// ~32 f64 instructions (libdevice's log in this kernel's SASS, PERF.md
// §6), once a key in the least work; it takes ln y again where it reads a
// leaf twice, and then the f64 pipe binds it more than the bytes.
//
// One warp takes a leaf of at most kChunk keys: each lane loads a batch
// of its keys at once (kBatch = 32; the log form kLogBatch), sums them,
// and after the means centers them from the registers it loaded them
// into (the log form keeps ln y there in place of y), so a leaf of up to
// 32 batches' keys (path 1: 765 on average, 899 at most) is read from
// device memory once.  A longer leaf (paths 3, 4 and 5: ~3050) is read
// again for the centered pass, and the grid then keeps as many warps an
// SM as keep their mean leaf in L1 (kL1Bytes) in between, but for the log
// form, which keeps every warp the card holds: its logs want the warps
// more than its second pass wants L1.  A first design, every resident
// warp on a leaf and 8 keys loaded at once a lane, read the second pass
// from device memory: 1.21 ms on path 1 and 1.09 on path 4's xx form at
// 200M keys (tools/time_torch_fit.py; PERF.md §6).  On path 3 the log form
// ran fastest with every resident warp and 4 keys a batch: the L1 grid,
// fewer blocks an SM, longer batches, and a block a leaf that held the
// leaf's x and ln y in registers and took ln y once (254 registers) were
// all slower (PERF.md §6).
//
// A leaf longer than kChunk is cut into chunks of kChunk keys counted
// from its start, a constant here and not a function of the grid: its warp
// takes slots of a schedule with one integer atomicAdd and hands
// the chunks to three grid-stride passes (each chunk's sums; each chunk's
// centered terms about the leaf's means, which every chunk's warp adds up
// from the chunks' sums in chunk order; the chunks' terms added in chunk
// order).  A leaf that finds the schedule full does the same chunks
// itself, in the same order.  Every sum is a lane-strided sequence and a
// fixed butterfly of shuffles (its result the same bits in every lane:
// each step adds a pair in either order), the chunks' partials combine
// lane-strided by chunk and by the same butterfly, and no float atomic is
// used: every run gives the same bits, wherever a slot lands.
// ---------------------------------------------------------------------------
namespace {

// kXy: x and y (rmi_aug_fit_moments); kXx: x alone (its xx_only); kLog: x
// and ln y over the keys whose ln y is finite (rmi_aug_fit_log_moments)
enum class Form { kXy, kXx, kLog };

constexpr int kFitThreads = 128;         // 4 warps, 4 leaves a block
constexpr int64_t kChunk = 4096;         // keys a chunk of a long leaf
constexpr int kBatch = 32;               // keys a lane loads at once
constexpr int kLogBatch = 4;             // the same, log form (PERF.md §6)
constexpr int64_t kL1Bytes = 192 * 1024;  // of an SM's L1 for the leaves it streams
constexpr unsigned int kLongBlocks = 2048;   // grid of the long leaves' passes

template <Form F>
constexpr int kBatchOf = F == Form::kLog ? kLogBatch : kBatch;
// a leaf up to this long stays in registers between its two passes
template <Form F>
constexpr int64_t kRegKeysOf = 32 * (int64_t)kBatchOf<F>;

// what a lane holds of a key beside x: its int32 target (kXy; unused by
// kXx), or its ln y (kLog, -inf for a dropped key)
template <Form F>
using Target = std::conditional_t<F == Form::kLog, double, int32_t>;

// the rows of out: mean_x, mean_y, m2, c (kXy); mean_x, m2 (kXx); cnt,
// mean_x, mean_y, m2, c (kLog)
template <Form F>
constexpr int kRowMx = F == Form::kLog ? 1 : 0;
template <Form F>
constexpr int kRowM2 = F == Form::kXx ? 1 : (F == Form::kLog ? 3 : 2);

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(RMI_FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(RMI_FULL_MASK, v, off);
  return v;
}

// a key's ln y as log_targets takes it: -inf (dropped) where y = 0
__device__ __forceinline__ double log_target(int32_t y) { return log((double)y); }

// whether a key's ln y is kept (finite)
__device__ __forceinline__ bool kept(double ln) { return isfinite(ln); }

// A pass's sums, a lane's and then the warp's: sum x, and sum y (kXy,
// exact) or sum ln y and the kept keys' count in y (kLog)
struct Sums {
  double x = 0.0, ln = 0.0;
  long long y = 0;
};

template <Form F>
__device__ __forceinline__ Sums warp_sums(const Sums& s) {
  Sums t;
  t.x = warp_sum(s.x);
  if constexpr (F == Form::kLog) t.ln = warp_sum(s.ln);
  if constexpr (F != Form::kXx) t.y = warp_sum(s.y);
  return t;
}

// a leaf's means: (mean_x, mean_y) of its sums over cnt keys (kLog: the
// sums' own count)
__device__ __forceinline__ double fit_mean(double s, int64_t cnt) {
  return s / fmax((double)cnt, 1.0);
}

template <Form F>
__device__ __forceinline__ void means_of(const Sums& s, int64_t len, double& mx, double& my) {
  const int64_t cnt = F == Form::kLog ? s.y : len;
  mx = fit_mean(s.x, cnt);
  my = F == Form::kXx ? 0.0 : fit_mean(F == Form::kLog ? s.ln : (double)s.y, cnt);
}

// lane l's keys i, i + 32, ..., i + 32 (batch - 1): x 0.0 past hi, the
// target 0 (kLog: ln y -inf, dropped)
template <Form F>
__device__ __forceinline__ void load_batch(const double* __restrict__ x,
                                           const int32_t* __restrict__ y, int64_t i,
                                           int64_t hi, double (&xv)[kBatchOf<F>],
                                           Target<F> (&yv)[kBatchOf<F>]) {
  int32_t t[kBatchOf<F>];               // the log form's targets, logged below
#pragma unroll
  for (int u = 0; u < kBatchOf<F>; ++u) {
    const bool in = i + 32 * u < hi;
    xv[u] = in ? x[i + 32 * u] : 0.0;
    if constexpr (F == Form::kXy) yv[u] = in ? y[i + 32 * u] : 0;
    if constexpr (F == Form::kLog) t[u] = in ? y[i + 32 * u] : 0;
  }
  if constexpr (F == Form::kLog) {
#pragma unroll
    for (int u = 0; u < kBatchOf<F>; ++u) yv[u] = log_target(t[u]);
  }
}

// a batch's keys added into a lane's sums (x 0.0 past hi leaves a sum
// begun at +0.0 as it was; kLog adds the kept keys alone)
template <Form F>
__device__ __forceinline__ void add_batch(const double (&xv)[kBatchOf<F>],
                                          const Target<F> (&yv)[kBatchOf<F>], Sums& s) {
#pragma unroll
  for (int u = 0; u < kBatchOf<F>; ++u) {
    if constexpr (F == Form::kLog) {
      const bool w = kept(yv[u]);
      s.x += w ? xv[u] : 0.0;
      s.ln += w ? yv[u] : 0.0;
      s.y += w ? 1 : 0;
    } else {
      s.x += xv[u];
      if constexpr (F == Form::kXy) s.y += yv[u];
    }
  }
}

// the centered terms of a batch whose first key is i
template <Form F>
__device__ __forceinline__ void center_batch(const double (&xv)[kBatchOf<F>],
                                             const Target<F> (&yv)[kBatchOf<F>], int64_t i,
                                             int64_t hi, double mx, double my, double& sxx,
                                             double& sxy) {
#pragma unroll
  for (int u = 0; u < kBatchOf<F>; ++u) {
    // a dropped key (kLog) or a slot past hi adds no term
    const bool in = i + 32 * u < hi && (F != Form::kLog || kept((double)yv[u]));
    const double dx = in ? xv[u] - mx : 0.0;
    sxx += dx * dx;
    if constexpr (F != Form::kXx) sxy += dx * (in ? (double)yv[u] - my : 0.0);
  }
}

// the sums over [lo, hi), in every lane: lane l adds key lo + l, lo + l +
// 32, ... in sequence, a batch loaded before its adds
template <Form F>
__device__ __forceinline__ Sums chunk_sums(const double* __restrict__ x,
                                           const int32_t* __restrict__ y, int64_t lo,
                                           int64_t hi, int lane) {
  Sums s;
  double xv[kBatchOf<F>];
  Target<F> yv[kBatchOf<F>];
  for (int64_t i = lo + lane; i < hi; i += 32 * kBatchOf<F>) {
    load_batch<F>(x, y, i, hi, xv, yv);
    add_batch<F>(xv, yv, s);
  }
  return warp_sums<F>(s);
}

// sum (x - mx)^2 and sum (x - mx)(y - my) over [lo, hi), in every lane, in
// chunk_sums' order
template <Form F>
__device__ __forceinline__ void chunk_moments(const double* __restrict__ x,
                                              const int32_t* __restrict__ y, int64_t lo,
                                              int64_t hi, int lane, double mx, double my,
                                              double& m2, double& c) {
  double sxx = 0.0, sxy = 0.0, xv[kBatchOf<F>];
  Target<F> yv[kBatchOf<F>];
  for (int64_t i = lo + lane; i < hi; i += 32 * kBatchOf<F>) {
    load_batch<F>(x, y, i, hi, xv, yv);
    center_batch<F>(xv, yv, i, hi, mx, my, sxx, sxy);
  }
  m2 = warp_sum(sxx);
  c = F == Form::kXx ? 0.0 : warp_sum(sxy);
}

// a leaf of at most kChunk keys, chunk_sums then chunk_moments: one batch
// (kRegKeysOf keys) is read once and centered from the registers it was
// loaded into, a longer leaf read again
template <Form F>
__device__ __forceinline__ void leaf_stats(const double* __restrict__ x,
                                           const int32_t* __restrict__ y, int64_t lo,
                                           int64_t hi, int lane, Sums& s, double& mx,
                                           double& my, double& m2, double& c) {
  double xv[kBatchOf<F>] = {};          // a lane past hi loads nothing
  Target<F> yv[kBatchOf<F>] = {};
  Sums a;
  for (int64_t i = lo + lane; i < hi; i += 32 * kBatchOf<F>) {
    load_batch<F>(x, y, i, hi, xv, yv);
    add_batch<F>(xv, yv, a);
  }
  s = warp_sums<F>(a);
  means_of<F>(s, hi - lo, mx, my);
  if (hi - lo <= 0 || hi - lo > kRegKeysOf<F>) {
    chunk_moments<F>(x, y, lo, hi, lane, mx, my, m2, c);
    return;
  }
  double sxx = 0.0, sxy = 0.0;
  center_batch<F>(xv, yv, lo + lane, hi, mx, my, sxx, sxy);
  m2 = warp_sum(sxx);
  c = F == Form::kXx ? 0.0 : warp_sum(sxy);
}

template <Form F>
__device__ __forceinline__ void write_leaf(double* __restrict__ out, int64_t B, int64_t j,
                                           const Sums& s, double mx, double my, double m2,
                                           double c) {
  if constexpr (F == Form::kLog) out[j] = (double)s.y;
  out[kRowMx<F> * B + j] = mx;
  if constexpr (F != Form::kXx) out[(kRowMx<F> + 1) * B + j] = my;
  out[kRowM2<F> * B + j] = m2;
  if constexpr (F != Form::kXx) out[(kRowM2<F> + 1) * B + j] = c;
}

// The schedule of the long leaves' chunks, in one int64 scratch:
// [0] the slots taken, then per slot its leaf (-1: none) and chunk, the
// chunk's sums (x as f64, y or the count as int64), centered terms and,
// the log form's alone, its sum of ln y
struct Schedule {
  int64_t* taken;
  int64_t* leaf;
  int64_t* chunk;
  double* sx;
  long long* sy;
  double* m2;
  double* c;
  double* sln;
  int64_t capacity;
  __host__ __device__ Schedule(int64_t* s, int64_t cap)
      : taken(s), leaf(s + 1), chunk(s + 1 + cap), sx((double*)(s + 1 + 2 * cap)),
        sy((long long*)(s + 1 + 3 * cap)), m2((double*)(s + 1 + 4 * cap)),
        c((double*)(s + 1 + 5 * cap)), sln((double*)(s + 1 + 6 * cap)), capacity(cap) {}
  __device__ int64_t slots() const {
    const int64_t t = *taken;
    return t < capacity ? t : capacity;
  }
};

__device__ __forceinline__ int64_t chunks_of(int64_t len) { return (len + kChunk - 1) / kChunk; }

// A long leaf's combination of its chunks' partials p[0..nch) in chunk
// order: lane l adds p[l], p[l + 32], ... in sequence, then the butterfly
template <typename T>
__device__ __forceinline__ T chunk_order_sum(const T* __restrict__ p, int64_t nch, int lane) {
  T acc = 0;
  for (int64_t k = lane; k < nch; k += 32) acc += p[k];
  return warp_sum(acc);
}

// a long leaf done by its own warp, chunk by chunk, each chunk's partial
// added into lane (chunk % 32) as the schedule's passes add them
template <Form F>
__device__ void long_leaf_alone(const double* __restrict__ x, const int32_t* __restrict__ y,
                                int64_t lo, int64_t hi, int lane, double* __restrict__ out,
                                int64_t B, int64_t j) {
  const int64_t nch = chunks_of(hi - lo);
  Sums a;
  for (int64_t k = 0; k < nch; ++k) {
    const Sums s = chunk_sums<F>(x, y, lo + k * kChunk, min(hi, lo + (k + 1) * kChunk), lane);
    if ((k & 31) == lane) {
      a.x += s.x;
      a.ln += s.ln;
      a.y += s.y;
    }
  }
  const Sums s = warp_sums<F>(a);
  double mx, my;
  means_of<F>(s, hi - lo, mx, my);
  double am2 = 0.0, ac = 0.0;
  for (int64_t k = 0; k < nch; ++k) {
    double m2, c;
    chunk_moments<F>(x, y, lo + k * kChunk, min(hi, lo + (k + 1) * kChunk), lane, mx, my,
                     m2, c);
    if ((k & 31) == lane) {
      am2 += m2;
      ac += c;
    }
  }
  const double m2 = warp_sum(am2), c = warp_sum(ac);
  if (lane == 0) write_leaf<F>(out, B, j, s, mx, my, m2, c);
}

// (1) a warp a leaf: a leaf of at most kChunk keys whole, a longer one
// scheduled (or done alone where the schedule is full)
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
fit_leaves(const double* __restrict__ x, const int32_t* __restrict__ y,
           const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
           double* __restrict__ out, int64_t B, Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j = warp; j < B; j += nwarps) {      // warp-uniform
    const int64_t lo = aug_starts[j], hi = aug_ends[j];
    if (hi - lo <= kChunk) {
      Sums s;
      double mx, my, m2, c;
      leaf_stats<F>(x, y, lo, hi, lane, s, mx, my, m2, c);
      if (lane == 0) write_leaf<F>(out, B, j, s, mx, my, m2, c);
      continue;
    }
    const int64_t nch = chunks_of(hi - lo);
    unsigned long long base = 0;
    if (lane == 0) {
      base = atomicAdd(reinterpret_cast<unsigned long long*>(sched.taken),
                       (unsigned long long)nch);
    }
    const int64_t first = (int64_t)__shfl_sync(RMI_FULL_MASK, base, 0);
    const bool room = first + nch <= sched.capacity;
    for (int64_t k = lane; k < nch && first + k < sched.capacity; k += 32) {
      sched.leaf[first + k] = room ? j : -1;
      sched.chunk[first + k] = k;
    }
    if (!room) long_leaf_alone<F>(x, y, lo, hi, lane, out, B, j);
  }
}

// (2) each scheduled chunk's sums
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
fit_chunk_sums(const double* __restrict__ x, const int32_t* __restrict__ y,
               const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
               Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t slots = sched.slots();
  for (int64_t w = warp; w < slots; w += nwarps) {
    const int64_t j = sched.leaf[w];
    if (j < 0) continue;
    const int64_t lo = aug_starts[j] + sched.chunk[w] * kChunk;
    const Sums s = chunk_sums<F>(x, y, lo, min(aug_ends[j], lo + kChunk), lane);
    if (lane == 0) {
      sched.sx[w] = s.x;
      sched.sy[w] = s.y;
      if constexpr (F == Form::kLog) sched.sln[w] = s.ln;
    }
  }
}

// (3) each scheduled chunk's centered terms about its leaf's means, which
// (with the log form's count) the leaf's first chunk writes
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
fit_chunk_moments(const double* __restrict__ x, const int32_t* __restrict__ y,
                  const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
                  double* __restrict__ out, int64_t B, Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t slots = sched.slots();
  for (int64_t w = warp; w < slots; w += nwarps) {
    const int64_t j = sched.leaf[w];
    if (j < 0) continue;
    const int64_t k = sched.chunk[w], first = w - k;
    const int64_t lo = aug_starts[j], hi = aug_ends[j], nch = chunks_of(hi - lo);
    const long long sy = F == Form::kXx ? 0 : chunk_order_sum(sched.sy + first, nch, lane);
    // the log form's count is its sum of y
    const int64_t cnt = F == Form::kLog ? sy : hi - lo;
    const double mx = fit_mean(chunk_order_sum(sched.sx + first, nch, lane), cnt);
    double my = 0.0;
    if constexpr (F == Form::kXy) my = fit_mean((double)sy, cnt);
    if constexpr (F == Form::kLog) my = fit_mean(chunk_order_sum(sched.sln + first, nch, lane), cnt);
    double m2, c;
    chunk_moments<F>(x, y, lo + k * kChunk, min(hi, lo + (k + 1) * kChunk), lane, mx, my,
                     m2, c);
    if (lane == 0) {
      sched.m2[w] = m2;
      sched.c[w] = c;
      if (k == 0) {
        if constexpr (F == Form::kLog) out[j] = (double)cnt;
        out[kRowMx<F> * B + j] = mx;
        if constexpr (F != Form::kXx) out[(kRowMx<F> + 1) * B + j] = my;
      }
    }
  }
}

// (4) each scheduled leaf's centered sums, its chunks' terms in chunk order
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
fit_chunk_totals(const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
                 double* __restrict__ out, int64_t B, Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t slots = sched.slots();
  for (int64_t w = warp; w < slots; w += nwarps) {
    const int64_t j = sched.leaf[w];
    if (j < 0 || sched.chunk[w] != 0) continue;
    const int64_t nch = chunks_of(aug_ends[j] - aug_starts[j]);
    const double m2 = chunk_order_sum(sched.m2 + w, nch, lane);
    const double c = F == Form::kXx ? 0.0 : chunk_order_sum(sched.c + w, nch, lane);
    if (lane == 0) {
      out[kRowM2<F> * B + j] = m2;
      if constexpr (F != Form::kXx) out[(kRowM2<F> + 1) * B + j] = c;
    }
  }
}

// SMs of the current device and fit_leaves' resident blocks an SM, asked
// once per device, with fit_leaves' carveout set to the most L1
template <Form F>
cudaError_t fit_residency(int* sms, int* blocks) {
  static int counts[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev][0] == 0) {
    int n = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fit_leaves<F>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxL1);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fit_leaves<F>, kFitThreads,
                                                          0);
    }
    if (err != cudaSuccess) return err;
    counts[dev][0] = n;
    counts[dev][1] = per_sm > 0 ? per_sm : 1;
  }
  *sms = counts[dev][0];
  *blocks = counts[dev][1];
  return cudaSuccess;
}

template <Form F>
int launch_fit(const double* x, const int32_t* y, const int64_t* aug_starts,
               const int64_t* aug_ends, int64_t n, double* out, int64_t B, int64_t* scratch,
               int64_t capacity, cudaStream_t s) {
  const Schedule sched(scratch, capacity);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: every block the card keeps resident where a mean
  // leaf fits in registers, and for the log form, whose f64 log wants every
  // warp the card holds; where leaves of the other forms stream twice, as
  // many warps an SM as keep their mean leaf in L1 between the two passes
  int sms = 0, per_sm = 0;
  err = fit_residency<F>(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t mean_keys = (n + 2 * B) / B + 1;
  int64_t blocks_per_sm = per_sm;
  if (F != Form::kLog && mean_keys > kRegKeysOf<F>) {
    const int64_t warps = kL1Bytes / (mean_keys * (F == Form::kXx ? 8 : 12));
    blocks_per_sm = warps / (kFitThreads / 32);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
    if (blocks_per_sm > per_sm) blocks_per_sm = per_sm;
  }
  int64_t grid = (int64_t)sms * blocks_per_sm;
  const int64_t needed = rmi_grid(B * 32, kFitThreads);
  if (grid > needed) grid = needed;
  fit_leaves<F><<<(unsigned int)grid, kFitThreads, 0, s>>>(x, y, aug_starts, aug_ends, out, B,
                                                           sched);
  if (capacity > 0) {
    const int64_t blocks = rmi_grid(capacity * 32, kFitThreads);
    const unsigned int g = blocks < kLongBlocks ? (unsigned int)blocks : kLongBlocks;
    fit_chunk_sums<F><<<g, kFitThreads, 0, s>>>(x, y, aug_starts, aug_ends, sched);
    fit_chunk_moments<F><<<g, kFitThreads, 0, s>>>(x, y, aug_starts, aug_ends, out, B, sched);
    fit_chunk_totals<F><<<g, kFitThreads, 0, s>>>(aug_starts, aug_ends, out, B, sched);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: 1 + 6 * capacity int64 (ops/select_kernel.fit_capacity: enough
// for every chunk of well-formed spans; fewer slots make long leaves run
// alone, same bits); y unread and out [2, B] with xx_only
RMI_API int rmi_aug_fit_moments(const double* x, const int32_t* y,
                                const int64_t* aug_starts, const int64_t* aug_ends, int64_t n,
                                int64_t xx_only, double* out, int64_t B, int64_t* scratch,
                                int64_t capacity, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (capacity < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return xx_only ? launch_fit<Form::kXx>(x, y, aug_starts, aug_ends, n, out, B, scratch,
                                         capacity, s)
                 : launch_fit<Form::kXy>(x, y, aug_starts, aug_ends, n, out, B, scratch,
                                         capacity, s);
}

// out [5, B] (cnt, mean_x, mean_y, m2, c) of x and ln y; scratch 1 + 7 *
// capacity int64 (the schedule's slots carry each chunk's sum of ln y too)
RMI_API int rmi_aug_fit_log_moments(const double* x, const int32_t* y,
                                    const int64_t* aug_starts, const int64_t* aug_ends,
                                    int64_t n, double* out, int64_t B, int64_t* scratch,
                                    int64_t capacity, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (capacity < 0 || n < 0) return (int)cudaErrorInvalidValue;
  return launch_fit<Form::kLog>(x, y, aug_starts, aug_ends, n, out, B, scratch, capacity,
                                (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// rmi_aug_fit_sums: the first pass of the two fit entries above alone, for
// the data-parallel build (parallel/dp_trainer.py), whose leaves' means
// are sums over every rank's clip of a leaf's augmented range, added
// across ranks before the centered pass (K2 above, given those means).
// Per range [aug_starts[j], aug_ends[j]) of one rank's shard, out [3, B]:
//   form 0 (linear family)  cnt, sum x, sum y
//   form 1 (normal)         cnt, sum x, 0
//   form 2 (loglinear)      the count of keys whose ln y is finite, their
//                           sum x and sum ln y
// cnt the range's length, sum y the int32 targets added in int64 (exact)
// and converted once, every sum in chunk_sums' order, a long range's
// chunks combined in chunk order as rmi_aug_fit_moments does (same
// schedule, same bits wherever a slot lands).
//
// Replaces the eager chain the dp build ran for these sums
// (rmi_tpu/parallel/dp_trainer.py:321-333 and :374-380, _dist_slr_leaves
// and _dist_fit_ncdf_leaves through global_range_sum: an f64 prefix sum
// of each summed value over the whole shard, taken as differences at the
// clip's bounds; for loglinear leaves also ln y, its weights and their
// products, [m] f64 arrays): x and y read once, nothing [m]-sized
// written.  Bound on the H100: memory, x (8 B) and y (4 B) a key over the
// clips (x alone in form 1) and 24 B of output a leaf; the log form takes
// ln y a key, ~32 f64 instructions (rmi_aug_fit_log_moments' header).
// ---------------------------------------------------------------------------
namespace {

template <Form F>
__device__ __forceinline__ void write_sums(double* __restrict__ out, int64_t B, int64_t j,
                                           const Sums& s, int64_t len) {
  out[j] = F == Form::kLog ? (double)s.y : (double)len;
  out[B + j] = s.x;
  out[2 * B + j] = F == Form::kLog ? s.ln : (F == Form::kXy ? (double)s.y : 0.0);
}

// (1) a warp a range: one of at most kChunk keys whole, a longer one
// scheduled, or summed chunk by chunk by its own warp where the schedule is
// full (each chunk's sums added into lane (chunk % 32), as (3) adds them)
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
sums_leaves(const double* __restrict__ x, const int32_t* __restrict__ y,
            const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
            double* __restrict__ out, int64_t B, Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j = warp; j < B; j += nwarps) {      // warp-uniform
    const int64_t lo = aug_starts[j], hi = aug_ends[j];
    if (hi - lo <= kChunk) {
      const Sums s = chunk_sums<F>(x, y, lo, hi, lane);
      if (lane == 0) write_sums<F>(out, B, j, s, hi - lo);
      continue;
    }
    const int64_t nch = chunks_of(hi - lo);
    unsigned long long base = 0;
    if (lane == 0) {
      base = atomicAdd(reinterpret_cast<unsigned long long*>(sched.taken),
                       (unsigned long long)nch);
    }
    const int64_t first = (int64_t)__shfl_sync(RMI_FULL_MASK, base, 0);
    const bool room = first + nch <= sched.capacity;
    for (int64_t k = lane; k < nch && first + k < sched.capacity; k += 32) {
      sched.leaf[first + k] = room ? j : -1;
      sched.chunk[first + k] = k;
    }
    if (room) continue;
    Sums a;
    for (int64_t k = 0; k < nch; ++k) {
      const Sums s = chunk_sums<F>(x, y, lo + k * kChunk, min(hi, lo + (k + 1) * kChunk), lane);
      if ((k & 31) == lane) {
        a.x += s.x;
        a.ln += s.ln;
        a.y += s.y;
      }
    }
    const Sums s = warp_sums<F>(a);
    if (lane == 0) write_sums<F>(out, B, j, s, hi - lo);
  }
}

// (3) each scheduled range's sums, its chunks' in chunk order ((2) is
// fit_chunk_sums above)
template <Form F>
__global__ void __launch_bounds__(kFitThreads)
sums_totals(const int64_t* __restrict__ aug_starts, const int64_t* __restrict__ aug_ends,
            double* __restrict__ out, int64_t B, Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t slots = sched.slots();
  for (int64_t w = warp; w < slots; w += nwarps) {
    const int64_t j = sched.leaf[w];
    if (j < 0 || sched.chunk[w] != 0) continue;
    const int64_t len = aug_ends[j] - aug_starts[j], nch = chunks_of(len);
    Sums s;
    s.x = chunk_order_sum(sched.sx + w, nch, lane);
    if constexpr (F != Form::kXx) s.y = chunk_order_sum(sched.sy + w, nch, lane);
    if constexpr (F == Form::kLog) s.ln = chunk_order_sum(sched.sln + w, nch, lane);
    if (lane == 0) write_sums<F>(out, B, j, s, len);
  }
}

template <Form F>
int launch_sums(const double* x, const int32_t* y, const int64_t* aug_starts,
                const int64_t* aug_ends, double* out, int64_t B, int64_t* scratch,
                int64_t capacity, cudaStream_t s) {
  const Schedule sched(scratch, capacity);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  sums_leaves<F><<<rmi_grid(B * 32, kFitThreads), kFitThreads, 0, s>>>(x, y, aug_starts,
                                                                       aug_ends, out, B, sched);
  if (capacity > 0) {
    const int64_t blocks = rmi_grid(capacity * 32, kFitThreads);
    const unsigned int g = blocks < kLongBlocks ? (unsigned int)blocks : kLongBlocks;
    fit_chunk_sums<F><<<g, kFitThreads, 0, s>>>(x, y, aug_starts, aug_ends, sched);
    sums_totals<F><<<g, kFitThreads, 0, s>>>(aug_starts, aug_ends, out, B, sched);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [3, B]; scratch 1 + 7 * capacity int64 (ops/select_kernel.fit_capacity
// of the shard); y unread (may be empty) for form 1; an unknown form is
// refused
RMI_API int rmi_aug_fit_sums(const double* x, const int32_t* y, const int64_t* aug_starts,
                             const int64_t* aug_ends, int64_t form, double* out, int64_t B,
                             int64_t* scratch, int64_t capacity, void* stream) {
  if (form < 0 || form > 2 || capacity < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 1)
    return launch_sums<Form::kXx>(x, y, aug_starts, aug_ends, out, B, scratch, capacity, s);
  if (form == 2)
    return launch_sums<Form::kLog>(x, y, aug_starts, aug_ends, out, B, scratch, capacity, s);
  return launch_sums<Form::kXy>(x, y, aug_starts, aug_ends, out, B, scratch, capacity, s);
}
