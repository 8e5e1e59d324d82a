// K3: the build's error sweep, fused with the per-leaf maximum it feeds.
// Per leaf j over its span of the sorted keys,
//   max_err[j] = max_i | clip(floor(leaf(w[j], xn[i])), 0, n) - min(yfix[i], n) |
// with NaN -> 0 and 0 for an empty leaf (rmi_tpu/train/two_layer.py:
// 269-280, 337-338), where leaf is fma(beta, x, alpha) for linear rows,
// the three chained FMAs for cubic rows, exp1 of the linear leaf for
// loglinear rows and the logistic phi for normal rows (lognormal leaves
// pass max(ln x, 0) as xn); one C entry point per family.
//
// Replaces rmi_tpu/ops/sweep_kernel.py:_sweep_kernel (sweep_errors)
// together with the segmented max that follows it
// (rmi_tpu/utils/segments.py:range_max).  The TPU kernel avoids per-key
// HBM gathers by DMAing each block's contiguous window of leaf rows and
// selecting rows with a one-hot matmul, evaluating in float-float
// because Mosaic has no f64, and writes the per-key errors for XLA to
// reduce; it needs an overflow flag and a retry when a block spans more
// leaves than the window.
//
// Bound on the H100: memory.  Per key it reads xn (8 B) and yfix (4 B):
// 12 B/key, 2.4 GB at n = 200M, about 0.72 ms at 3.35 TB/s, plus the
// span bounds, one leaf row per part of a span and 4 B per leaf; it
// reads no leaf ids and writes no per-key errors.  The walk is span_max
// (span_max.cuh): the leaf's row is loaded once per
// part of a span into registers, so there is no window, no flag and no
// retry, and the per-key errors never reach device memory.  The
// evaluation is rmi_leaf from leaf_eval.cuh, the function eval.cu serves
// with, on the same values in the same order as the per-key form: every
// error keeps its bits, and a maximum does not depend on their order.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W
// limit, n = 200M: linear leaves (B = 262144) 0.8947 ms, cubic 0.8560,
// loglinear 0.8457, normal 1.2630 ms (its divisions), against a bound of
// 0.717-0.719 ms.  PERF.md has the runs.
#include "leaf_eval.cuh"
#include "span_max.cuh"

namespace {

template <RmiLeaf L>
struct SweepError {
  static constexpr int kWidth = rmi_leaf_width(L);
  struct Row { double r[kWidth]; };

  const double* xn;
  const int32_t* yfix;
  const double* w;
  int32_t bound;

  __device__ __forceinline__ Row row(int64_t j) const {
    Row row;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) row.r[k] = w[kWidth * j + k];
    return row;
  }

  __device__ __forceinline__ int32_t operator()(const Row& row, int64_t i) const {
    const int32_t pred = rmi_clamp_floor(rmi_leaf<L>(row.r, 0, xn[i]), (double)bound);
    const int32_t d = pred - min(yfix[i], bound);
    return d < 0 ? -d : d;
  }
};

template <RmiLeaf L>
int launch_sweep_max(const double* xn, const int32_t* yfix, const int64_t* starts,
                     const int64_t* ends, const double* w, int32_t* max_err,
                     int64_t B, int64_t n_keys, int64_t bound, void* stream) {
  const SweepError<L> f{xn, yfix, w, (int32_t)bound};
  return rmi_launch_span_max(f, starts, ends, B, n_keys, max_err, stream);
}

}  // namespace

// max_err holds B zeros; bound < 2^31.
RMI_API int rmi_sweep_max_linear(const double* xn, const int32_t* yfix,
                                 const int64_t* starts, const int64_t* ends,
                                 const double* w, int32_t* max_err, int64_t B,
                                 int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep_max<RmiLeaf::kLinear>(xn, yfix, starts, ends, w, max_err, B,
                                            n_keys, bound, stream);
}

RMI_API int rmi_sweep_max_cubic(const double* xn, const int32_t* yfix,
                                const int64_t* starts, const int64_t* ends,
                                const double* w, int32_t* max_err, int64_t B,
                                int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep_max<RmiLeaf::kCubic>(xn, yfix, starts, ends, w, max_err, B,
                                           n_keys, bound, stream);
}

RMI_API int rmi_sweep_max_loglinear(const double* xn, const int32_t* yfix,
                                    const int64_t* starts, const int64_t* ends,
                                    const double* w, int32_t* max_err, int64_t B,
                                    int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep_max<RmiLeaf::kLoglinear>(xn, yfix, starts, ends, w, max_err,
                                               B, n_keys, bound, stream);
}

RMI_API int rmi_sweep_max_normal(const double* xn, const int32_t* yfix,
                                 const int64_t* starts, const int64_t* ends,
                                 const double* w, int32_t* max_err, int64_t B,
                                 int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep_max<RmiLeaf::kNormal>(xn, yfix, starts, ends, w, max_err, B,
                                            n_keys, bound, stream);
}
