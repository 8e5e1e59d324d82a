// K3: the build's error sweep.  Per key i,
//   err[i] = | clip(floor(leaf(w[t[i]], xn[i])), 0, n) - min(yfix[i], n) |
// with NaN -> 0 (rmi_tpu/train/two_layer.py:135-140, 269-280), where
// leaf is fma(beta, x, alpha) for linear rows, the three chained FMAs
// for cubic rows, exp1 of the linear leaf for loglinear rows and the
// logistic phi for normal rows (lognormal leaves pass max(ln x, 0) as
// xn); one C entry point per family.
//
// Replaces rmi_tpu/ops/sweep_kernel.py:_sweep_kernel (sweep_errors).
// The TPU kernel avoids per-key HBM gathers by DMAing each block's
// contiguous window of leaf rows and selecting rows with a one-hot
// matmul, evaluating in float-float because Mosaic has no f64; it
// needs an overflow flag and a retry when a block spans more leaves
// than the window.
//
// Bound on the H100: memory.  Per key it reads xn (8 B), yfix (4 B),
// t (4 B) and writes err (4 B): 20 B/key, 4 GB at n = 200M, about
// 1.2 ms at 3.35 TB/s.  The squarings and divisions of the loglinear
// and normal leaves (some 10 and 40 f64 operations per key, a division
// being a short Newton sequence) stay under that time: at the data
// sheet's 34 TFLOP/s of f64 outside the tensor cores the card does
// about 200 f64 operations in the time one key's 20 bytes take.  The
// leaf rows are gathered directly; leaf ids are non-decreasing, so
// neighbouring threads read the same or the next row, and the table
// (4 MB of linear rows at B = 262144, 2 MB of cubic rows and 1.5 MB of
// normal rows at B = 65536) stays in L2.  No window, no flag, no retry.
// The evaluation is rmi_leaf from leaf_eval.cuh, the function eval.cu
// serves with.
#include "common.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <RmiLeaf L>
__global__ void __launch_bounds__(kThreads)
sweep(const double* __restrict__ xn, const int32_t* __restrict__ yfix,
      const int32_t* __restrict__ t, const double* __restrict__ w,
      int32_t* __restrict__ err, int64_t n_keys, int64_t bound) {
  const double bound_f = (double)bound;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_keys;
       i += stride) {
    const int32_t pred = rmi_clamp_floor(rmi_leaf<L>(w, t[i], xn[i]), bound_f);
    const int32_t y = min(yfix[i], (int32_t)bound);
    const int32_t d = pred - y;
    err[i] = d < 0 ? -d : d;
  }
}

template <RmiLeaf L>
int launch_sweep(const double* xn, const int32_t* yfix, const int32_t* t,
                 const double* w, int32_t* err, int64_t n_keys, int64_t bound,
                 void* stream) {
  if (n_keys > 0) {
    sweep<L><<<rmi_grid(n_keys, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        xn, yfix, t, w, err, n_keys, bound);
  }
  return (int)cudaGetLastError();
}

}  // namespace

RMI_API int rmi_sweep_linear(const double* xn, const int32_t* yfix,
                             const int32_t* t, const double* w, int32_t* err,
                             int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep<RmiLeaf::kLinear>(xn, yfix, t, w, err, n_keys, bound, stream);
}

RMI_API int rmi_sweep_cubic(const double* xn, const int32_t* yfix,
                            const int32_t* t, const double* w, int32_t* err,
                            int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep<RmiLeaf::kCubic>(xn, yfix, t, w, err, n_keys, bound, stream);
}

RMI_API int rmi_sweep_loglinear(const double* xn, const int32_t* yfix,
                                const int32_t* t, const double* w, int32_t* err,
                                int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep<RmiLeaf::kLoglinear>(xn, yfix, t, w, err, n_keys, bound,
                                           stream);
}

RMI_API int rmi_sweep_normal(const double* xn, const int32_t* yfix,
                             const int32_t* t, const double* w, int32_t* err,
                             int64_t n_keys, int64_t bound, void* stream) {
  return launch_sweep<RmiLeaf::kNormal>(xn, yfix, t, w, err, n_keys, bound, stream);
}
