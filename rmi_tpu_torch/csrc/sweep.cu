// K3: the build's error sweep for linear leaves.  Per key i,
//   err[i] = | clip(floor(fma(beta[t[i]], xn[i], alpha[t[i]])), 0, n)
//              - min(yfix[i], n) |
// with NaN -> 0 (rmi_tpu/train/two_layer.py:135-140, 269-280).
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
// 1.2 ms at 3.35 TB/s.  The leaf rows are gathered directly; leaf ids
// are non-decreasing, so neighbouring threads read the same or the
// next 16-byte row and the 4 MB table (B = 262144) stays in L2.  No
// window, no flag, no retry.  The evaluation is rmi_linear_leaf from
// leaf_eval.cuh, the function eval.cu serves with.
#include "common.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sweep_linear(const double* __restrict__ xn, const int32_t* __restrict__ yfix,
             const int32_t* __restrict__ t, const double* __restrict__ w,
             int32_t* __restrict__ err, int64_t n_keys, int64_t bound) {
  const double bound_f = (double)bound;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_keys;
       i += stride) {
    const int32_t pred = rmi_clamp_floor(rmi_linear_leaf(w, t[i], xn[i]), bound_f);
    const int32_t y = min(yfix[i], (int32_t)bound);
    const int32_t d = pred - y;
    err[i] = d < 0 ? -d : d;
  }
}

}  // namespace

RMI_API int rmi_sweep_linear(const double* xn, const int32_t* yfix,
                             const int32_t* t, const double* w, int32_t* err,
                             int64_t n_keys, int64_t bound, void* stream) {
  if (n_keys > 0) {
    sweep_linear<<<rmi_grid(n_keys, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        xn, yfix, t, w, err, n_keys, bound);
  }
  return (int)cudaGetLastError();
}
