// K4: clamped integer leaf predictions for linear leaves,
//   out[i] = clip(floor(fma(beta[leaf[i]], x[i], alpha[leaf[i]])), 0, bound)
// with NaN -> 0.  It serves the build's epsilon probes (bound n, one
// element per leaf) and lookup (bound n - 1, one element per query).
//
// Replaces rmi_tpu/ops/eval_kernel.py:_eval_kernel (leaf_eval_clamped),
// which takes parameter columns that XLA gathered beforehand and
// evaluates them in float-float.  Here the row gather, the evaluation
// and the clamp are one pass.
//
// Bound on the H100: memory and, for random lookups, the row gather.
// Per element it reads x (8 B) and a leaf id (8 B), gathers one 16-byte
// row and writes 4 B.  The table of B = 262144 rows is 4 MB and stays
// in L2, so random rows cost L2 latency rather than HBM traffic.  The
// evaluation is rmi_linear_leaf from leaf_eval.cuh, the function the
// error sweep (sweep.cu) measured the bounds with.
#include "common.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
leaf_eval_linear(const double* __restrict__ x, const double* __restrict__ w,
                 const int64_t* __restrict__ leaf, int32_t* __restrict__ out,
                 int64_t m, int64_t bound) {
  const double bound_f = (double)bound;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    out[i] = rmi_clamp_floor(rmi_linear_leaf(w, leaf[i], x[i]), bound_f);
  }
}

}  // namespace

RMI_API int rmi_leaf_eval_linear(const double* x, const double* w,
                                 const int64_t* leaf, int32_t* out, int64_t m,
                                 int64_t bound, void* stream) {
  if (m > 0) {
    leaf_eval_linear<<<rmi_grid(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        x, w, leaf, out, m, bound);
  }
  return (int)cudaGetLastError();
}
