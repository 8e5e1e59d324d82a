// K6: per-leaf L1 sums of the cubic leaf fit's two candidates,
//   c_err[j] = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
//   l_err[j] = sum |fma(lb, x, la) - y|
// over the leaf's overlap-augmented range [aug_starts[j], aug_ends[j]),
// with (a, b, c, d) = cubic_w[j] and (la, lb) = lin_w[j].  The fit keeps
// the linear spline where l_err < c_err (cubic_spline.rs:113-135).
//
// Replaces rmi_tpu/ops/select_kernel.py:_select_kernel (window_select)
// together with what rmi_tpu/models/cubic.py:127-173 and 216-265 do with
// its output.  The TPU kernel DMAs a window of leaf rows and hands every
// key its leaf's six candidate parameters as f32 hi/lo pairs through a
// one-hot matmul, under an overflow flag, in chunks of 2^25 keys; XLA
// then evaluates both candidates and range-sums |pred - y|.  The card
// has f64 and gathers rows directly, so nothing per key reaches device
// memory: no window, no flag, no chunks.
//
// Bound on the H100: memory.  It reads x (8 B) and y (4 B) once per key,
// 2.4 GB at n = 200M, about 0.7 ms at 3.35 TB/s, plus 64 B of rows and
// bounds per leaf.  Design as K2 (moments.cu): one warp per leaf walks
// its range lane-strided, then a shuffle tree, with no atomics, so every
// run gives the same bits.  The range is the leaf's own keys plus at most
// one overlap key on each side: rmi_tpu's interior plus its has_prev and
// has_next edge terms.  The candidates are evaluated with the leaf
// functions K3 and K4 use (leaf_eval.cuh).  Known weakness: a leaf with
// millions of keys keeps one warp busy while the rest of the card idles;
// it is slow, never wrong.
#include "common.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;   // 8 leaves per block

__global__ void __launch_bounds__(kThreads)
cubic_l1(const double* __restrict__ x, const int32_t* __restrict__ y,
         const double* __restrict__ cubic_w, const double* __restrict__ lin_w,
         const int64_t* __restrict__ aug_starts,
         const int64_t* __restrict__ aug_ends, double* __restrict__ c_err,
         double* __restrict__ l_err, int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j = warp; j < B; j += nwarps) {      // warp-uniform
    const int64_t lo = aug_starts[j], hi = aug_ends[j];
    double sc = 0.0, sl = 0.0;
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const double xi = x[i];
      const double yi = (double)y[i];
      sc += fabs(rmi_cubic_leaf(cubic_w, j, xi) - yi);
      sl += fabs(rmi_linear_leaf(lin_w, j, xi) - yi);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sc += __shfl_down_sync(RMI_FULL_MASK, sc, off);
      sl += __shfl_down_sync(RMI_FULL_MASK, sl, off);
    }
    if (lane == 0) {
      c_err[j] = sc;
      l_err[j] = sl;
    }
  }
}

}  // namespace

RMI_API int rmi_cubic_l1(const double* x, const int32_t* y,
                         const double* cubic_w, const double* lin_w,
                         const int64_t* aug_starts, const int64_t* aug_ends,
                         double* c_err, double* l_err, int64_t B, void* stream) {
  if (B > 0) {
    cubic_l1<<<rmi_grid(B * 32, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, cubic_w, lin_w, aug_starts, aug_ends, c_err, l_err, B);
  }
  return (int)cudaGetLastError();
}
