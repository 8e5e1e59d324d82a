// K2: per-leaf centered moments of the linear leaf fit,
//   m2[j] = sum (x[i] - mean_x[j])^2
//   c[j]  = sum (x[i] - mean_x[j]) * (y[i] - mean_y[j])
// over the leaf's overlap-augmented range [aug_starts[j], aug_ends[j]).
//
// Replaces rmi_tpu/ops/select_kernel.py:_moments_kernel (window_moments)
// together with the per-leaf sums that follow it in
// rmi_tpu/utils/segments.py:683-720.  The TPU kernel selects each key's
// leaf means from a DMA'd window by one-hot matmul and writes the two
// per-key products in float-float to HBM for XLA to range-sum.  The
// card has f64, so this kernel fuses product and sum: the per-key
// products never reach device memory.
//
// Bound on the H100: memory.  It reads x and y once (16 B/key, 3.2 GB at
// n = 200M, about 1 ms at 3.35 TB/s) plus 48 B per leaf.  Simple design:
// one warp per leaf walks its range in a fixed order (lane-strided,
// then a shuffle tree), with no atomics, so every run gives the same
// bits.  The range holds the leaf's own keys plus at most one overlap
// key on each side, exactly the interior-plus-edge terms of
// segments.aug_centered_moments.  Known weakness: a leaf with millions
// of keys keeps one warp busy while the rest of the card idles; it is
// slow, never wrong.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 leaves per block

__global__ void __launch_bounds__(kThreads)
aug_moments(const double* __restrict__ x, const double* __restrict__ y,
            const double* __restrict__ mean_x, const double* __restrict__ mean_y,
            const int64_t* __restrict__ aug_starts,
            const int64_t* __restrict__ aug_ends,
            double* __restrict__ m2, double* __restrict__ c, int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j = warp; j < B; j += nwarps) {      // warp-uniform
    const int64_t lo = aug_starts[j], hi = aug_ends[j];
    const double mx = mean_x[j], my = mean_y[j];
    double sxx = 0.0, sxy = 0.0;
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const double dx = x[i] - mx;
      sxx += dx * dx;
      sxy += dx * (y[i] - my);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sxx += __shfl_down_sync(RMI_FULL_MASK, sxx, off);
      sxy += __shfl_down_sync(RMI_FULL_MASK, sxy, off);
    }
    if (lane == 0) {
      m2[j] = sxx;
      c[j] = sxy;
    }
  }
}

}  // namespace

RMI_API int rmi_aug_moments(const double* x, const double* y,
                            const double* mean_x, const double* mean_y,
                            const int64_t* aug_starts, const int64_t* aug_ends,
                            double* m2, double* c, int64_t B, void* stream) {
  if (B > 0) {
    aug_moments<<<rmi_grid(B * 32, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, mean_x, mean_y, aug_starts, aug_ends, m2, c, B);
  }
  return (int)cudaGetLastError();
}
