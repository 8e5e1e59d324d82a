// The one leaf evaluation that the error sweep (sweep.cu), the epsilon
// probes and lookup (eval.cu) share.  Training measures each leaf's
// error with exactly the arithmetic that serving later uses, so the
// bound |guess - lower_bound| <= err holds by construction; this is the
// card's counterpart of the TPU rationale in rmi_tpu/ops/eval_kernel.py.
//
// Linear leaf: fma(beta, x, alpha), one rounding, as the reference
// (linear.rs:87-90) and as JAX computes it under jit on the CPU.  The
// plain PyTorch versions use torch.addcmul, which is the same FMA on the
// CPU (rmi_tpu_torch/models/linear.py).
#pragma once

#include <math.h>
#include <stdint.h>

// w is the [B, 2] f64 row-major table of (alpha, beta) rows.
__device__ __forceinline__ double rmi_linear_leaf(const double* __restrict__ w,
                                                  int64_t leaf, double x) {
  const double alpha = w[2 * leaf];
  const double beta = w[2 * leaf + 1];
  return fma(beta, x, alpha);
}

// min(bound, predict_to_int(v)): max(0, floor(v)) with NaN -> 0
// (models/mod.rs:735-737), clipped to [0, bound] with bound < 2^31.
__device__ __forceinline__ int32_t rmi_clamp_floor(double v, double bound) {
  double p = floor(v);
  if (isnan(p)) return 0;
  p = fmin(fmax(p, 0.0), bound);
  return (int32_t)p;
}
