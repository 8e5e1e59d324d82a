// The leaf evaluations that the error sweep (sweep.cu), the epsilon
// probes and lookup (eval.cu) and the cubic leaf fit's L1 sums
// (cubic_l1.cu) share.  Training measures each leaf's error with exactly
// the arithmetic that serving later uses, so the bound
// |guess - lower_bound| <= err holds by construction; this is the card's
// counterpart of the TPU rationale in rmi_tpu/ops/eval_kernel.py.
//
// Linear leaf: fma(beta, x, alpha), one rounding, as the reference
// (linear.rs:87-90) and as JAX computes it under jit on the CPU.  Cubic
// leaf: three chained FMAs (cubic_spline.rs:140-150), the Horner chain
// XLA contracts on the CPU.  Loglinear leaf: exp1 of the linear leaf
// (linear.rs:177-180).  Normal leaf: phi((x - mean) / stdev) * scale
// with the logistic phi (normal.rs:24-26), with the two FMAs XLA forms
// under jit on the CPU; lognormal leaves run it on max(ln x, 0), which
// their callers compute outside the kernels (models/normal.py).  These
// replace the float-float leaf_eval_df64 and _exp1_df64 of
// rmi_tpu/ops/sweep_kernel.py:80-128: the card has f64, so -1.65451 is
// a plain f64 constant.  The plain PyTorch versions use torch.addcmul,
// which is the same FMA on the CPU (rmi_tpu_torch/models/linear.py,
// models/cubic.py, models/normal.py).
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

// w is the [B, 4] f64 row-major table of (a, b, c, d) rows.
__device__ __forceinline__ double rmi_cubic_leaf(const double* __restrict__ w,
                                                 int64_t leaf, double x) {
  const double* r = w + 4 * leaf;
  return fma(fma(fma(r[0], x, r[1]), x, r[2]), x, r[3]);
}

// (1 + v/64)^64 by six squarings (linear.rs:156-166, stdlib.rs:17-33);
// v / 64 is exact, so 1 + v / 64 rounds once, as the FMA XLA forms.
__device__ __forceinline__ double rmi_exp1(double v) {
  double b = 1.0 + v / 64.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) b = b * b;
  return b;
}

// w is the [B, 2] f64 row-major table of (alpha, beta) rows.
__device__ __forceinline__ double rmi_loglinear_leaf(const double* __restrict__ w,
                                                     int64_t leaf, double x) {
  return rmi_exp1(rmi_linear_leaf(w, leaf, x));
}

// w is the [B, 3] f64 row-major table of (mean, stdev, scale) rows.
// phi(z) = 1 / (1 + exp1(-1.65451 z)): XLA folds -1.65451 z / 64 into
// z * (-1.65451 / 64) and contracts both adds that follow a multiply, so
// exp1's base is fma(z, -1.65451 / 64, 1) and 1 + exp1 is
// fma(b5, b5, 1) with b5 the fifth square.
__device__ __forceinline__ double rmi_normal_leaf(const double* __restrict__ w,
                                                  int64_t leaf, double x) {
  const double* r = w + 3 * leaf;
  const double z = (x - r[0]) / r[1];
  double b = fma(z, -1.65451 / 64.0, 1.0);
#pragma unroll
  for (int k = 0; k < 5; ++k) b = b * b;
  return (1.0 / fma(b, b, 1.0)) * r[2];
}

// The leaf families the kernels are instantiated for.
enum class RmiLeaf { kLinear, kCubic, kLoglinear, kNormal };

// f64 values in one row of the family's table.
__host__ __device__ constexpr int rmi_leaf_width(RmiLeaf L) {
  return L == RmiLeaf::kCubic ? 4 : L == RmiLeaf::kNormal ? 3 : 2;
}

template <RmiLeaf L>
__device__ __forceinline__ double rmi_leaf(const double* __restrict__ w,
                                           int64_t leaf, double x) {
  if constexpr (L == RmiLeaf::kCubic) {
    return rmi_cubic_leaf(w, leaf, x);
  } else if constexpr (L == RmiLeaf::kLoglinear) {
    return rmi_loglinear_leaf(w, leaf, x);
  } else if constexpr (L == RmiLeaf::kNormal) {
    return rmi_normal_leaf(w, leaf, x);
  } else {
    return rmi_linear_leaf(w, leaf, x);
  }
}

// min(bound, predict_to_int(v)): max(0, floor(v)) with NaN -> 0
// (models/mod.rs:735-737), clipped to [0, bound] with bound < 2^31.
__device__ __forceinline__ int32_t rmi_clamp_floor(double v, double bound) {
  double p = floor(v);
  if (isnan(p)) return 0;
  p = fmin(fmax(p, 0.0), bound);
  return (int32_t)p;
}
