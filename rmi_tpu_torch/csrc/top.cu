// Stage A of the build (train/two_layer.py, the rmi.build.assign range)
// after FixDups: the model's float input, the cubic top's two L1 sums and
// the leaf assignment, in three entries.
//
//   rmi_key_normalize   x[i] = (as_float(key[i]) - offset) * scale, f64:
//                       the normalized key (models.base.normalize) that
//                       the top fit, the assignment and stages B and C
//                       read;
//   rmi_top_l1_cubic    the whole-array sums
//                         c = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
//                         l = sum |fma(beta, x, alpha) - y|
//                       with y = trunc(yfix * sf) (two_layer._scale; yfix
//                       itself where sf does not scale): the cubic top
//                       keeps the linear spline where l < c
//                       (cubic_spline.rs:113-135);
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
              double sf, bool scaled, const double* __restrict__ cubic_w,
              const double* __restrict__ lin_w, double* __restrict__ partials) {
  double cw[4], lw[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) cw[k] = __ldg(cubic_w + k);
  lw[0] = __ldg(lin_w);
  lw[1] = __ldg(lin_w + 1);
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
// ... in order, then the block's tree; sums[0] cubic, sums[1] linear
__global__ void __launch_bounds__(kThreads)
top_l1_total(const double* __restrict__ partials, int64_t blocks, double* __restrict__ sums) {
  double sc = 0.0, sl = 0.0;
  for (int64_t j = threadIdx.x; j < blocks; j += kThreads) {
    sc += partials[2 * j];
    sl += partials[2 * j + 1];
  }
  block_sum(sc, sl);
  if (threadIdx.x == 0) {
    sums[0] = sc;
    sums[1] = sl;
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

// sums[0] (cubic) and sums[1] (linear) over the n keys of x and y, the
// targets y scaled by sf where scale_targets is nonzero; cubic_w the
// top's (a, b, c, d) row, lin_w its (alpha, beta) row; partials a scratch
// of 2 * capacity values, refused if it holds fewer than l1_blocks(n)
// blocks' (ops/top_kernel.L1_BLOCKS is kL1Blocks)
RMI_API int rmi_top_l1_cubic(const double* x, const int32_t* y, int64_t n, double sf,
                             int64_t scale_targets, const double* cubic_w, const double* lin_w,
                             double* partials, int64_t capacity, double* sums, void* stream) {
  const int64_t blocks = l1_blocks(n);
  if (n < 1 || capacity < blocks) return (int)cudaErrorInvalidValue;
  top_l1_blocks<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, sf, scale_targets != 0, cubic_w, lin_w, partials);
  top_l1_total<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, blocks, sums);
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
