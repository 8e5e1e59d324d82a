// The integer-output top models (radix, bradix, the radix hint tables,
// histogram) on one key's u64 bits: the top branch of lookup's fused
// entry (eval.cu), kept apart for the other serving kernels that route a
// key through the top.
//
// Each evaluation is the port's torch code bit for bit (models/radix.py,
// models/histogram.py, on keys.py's u64 helpers), which tests hold to
// rmi_tpu's models; the plain version of the lookup that runs it is
// ops/eval_kernel.lookup_steps over those models, and its packed
// parameters are eval_kernel.top_operands.  C++ leaves a shift by 64 or
// more undefined; keys.shl and keys.shr define it as 0, and so do
// rmi_shl and rmi_shr.  A key of f64 type reaches the integer tops as
// keys.as_int of its value (clipped to [0, 2^64 - 1], truncated, NaN
// -> 0): rmi_as_int.
#pragma once

#include <math.h>
#include <stdint.h>

// keys.shl, keys.shr: logical shifts, 0 for an amount of 64 or more
__device__ __forceinline__ uint64_t rmi_shl(uint64_t x, int64_t a) {
  return a >= 64 ? 0 : x << (a < 0 ? 0 : a);
}

__device__ __forceinline__ uint64_t rmi_shr(uint64_t x, int64_t a) {
  return a >= 64 ? 0 : x >> (a < 0 ? 0 : a);
}

// keys.as_int of an f64 value: NaN and values <= 0 give 0, values from
// 2^64 all ones, the rest truncate toward zero
__device__ __forceinline__ uint64_t rmi_as_int(double f) {
  if (isnan(f) || f <= 0.0) return 0;
  if (f >= 18446744073709551616.0) return ~0ull;
  return __double2ull_rz(f);
}

// The integer top kinds, numbered after the four leaf kernels that
// evaluate the affine tops (ops/eval_kernel.TOP_KINDS)
enum class RmiIntTop : int64_t { kRadix = 4, kBradix = 5, kTable = 6, kHistogram = 7 };

// One integer top: its kind, its packed parameters (radix: prefix, bits;
// bradix: prefix, bits, clamp, high; hint table: prefix, bits), its
// table (a hint table's int32 entries) or pivots (a histogram's sorted
// key images), their length, and the highest leaf, B - 1.
struct RmiIntTopEval {
  int64_t kind;
  const int64_t* p;
  const int32_t* table;
  const int64_t* pivots;
  int64_t len;
  int64_t step0;        // the largest power of two <= len (0 for none)
  uint64_t last;

  // #{pivots <= image}: the pivots' upper bound by halving steps, every
  // probe a read of one pivot through L2 (histogram.rs:57-61)
  __device__ __forceinline__ int64_t upper_bound(int64_t image) const {
    int64_t lo = 0;
    for (int64_t step = step0; step > 0; step >>= 1) {
      if (lo + step <= len && __ldg(pivots + lo + step - 1) <= image) lo += step;
    }
    return lo;
  }

  // clamp_int(top(u), B - 1): the top's prediction of the u64 bits u,
  // then the UNSIGNED min with B - 1 (a histogram underflow, -1, goes to
  // the last leaf)
  __device__ __forceinline__ int64_t leaf(uint64_t u) const {
    uint64_t pred;
    if (kind == (int64_t)RmiIntTop::kHistogram) {
      pred = (uint64_t)(upper_bound((int64_t)(u ^ 0x8000000000000000ull)) - 1);
    } else {
      const int64_t prefix = __ldg(p), bits = __ldg(p + 1);
      if (kind == (int64_t)RmiIntTop::kTable) {
        // _table_bucket, _table_shift (radix.rs:126-133)
        const int64_t shift = prefix + bits > 64 ? 0 : 64 - prefix - bits;
        uint64_t b = rmi_shr(u & rmi_shr(~0ull, prefix), shift);
        b = b < (uint64_t)len ? b : (uint64_t)len - 1;     // < 2^bits = len already
        pred = (uint64_t)(int64_t)__ldg(table + b);
      } else {
        const uint64_t res = rmi_shr(rmi_shl(u, prefix), 64 - bits);
        if (kind == (int64_t)RmiIntTop::kRadix) {
          pred = bits == 0 ? 0 : res;
        } else {          // bradix: clamped high, or shifted low
          const uint64_t clamp = (uint64_t)__ldg(p + 2);
          pred = __ldg(p + 3) != 0 ? (res < clamp ? res : clamp)
                                   : (res < clamp ? 0 : res - clamp);
        }
      }
    }
    return (int64_t)(pred < last ? pred : last);
  }
};
