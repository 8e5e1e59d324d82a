// The integer-output top models (radix, bradix, the radix hint tables,
// histogram) on the u64 bits of a thread's keys: the top branch of
// lookup's fused entry (eval.cu), kept apart for the other serving
// kernels that route a key through the top.
//
// Each evaluation is the port's torch code bit for bit (models/radix.py,
// models/histogram.py, on keys.py's u64 helpers), which tests hold to
// rmi_tpu's models; the plain version of the lookup that runs it is
// ops/eval_kernel.lookup_steps over those models, and its operands are
// eval_kernel.top_operands.  C++ leaves a shift by 64 or more undefined;
// keys.shl and keys.shr define it as 0, and so do rmi_shl and rmi_shr.
// A key of f64 type reaches the integer tops as keys.as_int of its value
// (clipped to [0, 2^64 - 1], truncated, NaN -> 0): rmi_as_int.
//
// Where the operand is read is the launch's route (RmiRoute,
// eval_kernel.top_route, chosen by the operand's size): a hint table
// whose rows fit FOLD_BYTES is folded into the leaf rows (the caller
// passes one lookup row a bucket, the row of the leaf its entry names,
// so the key's bucket is its row: no table read); a larger one is read
// in place through L1 and L2, its entries narrowed (eval_kernel.
// narrow_table: clamp_int(entry, B - 1), 16 bits an entry where B <= 2^16,
// else 32); a histogram's pivots are staged in each block's shared
// memory as a complete search tree where it fits, else read in place.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

// keys.as_int: the u64 bits the integer models read (an integer key's
// own, an f64 key's value clipped and truncated)
template <RmiKey K>
__device__ __forceinline__ uint64_t int_bits(int64_t image) {
  if constexpr (K == RmiKey::kF64) {
    return rmi_as_int(decoded<K>(image));
  } else {
    return (uint64_t)image ^ 0x8000000000000000ull;
  }
}

// The integer top kinds, numbered after the four leaf kernels that
// evaluate the affine tops (ops/eval_kernel.TOP_KINDS)
enum class RmiIntTop : int64_t { kRadix = 4, kBradix = 5, kTable = 6, kHistogram = 7 };

// Where the operand is read: in place (radix and bradix read none), a
// histogram's tree in each block's shared memory, or a hint table folded
// into the rows
enum class RmiRoute : int { kInPlace = 0, kBlock = 1, kFolded = 2 };

// A hint table holds 16-bit entries where B <= 2^16 (eval_kernel.table_width)
constexpr uint64_t kNarrowLast = 0xffff;

// One integer top as the launch hands it over: its kind, its packed
// parameters (radix: prefix, bits; bradix: prefix, bits, clamp, high;
// hint table: prefix, bits), its narrowed table or its pivots (sorted key
// images), their count, and the highest leaf, B - 1.
struct RmiIntTopArgs {
  int64_t kind;
  const int64_t* p;
  const int32_t* table;
  const int64_t* pivots;
  int64_t len;
  uint64_t last;
};

// The pivots' upper bound in place: the largest power of two <= len
// (0 for none), the first halving step
__host__ __device__ inline int64_t rmi_top_step(int64_t len) {
  int64_t step = len > 0 ? 1 : 0;
  while (step > 0 && step <= len / 2) step <<= 1;
  return step;
}

// Levels of the histogram's staged search tree: the bit length of len,
// so the tree's 2^h - 1 slots hold every pivot
__host__ __device__ inline int rmi_tree_levels(int64_t len) {
  int h = 0;
  while (h < 63 && (int64_t(1) << h) <= len) ++h;
  return h;
}

// The pivots as a complete binary search tree in `tree` (one block's
// shared memory, 2^h slots): slot k >= 1 at depth d holds sorted pivot
// ((2 (k - 2^d) + 1) << (h - 1 - d)) - 1, INT64_MAX past the last.  The
// block's threads fill it.
__device__ __forceinline__ void rmi_stage_tree(int64_t* tree, const int64_t* pivots,
                                               int64_t len, int h) {
  for (int64_t k = threadIdx.x; k < (int64_t(1) << h); k += blockDim.x) {
    int64_t v = INT64_MAX;
    if (k > 0) {
      const int d = 63 - __clzll(k);
      const int64_t i = ((2 * (k - (int64_t(1) << d)) + 1) << (h - 1 - d)) - 1;
      if (i < len) v = __ldg(pivots + i);
    }
    tree[k] = v;
  }
}

// The top's parameters, read once by each thread, and its evaluation on
// K keys at once, their reads issued together
struct RmiIntTopEval {
  int64_t kind;
  int64_t prefix, bits;   // radix, bradix, table
  uint64_t mask;          // table: the bits below the prefix
  int64_t shift;          // table: _table_shift
  uint64_t clamp;         // bradix
  bool high;              // bradix
  const int32_t* table;
  const int64_t* pivots;
  int64_t len, step0;
  int levels;             // the staged tree's h
  uint64_t last;

  __device__ __forceinline__ explicit RmiIntTopEval(const RmiIntTopArgs& a)
      : kind(a.kind), prefix(0), bits(0), mask(0), shift(0), clamp(0), high(false),
        table(a.table), pivots(a.pivots), len(a.len), step0(0), levels(0), last(a.last) {
    if (kind == (int64_t)RmiIntTop::kHistogram) {
      step0 = rmi_top_step(len);
      levels = rmi_tree_levels(len);
      return;
    }
    prefix = __ldg(a.p);
    bits = __ldg(a.p + 1);
    if (kind == (int64_t)RmiIntTop::kTable) {
      // _table_bucket, _table_shift (radix.rs:126-133)
      shift = prefix + bits > 64 ? 0 : 64 - prefix - bits;
      mask = rmi_shr(~0ull, prefix);
    } else if (kind == (int64_t)RmiIntTop::kBradix) {
      clamp = (uint64_t)__ldg(a.p + 2);
      high = __ldg(a.p + 3) != 0;
    }
  }

  // #{pivots <= image} in place: halving steps, each a read of one pivot
  // through L1 and L2 (histogram.rs:57-61)
  template <int K>
  __device__ __forceinline__ void upper_bound(const int64_t (&image)[K],
                                              int64_t (&lo)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) lo[k] = 0;
    for (int64_t step = step0; step > 0; step >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t j = lo[k] + step;
        if (j <= len && __ldg(pivots + j - 1) <= image[k]) lo[k] = j;
      }
    }
  }

  // #{pivots <= image} from the staged tree: a step a level, each taking
  // the right child where the slot's pivot is <= image; the path's bits
  // spell the count (the padding INT64_MAX counts only for image
  // INT64_MAX, and min(count, len) drops it)
  template <int K>
  __device__ __forceinline__ void tree_count(const int64_t* tree, const int64_t (&image)[K],
                                             int64_t (&count)[K]) const {
    uint32_t at[K];
#pragma unroll
    for (int k = 0; k < K; ++k) at[k] = 1;
    for (int s = 0; s < levels; ++s) {
#pragma unroll
      for (int k = 0; k < K; ++k) at[k] = 2 * at[k] + (tree[at[k]] <= image[k] ? 1 : 0);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = (int64_t)at[k] - (int64_t(1) << levels);
      count[k] = c < len ? c : len;
    }
  }

  // hint-table entry b, read in place
  __device__ __forceinline__ uint64_t entry(uint64_t b) const {
    return last > kNarrowLast ? __ldg(reinterpret_cast<const unsigned int*>(table) + b)
                              : __ldg(reinterpret_cast<const unsigned short*>(table) + b);
  }

  // clamp_int(top(u), B - 1) of K keys' u64 bits: the top's prediction,
  // then the UNSIGNED min with B - 1 (a histogram underflow, -1, goes to
  // the last leaf); under a folded table, the bucket: the row the kernel
  // reads for it is that leaf's
  template <RmiRoute R, int K>
  __device__ __forceinline__ void leaves(const uint64_t (&u)[K], const int64_t* tree,
                                         int64_t (&leaf)[K]) const {
    uint64_t pred[K];
    if (kind == (int64_t)RmiIntTop::kHistogram) {
      int64_t image[K], count[K];
#pragma unroll
      for (int k = 0; k < K; ++k) image[k] = (int64_t)(u[k] ^ 0x8000000000000000ull);
      if constexpr (R == RmiRoute::kBlock) {
        tree_count(tree, image, count);
      } else {
        upper_bound(image, count);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) pred[k] = (uint64_t)(count[k] - 1);
    } else if (kind == (int64_t)RmiIntTop::kTable) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint64_t b = rmi_shr(u[k] & mask, shift);
        b = b < (uint64_t)len ? b : (uint64_t)len - 1;     // < 2^bits = len already
        if constexpr (R == RmiRoute::kFolded) {
          pred[k] = b;
        } else {
          pred[k] = entry(b);
        }
      }
      if constexpr (R == RmiRoute::kFolded) {
#pragma unroll
        for (int k = 0; k < K; ++k) leaf[k] = (int64_t)pred[k];
        return;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t res = rmi_shr(rmi_shl(u[k], prefix), 64 - bits);
        if (kind == (int64_t)RmiIntTop::kRadix) {
          pred[k] = bits == 0 ? 0 : res;
        } else {          // bradix: clamped high, or shifted low
          pred[k] = high ? (res < clamp ? res : clamp) : (res < clamp ? 0 : res - clamp);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) leaf[k] = (int64_t)(pred[k] < last ? pred[k] : last);
  }
};

// Is an integer top's route one it can take, and how many bytes of
// shared memory does a block of it stage?  Route 0 reads the operand in
// place (radix and bradix read none); 1 stages a histogram's pivots in
// each block as their search tree; 2 reads a hint table folded into the
// rows, one a bucket (the caller's rows hold top_len of them).
inline bool rmi_int_route_ok(const RmiIntTopArgs& t, int64_t route, size_t* smem) {
  *smem = 0;
  switch (t.kind) {
    case (int64_t)RmiIntTop::kRadix:
    case (int64_t)RmiIntTop::kBradix:
      return t.p != nullptr && route == 0;
    case (int64_t)RmiIntTop::kTable:
      return t.p != nullptr && t.len >= 1 &&
             ((route == 0 && t.table != nullptr) || route == 2);
    case (int64_t)RmiIntTop::kHistogram:
      if (t.len < 0 || (t.len > 0 && t.pivots == nullptr)) return false;
      if (route == 0) return true;
      if (route != 1 || t.len < 1 || rmi_tree_levels(t.len) > 24) return false;
      *smem = (size_t)8 << rmi_tree_levels(t.len);
      return true;
    default:
      return false;
  }
}
