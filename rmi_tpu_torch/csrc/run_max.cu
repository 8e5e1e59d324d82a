// The longest duplicate run of each leaf, the term the build adds to a
// leaf's error (lower_bound_correction.rs:104-125).  Per leaf j over its
// span of the sorted keys,
//   longest_run[j] = max (i - yfix[i] + 1) over the keys i of the span
//                    with i < n - 1 and keys[i + 1] != keys[i],
// 0 if there is none: yfix[i] is the first index of key i's run
// (FixDups), so i - yfix[i] + 1 is the run's length where i is its last
// key, and the array's final run, which the reference never flushes,
// counts 0.  Equal keys have equal leaf ids, so a run never straddles
// two leaves and the maximum over a leaf's run ends is the maximum over
// its keys' run lengths.
//
// Replaces the run-length half of rmi_tpu/train/two_layer.py:
// _run_lengths_i32 (a reverse scan_i32 over [n], rmi_tpu/ops/
// scan_kernel.py) and the segmented max over it
// (rmi_tpu/utils/segments.py:range_max, two_layer.py:339-341): one pass
// over the spans in place of an arange, a compare, two selects, a reverse
// running min and a subtraction, all [n], and a scatter of the result.
//
// Bound on the H100: memory.  Per key it reads the key (8 B; its right
// neighbour is the next lane's) and yfix (4 B): 12 B/key, 2.4 GB at
// n = 200M, about 0.72 ms at 3.35 TB/s.  The walk is span_max
// (span_max.cuh), as in sweep.cu.  Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at its 700 W limit, n = 200M: 0.9945-1.0293 ms.
//
// rmi_span_run_max_carry is the same pass over one rank's shard in the
// data-parallel build, over the rank's clip of each leaf's span, in
// global indices: a run's last key at shard position i ends at offset + i,
// and the shard's last key, whose run may go on into the ranks after,
// ends at *last_end (the global end its owner and the later ranks agree
// on); yfix holds global run starts (rmi_fixdups_carry), and the array's
// final run, ending at total - 1, counts 0.  A run crossing the shard's
// left edge is counted where it ends, by the rank that holds its last
// key, with its global start, so the ranks' maxima, met in one
// all_reduce(MAX), are the single-device ones.  It replaces the eager
// chain the dp build ran there (rmi_tpu's dist_run_bounds and
// segment_max, rmi_tpu/parallel/dp_trainer.py:151 and :730: a compare, an
// arange, a select, K1's reverse running min with its carry, the counted
// mask and a scatter of the run lengths over [m] int64 ids), with the same
// bytes as rmi_span_run_max.
#include "span_max.cuh"

namespace {

struct RunLength {
  struct Row {};

  const int64_t* keys;
  const int32_t* yfix;
  int64_t n;

  __device__ __forceinline__ Row row(int64_t) const { return Row{}; }

  __device__ __forceinline__ int32_t operator()(const Row&, int64_t i) const {
    if (i >= n - 1 || keys[i + 1] == keys[i]) return 0;
    return (int32_t)(i - yfix[i] + 1);
  }
};

// the shard form: i a shard position, offset its first key's global index
struct ShardRunLength {
  struct Row {};

  const int64_t* keys;
  const int32_t* yfix;
  int64_t n;                   // the shard's keys
  int64_t offset, total;       // its first key's global index; all keys
  const int64_t* last_end;     // the global end of the run of key n - 1

  __device__ __forceinline__ Row row(int64_t) const { return Row{}; }

  __device__ __forceinline__ int32_t operator()(const Row&, int64_t i) const {
    int64_t end = i + offset;
    if (i >= n - 1) {
      end = __ldg(last_end);
    } else if (keys[i + 1] == keys[i]) {
      return 0;
    }
    if (end >= total - 1) return 0;
    return (int32_t)(end - yfix[i] + 1);
  }
};

}  // namespace

// longest_run holds B zeros.
RMI_API int rmi_span_run_max(const int64_t* keys, const int32_t* yfix,
                             const int64_t* starts, const int64_t* ends,
                             int32_t* longest_run, int64_t B, int64_t n,
                             void* stream) {
  const RunLength f{keys, yfix, n};
  return rmi_launch_span_max(f, starts, ends, B, n, longest_run, stream);
}

// longest_run holds B zeros; starts and ends the clip spans in shard
// positions; last_end one int64; offset + n at most 2^31 and total above
// 0, or refused with cudaErrorInvalidValue.
RMI_API int rmi_span_run_max_carry(const int64_t* keys, const int32_t* yfix,
                                   const int64_t* starts, const int64_t* ends,
                                   int32_t* longest_run, int64_t B, int64_t n, int64_t offset,
                                   int64_t total, const int64_t* last_end, void* stream) {
  if (n < 0 || offset < 0 || offset + n > ((int64_t)1 << 31) || total < 1 ||
      last_end == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const ShardRunLength f{keys, yfix, n, offset, total, last_end};
  return rmi_launch_span_max(f, starts, ends, B, n, longest_run, stream);
}
