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

}  // namespace

// longest_run holds B zeros.
RMI_API int rmi_span_run_max(const int64_t* keys, const int32_t* yfix,
                             const int64_t* starts, const int64_t* ends,
                             int32_t* longest_run, int64_t B, int64_t n,
                             void* stream) {
  const RunLength f{keys, yfix, n};
  return rmi_launch_span_max(f, starts, ends, B, n, longest_run, stream);
}
