// Per-leaf maxima over the leaves' contiguous, sorted spans of the key
// array: out[j] = max(0, max f(j, i) for i in [starts[j], ends[j])),
// the walk that the error sweep (sweep.cu) and the duplicate-run pass
// (run_max.cu) share.  It takes the place of the segmented max that
// rmi_tpu/utils/segments.py:range_max builds from a hierarchy of
// 128-block maxima, and of the per-key array that max was taken over:
// the values never reach device memory.
//
// The work is cut by keys, not by leaves: each warp takes one chunk of
// kSpanChunk consecutive keys, finds the leaf that holds the chunk's
// first key by binary search over starts, and walks the leaves that meet
// the chunk.  For each it reduces its part of the span (lane-strided,
// then a shuffle tree) and one lane combines the part with atomicMax on
// the leaf's int32 slot, which the caller has set to 0.  A leaf of
// millions of keys is thus spread over thousands of warps and costs per
// key what 65536 small leaves cost; an integer max gives the same bits
// in any order, so the atomics change no result.  A run of empty leaves
// (equal starts) is skipped by a second binary search, so a chunk that
// holds the start of 262143 empty leaves does not walk them one by one.
//
// Spans must be sorted and disjoint: starts[j] <= ends[j] <= starts[j + 1]
// and ends[B - 1] <= n.  Keys that lie in no span are read by nobody.
#pragma once

#include "common.cuh"

constexpr int kSpanThreads = 256;        // 8 warps per block
constexpr int64_t kSpanChunk = 2048;     // keys per warp

// The count of a[lo : hi) <= v, plus lo, for sorted a.
__device__ __forceinline__ int64_t rmi_upper_bound(const int64_t* __restrict__ a,
                                                   int64_t lo, int64_t hi,
                                                   int64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// F has a type Row, Row row(int64_t j) const (what leaf j's keys share,
// loaded once per part) and int32_t operator()(const Row&, int64_t i)
// const, the value of key i, of which only those above 0 count.
template <class F>
__global__ void __launch_bounds__(kSpanThreads)
span_max(const F f, const int64_t* __restrict__ starts,
         const int64_t* __restrict__ ends, int64_t B, int64_t n,
         int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t nchunks = (n + kSpanChunk - 1) / kSpanChunk;
  for (int64_t c = warp; c < nchunks; c += nwarps) {       // warp-uniform
    const int64_t c0 = c * kSpanChunk;
    const int64_t c1 = min(c0 + kSpanChunk, n);
    // the last leaf that starts at or before the chunk
    int64_t j = rmi_upper_bound(starts, 0, B, c0) - 1;
    if (j < 0) j = 0;
    for (; j < B; ++j) {
      const int64_t s = starts[j];
      if (s >= c1) break;
      // of leaves with one start only the last can hold a key
      if (j + 1 < B && starts[j + 1] == s) {
        j = rmi_upper_bound(starts, j + 1, B, s) - 1;
      }
      const int64_t lo = max(s, c0);
      const int64_t hi = min(ends[j], c1);
      if (lo >= hi) continue;
      const typename F::Row row = f.row(j);
      int32_t m = 0;
#pragma unroll 4
      for (int64_t i = lo + lane; i < hi; i += 32) m = max(m, f(row, i));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = max(m, __shfl_xor_sync(RMI_FULL_MASK, m, off));
      }
      if (lane == 0 && m > 0) atomicMax(out + j, m);
    }
  }
}

// Launch span_max over n keys on `stream`; out holds B zeros.
template <class F>
int rmi_launch_span_max(const F& f, const int64_t* starts, const int64_t* ends,
                        int64_t B, int64_t n, int32_t* out, void* stream) {
  if (B > 0 && n > 0) {
    const int64_t nchunks = (n + kSpanChunk - 1) / kSpanChunk;
    span_max<F><<<rmi_grid(nchunks * 32, kSpanThreads), kSpanThreads, 0,
                  (cudaStream_t)stream>>>(f, starts, ends, B, n, out);
  }
  return (int)cudaGetLastError();
}
