// K5: exact lower bounds searchsorted(keys, q, side="left") for a
// NON-DECREASING batch of int64 query images, through a sample level
// group_first = keys[::G] (G = 8 on the serving path):
//   c   = glo + #(group_first[glo : ghi] < q)         (the block's window)
//   row = max(c - 1, 0)
//   lb  = min(G row + #(keys[G row : G row + G] < q), n)
// Block b holds queries [b * kThreads, (b + 1) * kThreads), one per
// thread, and window bounds [lo_b, hi_b] counted in 64-key stripes,
// clamped to 0 <= lo_b <= hi_b <= ceil(n / 64) as the plain version
// clamps them; in groups of G keys (R = 64 / G, ng = ceil(n / G))
//   [glo, ghi] = [clamp(R lo_b - (R - 1), 0, ng), clamp(R hi_b, 0, ng)].
// If lo_b <= lb1 <= hi_b for lb1 = #(keys[::64] < q) = ceil(lb / 64),
// then 64 (lo_b - 1) < lb <= 64 hi_b, so c = ceil(lb / G) lies in
// [glo, ghi] and the count is exact; rmi_tpu_torch/lookup_fast.py
// derives such bounds from the leaf rows of each block's first and last
// query.  With an order (the scatter entry) the answer of sorted query i
// goes to out[order[i]], which fuses the unsort of a batch that
// torch.sort put in order.
//
// Replaces rmi_tpu/ops/sorted_serve_kernel.py:_serve_sorted_direct_kernel.
// That kernel DMAs a fixed-size window of [W0, 256] u32 level-0 rows per
// 2048-query block into VMEM, compares 16-bit chunks in f32 lanes and
// picks each query's stripe row with byte-plane one-hot matmuls; a host
// tier lattice chooses the window size and sparse batches fall back to
// gathers.  Here keys compare as int64 and only one sample level of the
// window is staged: copying every key of the window, as the TPU kernel
// does, would stream all 1.6 GB of keys per batch at 200M keys.
//
// Bound on the H100: device memory, in two streams.  (1) The staged
// window: one thread issues a cp.async.bulk of group_first[glo : ghi]
// (rounded out to 16-byte ends; an odd last entry is loaded by that
// thread) into shared memory onto an mbarrier while the others load
// their queries; the windows of a batch together cover group_first
// about once, n bytes per batch (200 MB at 200M keys).  (2) One G-key
// group per query: 64 bytes for G = 8, read as four independent 16-byte
// loads from one aligned span, so a query costs one round trip to one
// HBM burst.  The stripe search that came before made 6 dependent loads
// over ~5 scattered 32-byte sectors of its 64-key stripe per query.
// The window search itself runs in shared memory.  A block whose window
// exceeds kStageCap entries (a sparse batch) binary-searches
// group_first between its bounds in device memory instead: the same
// answer from the same kernel, so nothing is declined and no host round
// trip chooses a size.  G = 16 (one 128-byte line per query, half the
// stream) is built too, so the choice of G can be timed.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W
// limit, 2^22 sorted uniform queries over 200M keys: 0.2268 ms against
// a bound of 0.0679 ms (the queries, window bounds and answers once, the
// sectors holding keys[lb - 1] and keys[lb], a sector per window probe)
// and torch.searchsorted's 0.4469 ms; G = 16 0.32 ms; the stripe search
// before it 0.4676 ms.  PERF.md has the runs.
//
// The scatter entry's 8-byte answers land at random places of a 32 MB
// output (2^22 queries), which fits the 50 MB L2 only if the ~0.5 GB
// the kernel reads does not push it out.  So there every read (queries,
// order, window, groups) carries an L2 evict_first policy and every
// answer an evict_last one: the answers merge in L2.  The scatter entry
// took 0.2691 ms with them on the run above, 0.4717 ms without them on
// an earlier run of the same script (a separate out[order] = lb pass
// takes ~0.17 ms); the plain entry has nothing to keep and runs without
// them.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;            // queries per block, one per thread
constexpr int kStageCap = 6144;          // staged int64 group-first keys, 48 KB
constexpr int kStageBytes = kStageCap * 8;
constexpr int64_t kStripe = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// L2 policies: lines read once go first, the scattered answers stay
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

template <bool kHint>
__device__ __forceinline__ int64_t load(const int64_t* p, uint64_t pol) {
  if constexpr (!kHint) return *p;
  int64_t v;
  asm volatile("ld.global.nc.L2::cache_hint.s64 %0, [%1], %2;"
               : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

template <bool kHint>
__device__ __forceinline__ longlong2 load2(const longlong2* p, uint64_t pol) {
  if constexpr (!kHint) return __ldg(p);
  longlong2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.s64 {%0, %1}, [%2], %3;"
               : "=l"(v.x), "=l"(v.y) : "l"(p), "l"(pol));
  return v;
}

// one thread: copy `bytes` (a multiple of 16) from global `src` to shared
// `dst`, both 16-byte aligned, completing on the mbarrier at `bar`
template <bool kHint>
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  const uint64_t gsrc = reinterpret_cast<uint64_t>(src);
  if constexpr (kHint) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        ::"r"(smem_addr(dst)), "l"(gsrc), "r"(bytes), "r"(bar), "l"(pol)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(gsrc), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// First i in [0, len) with a[i] >= q, else len: the count of a[.] < q
// for sorted a.  `a` may point to shared or device memory.
__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t len,
                                               int64_t q) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int G, bool kScatter>
__global__ void __launch_bounds__(kThreads)
serve_sorted(const int64_t* __restrict__ q, const int64_t* __restrict__ order,
             int64_t nq, const int64_t* __restrict__ group_first, int64_t ng,
             const int64_t* __restrict__ keys, int64_t n,
             const int64_t* __restrict__ lo_b, const int64_t* __restrict__ hi_b,
             int64_t* __restrict__ out) {
  extern __shared__ __align__(16) int64_t stage[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int64_t R = kStripe / G;
  const int64_t b = blockIdx.x;
  const int64_t nrows0 = (n + kStripe - 1) / kStripe;
  const int64_t lo = min(max(lo_b[b], (int64_t)0), nrows0);
  const int64_t hi = min(max(hi_b[b], lo), nrows0);
  const int64_t glo = min(max(R * lo - (R - 1), (int64_t)0), ng);
  const int64_t ghi = min(R * hi, ng);
  const int64_t g0 = glo & ~(int64_t)1;        // 16-byte aligned start
  const bool staged = ghi - g0 <= kStageCap;   // the same for the whole block
  const uint32_t bar_addr = smem_addr(&bar);
  const uint64_t read_once = kScatter ? evict_first_policy() : 0;

  if (staged) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t g1 = ghi & ~(int64_t)1;    // bulk copy [g0, g1): 16-byte ends
      const uint32_t bytes = (uint32_t)((g1 - g0) * 8);
      if (g1 < ghi) stage[g1 - g0] = group_first[g1];   // odd last entry
      // arrive (release: the store above) and expect the copy's bytes
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_addr), "r"(bytes) : "memory");
      if (bytes) {
        bulk_copy<kScatter>(stage, group_first + g0, bytes, bar_addr, read_once);
      }
    }
  }

  // the queries load while the window is in flight
  const int64_t i = b * kThreads + threadIdx.x;
  const bool active = i < nq;
  int64_t qv = 0, dst = i;
  if (active) {
    qv = load<kScatter>(q + i, read_once);
    if (kScatter) dst = load<kScatter>(order + i, read_once);
  }

  int64_t c;
  if (staged) {
    // the barrier's phase 0 completes when the copy has landed
    uint32_t done = 0;
    const uint32_t parity = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar_addr), "r"(parity) : "memory");
    }
    if (!active) return;
    c = glo + lower_bound(stage + (glo - g0), ghi - glo, qv);
  } else {
    if (!active) return;
    c = glo + lower_bound(group_first + glo, ghi - glo, qv);
  }

  const int64_t s0 = (c > 0 ? c - 1 : 0) * G;
  int64_t cnt = 0;
  if (s0 + G <= n) {
    // one aligned G-key span: G / 2 independent 16-byte loads
    const longlong2* p = reinterpret_cast<const longlong2*>(keys + s0);
    longlong2 v[G / 2];
#pragma unroll
    for (int j = 0; j < G / 2; ++j) v[j] = load2<kScatter>(p + j, read_once);
#pragma unroll
    for (int j = 0; j < G / 2; ++j) cnt += (v[j].x < qv) + (v[j].y < qv);
  } else {
    for (int64_t k = s0; k < n; ++k) cnt += keys[k] < qv;
  }
  const int64_t lb = min(s0 + cnt, n);
  if constexpr (kScatter) {
    asm volatile("st.global.L2::cache_hint.s64 [%0], %1, %2;"
                 ::"l"(out + dst), "l"(lb), "l"(evict_last_policy()) : "memory");
  } else {
    out[dst] = lb;
  }
}

template <int G, bool kScatter>
int launch(const int64_t* q, const int64_t* order, int64_t nq,
           const int64_t* group_first, int64_t ng, const int64_t* keys,
           int64_t n, const int64_t* lo_b, const int64_t* hi_b, int64_t* out,
           cudaStream_t stream) {
  // the 48 KB stage and the mbarrier exceed the default 48 KB limit:
  // raise it once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(serve_sorted<G, kScatter>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int64_t blocks = (nq + kThreads - 1) / kThreads;
  serve_sorted<G, kScatter><<<(unsigned int)blocks, kThreads, kStageBytes,
                              stream>>>(q, order, nq, group_first, ng, keys,
                                        n, lo_b, hi_b, out);
  return (int)cudaGetLastError();
}

template <bool kScatter>
int serve(const int64_t* q, const int64_t* order, int64_t nq,
          const int64_t* group_first, int64_t ng, const int64_t* keys,
          int64_t n, const int64_t* lo_b, const int64_t* hi_b, int64_t kq,
          int64_t group, int64_t* out, void* stream) {
  if (kq != kThreads || (group != 8 && group != 16) ||
      ng != (n + group - 1) / group) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return group == 8
      ? launch<8, kScatter>(q, order, nq, group_first, ng, keys, n, lo_b, hi_b,
                            out, s)
      : launch<16, kScatter>(q, order, nq, group_first, ng, keys, n, lo_b, hi_b,
                             out, s);
}

}  // namespace

// out[i] = lower bound of q[i]
RMI_API int rmi_serve_sorted(const int64_t* q, int64_t nq,
                             const int64_t* group_first, int64_t ng,
                             const int64_t* keys, int64_t n,
                             const int64_t* lo_b, const int64_t* hi_b,
                             int64_t kq, int64_t group, int64_t* out,
                             void* stream) {
  return serve<false>(q, nullptr, nq, group_first, ng, keys, n, lo_b, hi_b, kq,
                      group, out, stream);
}

// out[order[i]] = lower bound of q[i]; order a permutation of [0, nq)
RMI_API int rmi_serve_sorted_scatter(const int64_t* q, const int64_t* order,
                                     int64_t nq, const int64_t* group_first,
                                     int64_t ng, const int64_t* keys, int64_t n,
                                     const int64_t* lo_b, const int64_t* hi_b,
                                     int64_t kq, int64_t group, int64_t* out,
                                     void* stream) {
  return serve<true>(q, order, nq, group_first, ng, keys, n, lo_b, hi_b, kq,
                     group, out, stream);
}
