// K1: inclusive running max or min of an int32 vector, forward or
// reverse; positions past the end read as the op's identity `fill`.
//
// Replaces rmi_tpu/ops/scan_kernel.py:_scan_kernel (scan_i32), which
// streams [256, 128] blocks through a TPU core in grid order and carries
// the running value in SMEM from one grid step to the next.
//
// Bound on the H100: memory.  The op is one compare per element, so the
// floor is one read and one write of 4 bytes per key (8 B/key; 1.6 GB at
// n = 200M, about 0.5 ms at 3.35 TB/s).  Blocks run in no order here, so
// nothing can carry across them; the simple design is reduce-then-scan
// in three launches: (1) each 4096-element tile reduces to one value,
// (2) one block scans the tile totals into exclusive carries, (3) each
// tile rescans itself from shared memory and applies its carry.  That
// reads the input twice and writes once (12 B/key).  A single pass with
// decoupled look-back would save one read; max and min never round, so
// either form is bit-equal to torch.cummax / torch.cummin.
//
// Reverse scans walk logical positions l = 0..n-1 at physical index
// n-1-l: neighbouring threads still touch neighbouring addresses.
// Indices are 64-bit throughout.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096 elements per block
constexpr int kWarps = kThreads / 32;

// shared-memory skew: one pad word per 32 so that a thread's kItems
// consecutive elements do not all fall in the same banks
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

template <bool IS_MAX>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return IS_MAX ? max(a, b) : min(a, b);
}

__device__ __forceinline__ int64_t phys(int64_t l, int64_t n, bool reverse) {
  return reverse ? n - 1 - l : l;
}

// Inclusive scan across a warp.
template <bool IS_MAX>
__device__ __forceinline__ int32_t warp_scan(int32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(RMI_FULL_MASK, v, off);
    if (lane >= off) v = op<IS_MAX>(v, o);
  }
  return v;
}

// (1) one total per tile
template <bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const int32_t* __restrict__ v, int64_t n, int32_t fill,
            bool reverse, int32_t* __restrict__ agg) {
  __shared__ int32_t warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int32_t acc = fill;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    if (l < n) acc = op<IS_MAX>(acc, v[phys(l, n, reverse)]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = op<IS_MAX>(acc, __shfl_down_sync(RMI_FULL_MASK, acc, off));
  if (lane == 0) warp_tot[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t = warp_tot[0];
    for (int w = 1; w < kWarps; ++w) t = op<IS_MAX>(t, warp_tot[w]);
    agg[blockIdx.x] = t;
  }
}

// (2) exclusive scan of the nb tile totals, in place, by one block
template <bool IS_MAX>
__global__ void __launch_bounds__(1024)
tile_carry(int32_t* __restrict__ agg, int64_t nb, int32_t fill) {
  __shared__ int32_t warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t running = fill;
  for (int64_t base = 0; base < nb; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int32_t x = i < nb ? agg[i] : fill;
    const int32_t inc = warp_scan<IS_MAX>(x, lane);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int32_t wt = warp_scan<IS_MAX>(lane < nw ? warp_tot[lane] : fill, lane);
      warp_tot[lane] = wt;
    }
    __syncthreads();
    int32_t before = __shfl_up_sync(RMI_FULL_MASK, inc, 1);
    if (lane == 0) before = fill;
    if (warp > 0) before = op<IS_MAX>(before, warp_tot[warp - 1]);
    const int32_t chunk_total = warp_tot[nw - 1];
    if (i < nb) agg[i] = op<IS_MAX>(running, before);
    running = op<IS_MAX>(running, chunk_total);
    __syncthreads();   // warp_tot is rewritten by the next chunk
  }
}

// (3) rescan each tile from shared memory and apply its carry
template <bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
tile_apply(const int32_t* __restrict__ v, int32_t* __restrict__ out,
           int64_t n, int32_t fill, bool reverse,
           const int32_t* __restrict__ carry) {
  __shared__ int32_t tile[kTile + kTile / 32];
  __shared__ int32_t warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    tile[skew(k)] = l < n ? v[phys(l, n, reverse)] : fill;
  }
  __syncthreads();

  // serial inclusive scan of this thread's kItems consecutive elements
  const int first = threadIdx.x * kItems;
  int32_t items[kItems];
  int32_t acc = fill;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc = op<IS_MAX>(acc, tile[skew(first + k)]);
    items[k] = acc;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t inc = warp_scan<IS_MAX>(acc, lane);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      warp_tot[w] = op<IS_MAX>(warp_tot[w - 1], warp_tot[w]);
  }
  __syncthreads();
  int32_t before = __shfl_up_sync(RMI_FULL_MASK, inc, 1);
  if (lane == 0) before = fill;
  if (warp > 0) before = op<IS_MAX>(before, warp_tot[warp - 1]);
  before = op<IS_MAX>(before, carry[blockIdx.x]);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    tile[skew(first + k)] = op<IS_MAX>(items[k], before);
  __syncthreads();

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t l = base + k;
    if (l < n) out[phys(l, n, reverse)] = tile[skew(k)];
  }
}

template <bool IS_MAX>
void launch(const int32_t* v, int32_t* out, int64_t n, int32_t fill,
            bool reverse, int32_t* scratch, cudaStream_t s) {
  const int64_t nb = (n + kTile - 1) / kTile;
  tile_reduce<IS_MAX><<<(unsigned int)nb, kThreads, 0, s>>>(v, n, fill, reverse, scratch);
  tile_carry<IS_MAX><<<1, 1024, 0, s>>>(scratch, nb, fill);
  tile_apply<IS_MAX><<<(unsigned int)nb, kThreads, 0, s>>>(v, out, n, fill, reverse, scratch);
}

}  // namespace

// scratch: ceil(n / 4096) int32 tile carries (rmi_scan_tiles)
RMI_API int rmi_scan_i32(const int32_t* v, int32_t* out, int64_t n,
                         int32_t is_max, int32_t fill, int32_t reverse,
                         int32_t* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (is_max)
      launch<true>(v, out, n, fill, reverse != 0, scratch, s);
    else
      launch<false>(v, out, n, fill, reverse != 0, scratch, s);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rmi_fixdups: FixDups of sorted key images (models/mod.rs:143-185),
//   out[i] = the first index of keys[i]'s run of equal keys, int32,
// which train/two_layer.fixdups_i32 made as K1's running max over
// where(keys[i] != keys[i - 1], i, 0), three [n] temporaries before it.
//
// Replaces rmi_tpu/ops/scan_kernel.py:_scan_kernel as rmi_tpu's
// _fixdups_i32 (rmi_tpu/train/two_layer.py:77-84) calls it, with the
// arange, compare and select around it.
//
// Bound on the H100: memory.  An 8-byte key read and a 4-byte index
// written a key (2.4 GB at 200M keys, 0.72 ms at 3.35 TB/s).  The keys
// are sorted, so no carry has to cross from block to block: a warp takes
// kFixdupsWarpKeys keys, and where its first key continues the run before
// it, the run's first index is a lower bound of that key in keys[0, s),
// found by the warp in 32-way steps (the 32 keys before s first: most
// runs are short; at most 6 steps more over 2^31 keys).  Then rounds of
// 32 keys, kFixdupsBatch rounds loaded together, each a running max over
// (changed ? i : 0) by shuffles from the round before's.  One launch, no
// scratch, the same result in any order of the blocks; a max never
// rounds, so it is bit-equal to the plain version.
//
// rmi_fixdups_carry is the same pass over one rank's shard in the
// data-parallel build (parallel/dp_trainer.py:dist_fixdups), its
// results global: out[i] = offset + p for a key whose run starts at
// shard position p > 0, and *first, the global start of the shard's
// first run, for the keys of that run (p = 0), which may have begun on
// the ranks before (a run can span several shards, or a whole one).  It
// replaces the eager chain the dp build ran there (rmi_tpu's
// dist_fixdups, rmi_tpu/parallel/dp_trainer.py:137: a compare, an int32
// arange, a select, K1's running max and a maximum with the carry, five
// [m] passes, three of them writes), with the same bytes as rmi_fixdups.
// ---------------------------------------------------------------------------
namespace {

constexpr int kFixdupsThreads = 256;
constexpr int kFixdupsBatch = 8;                         // rounds loaded together
constexpr int64_t kFixdupsWarpKeys = 32 * kFixdupsBatch * 8;   // 2048 keys a warp

// the first index p in [0, s] with keys[p] == keys[s], s > 0, in every lane
__device__ int64_t run_start(const int64_t* __restrict__ keys, int64_t s, int lane) {
  const int64_t target = keys[s];
  int64_t lo = s > 32 ? s - 32 : 0, hi = s;      // the answer lies in [lo, hi]
  for (;;) {
    const int64_t len = hi - lo;
    const int64_t step = len <= 32 ? 1 : (len + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned int less = __ballot_sync(RMI_FULL_MASK, p < hi && keys[p] < target);
    const int k = __popc(less);                  // keys below target: a prefix of the probes
    if (step == 1 || k == 0) {
      if (k > 0 || lo == 0 || hi != s) return lo + k * step;
      // the 32 keys before s all equal it: search the rest of [0, s - 32)
      hi = lo;
      lo = 0;
      continue;
    }
    const int64_t next = lo + k * step;
    lo = lo + (k - 1) * step + 1;
    if (next < hi) hi = next;
  }
}

// kCarry: out = offset + p where p > 0, *first where p = 0 (the shard form)
template <bool kCarry>
__global__ void __launch_bounds__(kFixdupsThreads)
fixdups(const int64_t* __restrict__ keys, int32_t* __restrict__ out, int64_t n,
        int64_t offset, const int64_t* __restrict__ first) {
  const int lane = threadIdx.x & 31;
  const int64_t head = kCarry ? __ldg(first) : 0;   // the first run's global start
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t s = warp * kFixdupsWarpKeys; s < n; s += nwarps * kFixdupsWarpKeys) {
    const int64_t e = s + kFixdupsWarpKeys < n ? s + kFixdupsWarpKeys : n;
    // the running max before the first key: its run's start where the run
    // began before s (no changed index of the warp's is below it)
    int64_t running = (s > 0 && keys[s] == keys[s - 1]) ? run_start(keys, s, lane) : s;
    int64_t last = 0;                           // the key before the round's lane 0
    for (int64_t base = s; base < e; base += 32 * kFixdupsBatch) {
      int64_t k[kFixdupsBatch];
#pragma unroll
      for (int u = 0; u < kFixdupsBatch; ++u) {
        const int64_t i = base + u * 32 + lane;
        k[u] = i < e ? keys[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kFixdupsBatch; ++u) {
        const int64_t i = base + u * 32 + lane;
        int64_t prev = __shfl_up_sync(RMI_FULL_MASK, k[u], 1);
        if (lane == 0) prev = last;
        int64_t v = (i == s || k[u] == prev) ? 0 : i;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int64_t o = __shfl_up_sync(RMI_FULL_MASK, v, off);
          if (lane >= off) v = max(v, o);
        }
        v = max(v, running);
        if (i < e) out[i] = (int32_t)(kCarry ? (v == 0 ? head : v + offset) : v);
        running = __shfl_sync(RMI_FULL_MASK, v, 31);
        last = __shfl_sync(RMI_FULL_MASK, k[u], 31);
      }
    }
  }
}

}  // namespace

// keys sorted (as int64 images); n at most 2^31, or refused with
// cudaErrorInvalidValue
RMI_API int rmi_fixdups(const int64_t* keys, int32_t* out, int64_t n, void* stream) {
  if (n < 0 || n > ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t warps = (n + kFixdupsWarpKeys - 1) / kFixdupsWarpKeys;
    fixdups<false><<<rmi_grid(warps * 32, kFixdupsThreads), kFixdupsThreads, 0,
                     (cudaStream_t)stream>>>(keys, out, n, 0, nullptr);
  }
  return (int)cudaGetLastError();
}

// a shard of n sorted key images whose first lies at global index offset;
// first[0] the global start of its first run; offset + n at most 2^31, or
// refused with cudaErrorInvalidValue
RMI_API int rmi_fixdups_carry(const int64_t* keys, int32_t* out, int64_t n, int64_t offset,
                              const int64_t* first, void* stream) {
  if (n < 0 || offset < 0 || offset + n > ((int64_t)1 << 31) || first == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t warps = (n + kFixdupsWarpKeys - 1) / kFixdupsWarpKeys;
    fixdups<true><<<rmi_grid(warps * 32, kFixdupsThreads), kFixdupsThreads, 0,
                    (cudaStream_t)stream>>>(keys, out, n, offset, first);
  }
  return (int)cudaGetLastError();
}
