// Card probes: the nine feature and rate probes of
// probes/probe_pallas.py, each one C entry point, run by
// tools/probe_torch_kernels.py.  On the TPU they asked what Mosaic can
// lower (64-bit compares, gathers from a VMEM table, index-driven row
// DMAs) before the serving kernels were designed around the answers.
// Here each computes what its TPU kernel computes with the card's own
// means, and asks the matching question of this card:
//
//   A   rmi_probe_scale2         t_a   :53   o = 2 x: the source builds and launches
//   B1  rmi_probe_lt_i64         t_b1  :67   int64 x < q in registers
//   B2  rmi_probe_lt_u64         t_b2  :83   uint64 x < q on bits carried as int64
//   B3  rmi_probe_lt_u32pair     t_b3  :105  u64 x < q as (hi, lo) u32 pairs
//   C1  rmi_probe_gather_rows    t_c1  :120  tbl[idx, :] gathered through L2, a group of lanes a row
//   C2  rmi_probe_take           t_c2  :135  take(tbl, idx) through L2, one output a thread
//   C3  rmi_probe_take_lanes     t_c3  :150  take_along_axis over a row's lanes
//   D   rmi_probe_row_ring       _dma_rate :194  pipelined random-row bulk copies
//   E   rmi_probe_row_copy       t_e   :261  index-driven row copies, spread over the card
//
// None is bound by device memory at the probe's shapes (a few KB to
// 256 KB): A-C and E take a launch's latency.  C1 and C2 ask whether a
// gather should first stage its table in fast memory, as the TPU's must
// in VMEM.  Here it should not: a table that is read once is gathered
// where it lies, through the 50 MB L2, with wide read-only loads, and
// staging it in shared memory costs more than it saves (a block would
// read the whole table to use a part, and the table's size would be
// bounded by a block's shared memory).  D is the measurement: the
// rate at which one SM, with one to sixteen issuing warps, and the whole
// card fetch random rows with cp.async.bulk onto mbarriers, which is how
// sorted_serve.cu stages its windows.  B2 against B3 over a large array
// asks whether comparing u64 keys as u32 pairs costs anything here.
//
// Measured by tools/probe_torch_kernels.py on an NVIDIA H100 80GB HBM3
// at its 700 W limit.  D: one issuing warp fetches a row in 170 ns
// whatever its width (512 B to 8 KB; 280 ns while its loop divided by
// nrows and by the ring's depth): its own wait, read, fence and next
// start bound it, not the copy.  One block's rate grows with its issuing
// warps, 85 / 43 / 23 ns a row at 2 / 4 / 8, and stops rising at 8 warps
// for 1-4 KB rows (45-179 GB/s for the SM) and at 4 for 8 KB rows (192
// GB/s, ~200 KB in flight); at 512 B 16 warps still gain (13 ns), at
// 2-4 KB they lose (62-75 ns) with rings half as deep.  132 blocks of one
// warp take 1.29 ns a row up to 4 KB rows and 2.61 ns per 8 KB row (3.1
// TB/s).  The whole-card form, the probe's 4096 fetches over 128 blocks
// of 8 warps, takes 2.5-2.6 us of device time at 512 B rows and 6.2-6.7
// us at 8 KB (profiler) with the walk's 33.5 MB left in L2 by the call
// before, and 3.3-3.5 and 12.9-13.5 us cold, each call walking rows that
// are not in L2 (0.0150 ms a call at 8 KB, 2.6 TB/s); a call timed alone
// by CUDA events reads 10.7-10.8 us warm, 17.5 cold and 22.3-22.9 after
// L2 was filled with dirty lines.  No other split of the walk (1-4
// fetches a warp, 2-16 warps a block) was faster warm by more than 0.12
// us.  B2
// over 2^26 random elements takes 0.445 ms (20 B per element, 3.0 TB/s);
// B3 0.281 ms: it reads the low halves only where the high halves tie,
// 12 B per element on random keys (2.9 TB/s).  Both run at the memory
// rate: the pair compare costs no time, and nothing is gained by it
// unless the halves are stored apart.  C1 and C2 at the probes' shapes
// (tools/time_torch_launch.py): 1.35 and 1.27 us of device time against
// 1.44 for torch.index_select and 2.79 for torch.take.  At scale: 2^18
// random 512-byte rows of a 128 MB table at 2.6 TB/s (index_select 1.6);
// 8 KB rows at 2.8 (2.9); 2^24 random entries of a 16 MB table in 0.149
// ms (take 0.159-0.168), of a 256 MB one in 0.549-0.552 (0.570).  PERF.md
// has the runs.
//
// The (8, 128) tile of the TPU probes is a shape here, not a unit: the
// elementwise probes run a grid-stride loop over any n.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 16;            // D: most slots per issuing warp
constexpr int kRingMaxWarps = 16;        // D: most issuing warps per block
constexpr int64_t kRingStep = 7919;      // D's walk: row j is (j * 7919) mod nrows
constexpr int kMaxDynamicShared = 232448;   // 227 KB, the most a block may ask for
constexpr int kSharedPerSM = 233472;        // 228 KB of shared memory on each SM
constexpr int kCopyWarps = 4;               // E: warps per block
constexpr int kCopyThreads = 32 * kCopyWarps;
constexpr int kMaxRing = 4;                 // E: slots per warp
constexpr int kMaxShare = 8192;             // E: rows (indices staged) per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- A, B1-B3: elementwise ------------------------------------------------

__global__ void __launch_bounds__(kThreads)
scale2(const float* __restrict__ x, float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = x[i] * 2.0f;
  }
}

// T = int64_t: the signed compare; T = uint64_t: the same bits unsigned
template <class T>
__global__ void __launch_bounds__(kThreads)
less_than(const T* __restrict__ x, const T* __restrict__ q,
          int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = x[i] < q[i] ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
less_than_pair(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
               const uint32_t* __restrict__ qh, const uint32_t* __restrict__ ql,
               int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t h = hi[i], g = qh[i];
    out[i] = (h < g || (h == g && lo[i] < ql[i])) ? 1 : 0;
  }
}

// --- C1-C3: gathers -------------------------------------------------------

// C1.  out[i, :] = tbl[idx[i], :] straight from where the table lies: a
// gathered row is read once, so it comes through L2 to the registers and
// is stored, with no stage in shared memory.  A group of G = 2^lg lanes
// (G <= 32, one warp for rows of 32 units or more) takes a row: its
// lanes read the row's index with one load instruction, then move the
// row in units of V (float4 where the rows and both pointers allow it,
// else float), lane c units c, c + G, ..., four loads issued before
// their stores while four remain, then one at a time.  Groups walk the
// rows grid-stride.
template <class V>
__global__ void __launch_bounds__(kThreads)
gather_rows(const V* __restrict__ tbl, const int32_t* __restrict__ idx,
            V* __restrict__ out, int64_t units, int64_t nq, int lg) {
  const int G = 1 << lg;
  const int lane = threadIdx.x & (G - 1);
  const int64_t stride = ((int64_t)gridDim.x * blockDim.x) >> lg;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lg; i < nq;
       i += stride) {
    const V* src = tbl + (int64_t)__ldg(idx + i) * units;
    V* dst = out + i * units;
    int64_t c = lane;
    for (; c + 3 * G < units; c += 4 * G) {
      const V a = __ldg(src + c), b = __ldg(src + c + G), d = __ldg(src + c + 2 * G),
              e = __ldg(src + c + 3 * G);
      dst[c] = a;
      dst[c + G] = b;
      dst[c + 2 * G] = d;
      dst[c + 3 * G] = e;
    }
    for (; c < units; c += G) dst[c] = __ldg(src + c);
  }
}

// C2.  out[i] = tbl[idx[i]], the table read where it lies, one output a
// thread: at the probe's 1024 outputs that spreads the random reads over
// four SMs where four outputs a thread (a 16-byte load of indices, four
// reads, a 16-byte store) put them on one and took longer; at 2^24
// outputs the two forms tie.
__global__ void __launch_bounds__(kThreads)
take(const float* __restrict__ tbl, const int32_t* __restrict__ idx,
     float* __restrict__ out, int64_t nq) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nq; i += stride) {
    out[i] = __ldg(tbl + __ldg(idx + i));
  }
}

// C3.  The gather runs across the 128 lanes of a row; a warp has 32.  No
// shared memory: every warp of a row's block holds the whole row, four
// values per lane (v[k] = row[32 k + lane]), and the thread of output
// column c fetches row[idx[c]] with four __shfl_sync from lane
// idx & 31, keeping the one of k = idx >> 5.  One block of 128 threads
// per row; width is fixed at 128.
__global__ void __launch_bounds__(128)
take_lanes(const float* __restrict__ tbl, const int32_t* __restrict__ idx,
           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float* row = tbl + (int64_t)blockIdx.x * 128;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = row[32 * k + lane];
  const int64_t o = (int64_t)blockIdx.x * 128 + threadIdx.x;
  const int j = idx[o];
  float got = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float s = __shfl_sync(RMI_FULL_MASK, v[k], j & 31);
    if ((j >> 5) == k) got = s;
  }
  out[o] = got;
}

// --- D, E: rows copied by cp.async.bulk onto mbarriers ---------------------

__device__ __forceinline__ void barrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// one thread: expect `bytes` on the barrier's current phase and start the
// copy of `bytes` (a multiple of 16) from global `src` to shared `dst`,
// both 16-byte aligned
__device__ __forceinline__ void row_copy_start(void* dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(bar)
      : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// order this thread's generic reads of shared memory before the bulk
// copy (async proxy) that overwrites it
__device__ __forceinline__ void fence_before_bulk_copy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// D's shared memory: each warp's `depth` mbarriers, rounded up to 128
// bytes, then each warp's ring of `depth` rows
__host__ __device__ __forceinline__ size_t ring_bars_bytes(int warps, int depth) {
  return ((size_t)warps * depth * sizeof(uint64_t) + 127) / 128 * 128;
}

// D.  Streams of bulk row copies, one per issuing warp.  The walk is
// rows (j * 7919) mod nrows for j < fetches; with S = gridDim.x * warps
// streams, stream s = blockIdx.x * warps + warp takes j = s, s + S, ...
// (one stream: the TPU probe's walk in order; several: no two fetch one
// row at one time, and a row comes round again only after nrows other
// fetches).  Lane 0 of each warp keeps `depth` copies in flight in the
// warp's own ring: its copy k goes to slot k mod depth on that slot's
// own mbarrier, phase parity (k / depth) & 1; it waits for each copy in
// turn, reads the row's first value, adds it up and starts copy
// k + depth into the slot just read.  The issuing loop does no division:
// slot and parity wrap by compare, and the next row is the last plus
// (S * 7919) mod nrows, less nrows if that passes it.  out[s] is stream
// s's f32 running sum, in its order.
//
// What bounds it: one issuing thread's loop (wait, read, fence, start)
// took ~280 ns a row whatever the width, so the design puts up to 16
// issuing warps on an SM, each its own loop and ring, and spreads the
// walk over the card in the whole-card form.
__global__ void __launch_bounds__(32 * kRingMaxWarps)
row_ring(const float* __restrict__ tbl, int64_t nrows, int width, int64_t fetches,
         int depth, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x & 31) return;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * depth;
  float* ring = reinterpret_cast<float*>(smem + ring_bars_bytes(warps, depth)) +
                (int64_t)warp * depth * width;
  const int64_t S = (int64_t)gridDim.x * warps;
  const int64_t s = (int64_t)blockIdx.x * warps + warp;
  const int64_t n = s < fetches ? (fetches - 1 - s) / S + 1 : 0;
  const int64_t step = (S % nrows) * kRingStep % nrows;
  const uint32_t bytes = (uint32_t)width * 4u;
  for (int k = 0; k < depth; ++k) barrier_init(smem_addr(&bars[k]));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  int64_t row = s % nrows * kRingStep % nrows;   // of the next copy to start
  int64_t started = 0;
  for (; started < n && started < depth; ++started) {
    row_copy_start(ring + started * width, tbl + row * width, bytes,
                   smem_addr(&bars[started]));
    row += step;
    if (row >= nrows) row -= nrows;
  }
  float acc = 0.0f;
  int slot = 0;
  uint32_t parity = 0;
  for (int64_t k = 0; k < n; ++k) {
    const uint32_t bar = smem_addr(&bars[slot]);
    float* dst = ring + (int64_t)slot * width;
    barrier_wait(bar, parity);
    acc += *reinterpret_cast<volatile float*>(dst);
    if (started < n) {
      fence_before_bulk_copy();
      row_copy_start(dst, tbl + row * width, bytes, bar);
      ++started;
      row += step;
      if (row >= nrows) row -= nrows;
    }
    if (++slot == depth) {
      slot = 0;
      parity ^= 1u;
    }
  }
  out[s] = acc;
}

// E.  The rows spread over the card.  Block b copies the rows
// [b share, (b + 1) share) of idx, whose indices it stages in shared
// memory first.  Each of its warps owns `ring` slots, each on its own
// mbarrier, and takes the block's rows warp, warp + kCopyWarps, ...: its
// lane 0 keeps `ring` bulk copies in flight (the warp's copy k in slot
// k % ring, parity (k / ring) & 1); the warp waits for a row, writes it
// out with 16-byte stores from all lanes, and once every lane has read
// the slot (__syncwarp) lane 0 starts the warp's copy k + ring into it.
// No block-wide barrier follows the staging of the indices.
__global__ void __launch_bounds__(kCopyThreads)
row_copy(const int32_t* __restrict__ idx, const float* __restrict__ x,
         float* __restrict__ out, int width, int64_t nq, int share, int ring) {
  extern __shared__ __align__(128) float stage[];   // [warps, ring, width], then idx [share]
  __shared__ __align__(8) uint64_t bars[kCopyWarps * kMaxRing];
  const int64_t r0 = (int64_t)blockIdx.x * share;
  const int cnt = (int)min((int64_t)share, nq - r0);
  int32_t* sidx = reinterpret_cast<int32_t*>(stage + (int64_t)kCopyWarps * ring * width);
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) sidx[e] = idx[r0 + e];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* wbars = bars + warp * kMaxRing;
  float* slots = stage + (int64_t)warp * ring * width;
  if (lane == 0) {
    for (int k = 0; k < ring; ++k) barrier_init(smem_addr(&wbars[k]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint32_t bytes = (uint32_t)width * 4u;
  const int nk = cnt > warp ? (cnt - warp + kCopyWarps - 1) / kCopyWarps : 0;
  if (lane == 0) {
    for (int k = 0; k < min(ring, nk); ++k) {
      row_copy_start(slots + (int64_t)k * width,
                     x + (int64_t)sidx[warp + k * kCopyWarps] * width, bytes,
                     smem_addr(&wbars[k]));
    }
  }
  const int vecs = width / 4;
  for (int k = 0; k < nk; ++k) {
    const int slot = k % ring;
    float* src = slots + (int64_t)slot * width;
    barrier_wait(smem_addr(&wbars[slot]), (uint32_t)(k / ring) & 1u);
    const float4* from = reinterpret_cast<const float4*>(src);
    float4* to = reinterpret_cast<float4*>(out + (r0 + warp + (int64_t)k * kCopyWarps) * width);
    for (int c = lane; c < vecs; c += 32) to[c] = from[c];
    __syncwarp();
    if (lane == 0 && k + ring < nk) {
      fence_before_bulk_copy();
      row_copy_start(src, x + (int64_t)sidx[warp + (k + ring) * kCopyWarps] * width,
                     bytes, smem_addr(&wbars[slot]));
    }
  }
}

// Let `kernel` ask for `bytes` of dynamic shared memory (above the 48 KB
// a kernel gets unasked).  `allowed` holds, per device, what the kernel
// was granted, so the attribute is set only when a launch needs more.
template <class K>
cudaError_t allow_shared(K kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  if (bytes > (size_t)kMaxDynamicShared) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

// the current device's SM count, asked once per device
cudaError_t sm_count(int* sms) {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = counts[dev];
  return cudaSuccess;
}

}  // namespace

RMI_API int rmi_probe_scale2(const float* x, float* out, int64_t n, void* stream) {
  if (n > 0) {
    scale2<<<rmi_grid(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}

RMI_API int rmi_probe_lt_i64(const int64_t* x, const int64_t* q, int32_t* out,
                             int64_t n, void* stream) {
  if (n > 0) {
    less_than<int64_t><<<rmi_grid(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        x, q, out, n);
  }
  return (int)cudaGetLastError();
}

// x and q hold uint64 values in int64 storage
RMI_API int rmi_probe_lt_u64(const int64_t* x, const int64_t* q, int32_t* out,
                             int64_t n, void* stream) {
  if (n > 0) {
    less_than<uint64_t><<<rmi_grid(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint64_t*>(x), reinterpret_cast<const uint64_t*>(q),
        out, n);
  }
  return (int)cudaGetLastError();
}

// hi, lo, qh and ql hold uint32 values in int32 storage
RMI_API int rmi_probe_lt_u32pair(const int32_t* hi, const int32_t* lo,
                                 const int32_t* qh, const int32_t* ql,
                                 int32_t* out, int64_t n, void* stream) {
  if (n > 0) {
    less_than_pair<<<rmi_grid(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint32_t*>(hi), reinterpret_cast<const uint32_t*>(lo),
        reinterpret_cast<const uint32_t*>(qh), reinterpret_cast<const uint32_t*>(ql),
        out, n);
  }
  return (int)cudaGetLastError();
}

// out[i, :] = tbl[idx[i], :]; tbl [nrows, width], 0 <= idx[i] < nrows
// (not checked).  16-byte units where width is a multiple of 4 and tbl
// and out start on 16-byte boundaries, else 4-byte units; lanes per row
// the least power of two that covers a row's units, at most 32.
RMI_API int rmi_probe_gather_rows(const float* tbl, const int32_t* idx, float* out,
                                  int64_t nrows, int64_t width, int64_t nq,
                                  void* stream) {
  if (nrows <= 0 || width <= 0 || nq <= 0) return (int)cudaGetLastError();
  const bool vec = width % 4 == 0 && ((uintptr_t)tbl & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const int64_t units = vec ? width / 4 : width;
  int lg = 0;
  while (lg < 5 && ((int64_t)1 << lg) < units) ++lg;
  const unsigned int blocks = rmi_grid(nq << lg, kThreads);
  if (vec) {
    gather_rows<float4><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(tbl), idx, reinterpret_cast<float4*>(out), units,
        nq, lg);
  } else {
    gather_rows<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(tbl, idx, out, units,
                                                                      nq, lg);
  }
  return (int)cudaGetLastError();
}

// out[i] = tbl[idx[i]]; tbl [ntbl], 0 <= idx[i] < ntbl (not checked)
RMI_API int rmi_probe_take(const float* tbl, const int32_t* idx, float* out,
                           int64_t ntbl, int64_t nq, void* stream) {
  if (ntbl > 0 && nq > 0) {
    take<<<rmi_grid(nq, kThreads), kThreads, 0, (cudaStream_t)stream>>>(tbl, idx, out, nq);
  }
  return (int)cudaGetLastError();
}

// out[r, c] = tbl[r, idx[r, c]]; tbl, idx and out [rows, 128], 0 <= idx < 128
RMI_API int rmi_probe_take_lanes(const float* tbl, const int32_t* idx, float* out,
                                 int64_t rows, int64_t width, void* stream) {
  if (width != 128) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    take_lanes<<<(unsigned int)rows, 128, 0, (cudaStream_t)stream>>>(tbl, idx, out);
  }
  return (int)cudaGetLastError();
}

// out[s] = sum of tbl[(j * 7919) mod nrows, 0] over j = s, s + S, ...
// below fetches, S = blocks * warps, each row fetched whole; tbl
// [nrows, width] f32 on a 16-byte boundary, width a multiple of 4,
// 1 <= slots <= 16, 1 <= warps <= 16, out [S].  Each warp's ring is
// min(slots, ceil(fetches / S), what 227 KB of shared memory holds for
// `warps` rings) deep: at 8 KB rows and 8 warps, 3.
RMI_API int rmi_probe_row_ring(const float* tbl, int64_t nrows, int64_t width,
                               int64_t fetches, int64_t slots, int64_t blocks,
                               int64_t warps, float* out, void* stream) {
  if (nrows <= 0 || width <= 0 || width % 4 || width > (1 << 20) || fetches < 0 ||
      slots < 1 || slots > kMaxSlots || blocks < 1 || blocks > INT32_MAX || warps < 1 ||
      warps > kRingMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t row = (size_t)width * sizeof(float);
  const int64_t per = (fetches + blocks * warps - 1) / (blocks * warps);
  int depth = (int)std::max<int64_t>(1, std::min<int64_t>(slots, per));
  const auto need = [&](int d) { return ring_bars_bytes((int)warps, d) + warps * d * row; };
  while (depth > 1 && need(depth) > (size_t)kMaxDynamicShared) --depth;
  const size_t bytes = need(depth);
  if (bytes > (size_t)kMaxDynamicShared) return (int)cudaErrorInvalidValue;
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_shared(row_ring, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  row_ring<<<(unsigned int)blocks, (unsigned int)(32 * warps), bytes, (cudaStream_t)stream>>>(
      tbl, nrows, (int)width, fetches, depth, out);
  return (int)cudaGetLastError();
}

// out[i, :] = x[idx[i], :]; x [nrows, width] f32 on a 16-byte boundary,
// width a multiple of 4, 0 <= idx[i] < nrows.  Blocks of kCopyWarps
// warps, enough for a row per warp up to what the SMs hold at once, each
// with at most kMaxShare rows; rings as deep as shared memory allows,
// up to kMaxRing slots per warp.
RMI_API int rmi_probe_row_copy(const int32_t* idx, const float* x, float* out,
                               int64_t width, int64_t nq, void* stream) {
  if (width <= 0 || width % 4 || nq < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaGetLastError();
  const size_t row = (size_t)width * sizeof(float);
  int ring = kMaxRing;
  while (ring > 1 && kCopyWarps * ring * row + kMaxShare * sizeof(int32_t) >
                         (size_t)kMaxDynamicShared) {
    --ring;
  }
  const size_t slot_bytes = kCopyWarps * ring * row;
  if (slot_bytes + kMaxShare * sizeof(int32_t) > (size_t)kMaxDynamicShared) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_sm = std::max<int64_t>(
      1, std::min<int64_t>(16, kSharedPerSM / (slot_bytes + 1024)));
  int64_t blocks = std::min<int64_t>((nq + kCopyWarps - 1) / kCopyWarps, sms * per_sm);
  blocks = std::max<int64_t>(blocks, (nq + kMaxShare - 1) / kMaxShare);
  const int64_t share = (nq + blocks - 1) / blocks;
  blocks = (nq + share - 1) / share;
  const size_t bytes = slot_bytes + (size_t)share * sizeof(int32_t);
  static size_t allowed[kMaxDevices] = {};
  err = allow_shared(row_copy, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  row_copy<<<(unsigned int)blocks, kCopyThreads, bytes, (cudaStream_t)stream>>>(
      idx, x, out, (int)width, nq, (int)share, ring);
  return (int)cudaGetLastError();
}
