// Stage A of the build: the whole-array fits of the linear-family, normal
// and hint-table tops (csrc/top.cu has the cubic top's), each one entry
// with no host step inside it.
//
//   rmi_top_moments     the linear and robust_linear tops' least squares
//                       (models/linear._slr_ranges over one span) or the
//                       normal top's (mean, stdev, scale)
//                       (models/normal._ncdf_ranges), over the keys
//                       [lo, hi) (robust_linear's trim, linear.trimmed, is
//                       the caller's, from n): pass 1 sums x and the
//                       targets y = trunc(yfix * sf), made in registers
//                       from the int32 FixDups positions, and writes the
//                       means to the scratch's head; pass 2 reads them
//                       there and sums the centered terms (x - mx)^2 and
//                       (x - mx)(y - my); its last block writes the
//                       [1, ppm] row with _slr_from_moments' and
//                       _ncdf_ranges' degenerate cases;
//   rmi_top_table_fit   a hint-table top (radix8/18/22/26/28,
//                       models/radix._make_table_fit_top): the keys'
//                       common prefix from the first and last key, and a
//                       thread a slot b: table[b] the target of the first
//                       key whose bucket is at least b (its binary search
//                       over the keys' integer images, the bucket taken
//                       at each probe), the table's size past the last
//                       key's bucket, table[0] = 0.
//
// Replace no Pallas call: rmi_tpu fits these tops inside its stage A's XLA
// program (rmi_tpu/train/two_layer.py:176, _assign_body; the fits
// rmi_tpu/models/linear.py:164, :174, :45, models/normal.py:75, :32 and
// models/radix.py:186).  In eager torch, their plain versions, the fits
// build the [n] f64 scaled targets (1.6 GB at 200M keys) and sum over
// [n]-sized products, the linear ones with a host read of the span
// (segments.range_sum), and the table fit a bucket per key and a
// searchsorted of the slots into them.
//
// The sums add in XLA's order, the one segments.whole_array_sum follows
// on the CPU: a reduction longer than 32 is cut into windows of 32, with
// the padding split between the two ends, each window summed in sequence
// from 0, then the window sums the same way, down to at most 32 summed in
// sequence; the keys outside [lo, hi) keep their places as zeros; a
// product is rounded before it is summed, except in a reduction of 32 or
// fewer, which XLA fuses into one FMA chain over [lo, hi).  That order is
// a fixed tree, so the rows are the CPU's (and rmi_tpu's) bits, and the
// same bits in every run.
//
// Bound on the H100: memory.  Each pass reads x (8 bytes) and, for the
// linear tops, yfix (4 bytes) a key: 24 bytes a key for a linear top, 16
// for the normal one (1.43 and 0.96 ms at 200M keys and 3.35 TB/s).  The
// first two levels of windows are one grid (window_sums): a warp takes
// 1024 consecutive positions, a level-2 window, each lane loading its 32
// (coalesced across the warp) into registers at once, then each channel
// through a 32 x 33 tile in shared memory; lane r adds row r, a level-1
// window, in sequence, and the 32 row sums are added in sequence through
// shuffles.  (A first design that loaded a row at a time behind the span's
// branch, a tile a channel, kept too few loads in flight: 4.31 ms for a
// linear top at 200M keys on the H100.)  One block (tail) takes the
// level-2 sums (n / 1024 a channel) to the end and finishes the pass.
// The table fit is latency-bound: 2^bits
// searches of ~log2(n) dependent reads, the first of which every thread
// shares through L1 and L2.
#include "common.cuh"
#include "int_top.cuh"

namespace {

constexpr int kWin = 32;               // segments._XLA_WINDOW
constexpr int kWarps = 4;              // warps of a window_sums block
constexpr int kTailThreads = 1024;
constexpr int kHead = 16;              // the scratch's head: the means
constexpr int kTableThreads = 256;
enum : int64_t { kLinearTop = 0, kNormalTop = 1 };   // ops/top_kernel.MOMENT_TOPS

// the windows XLA cuts a reduction of `len` into: pad = -len mod 32, of
// which `front` comes before the first element
struct Level {
  int64_t front, windows;
  __host__ __device__ explicit Level(int64_t len) {
    const int64_t pad = (kWin - len % kWin) % kWin;
    front = pad / 2;
    windows = (len + pad) / kWin;
  }
};

// the entries a channel of the scratch holds past its head: the level-2
// window sums, or a short level on the way down (ops/top_kernel.
// moments_scratch is 16 + 4 * this)
__host__ __device__ inline int64_t channel_stride(int64_t n) {
  const int64_t l2 = Level(Level(n).windows).windows;
  return l2 > kWin ? l2 : kWin;
}

__device__ __forceinline__ double target(int32_t y, double sf, bool scaled) {
  return scaled ? trunc((double)y * sf) : (double)y;
}

// the values a pass sums at position i: pass 0 x and y, pass 1 the
// centered (x - mx)^2 and (x - mx)(y - my), 0 outside [lo, hi); kCh == 1
// takes x's alone
template <int kPass, int kCh>
struct Source {
  const double* __restrict__ x;
  const int32_t* __restrict__ y;
  int64_t lo, hi;
  double sf;
  bool scaled;
  double mx, my;

  // channel c's value of the key (xi, yi)
  __device__ __forceinline__ double value(int c, double xi, int32_t yi) const {
    if constexpr (kPass == 0) return c == 0 ? xi : target(yi, sf, scaled);
    const double dx = xi - mx;
    return c == 0 ? dx * dx : dx * (target(yi, sf, scaled) - my);
  }

  __device__ __forceinline__ void at(int64_t i, double (&v)[kCh]) const {
    const bool in = i >= lo && i < hi;
    const double xi = in ? __ldg(x + i) : 0.0;
    const int32_t yi = in && kCh == 2 ? __ldg(y + i) : 0;
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = in ? value(c, xi, yi) : 0.0;
  }

  // the two differences of pass 1 at i, for the FMA chain of a short array
  __device__ __forceinline__ void centered(int64_t i, double& dx, double& dy) const {
    dx = __ldg(x + i) - mx;
    dy = kCh == 2 ? target(__ldg(y + i), sf, scaled) - my : dx;
  }
};

// levels 0 -> 2 where level 1 has more than 32 windows: warp w2 writes
// out[c * stride + w2], the sum of level-2 window w2 of channel c.  A lane
// loads its 32 keys' x (and yfix) at once, every load in flight (an
// address outside the keys clamped, its value masked after), then writes
// each channel's values into the warp's tile in turn
template <int kPass, int kCh>
__global__ void __launch_bounds__(kWarps * 32)
window_sums(Source<kPass, kCh> src, int64_t n, const double* __restrict__ head,
            double* __restrict__ out, int64_t stride) {
  __shared__ double tile[kWarps][kWin][kWin + 1];
  if constexpr (kPass == 1) {
    src.mx = head[0];
    src.my = head[1];
  }
  const Level l0(n), l1(l0.windows);
  const int64_t l2 = l1.windows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t w2 = (int64_t)blockIdx.x * kWarps + warp; w2 < l2;
       w2 += (int64_t)gridDim.x * kWarps) {
    // position k of level-1 window j = 32 w2 - front1 + r is 32 j - front0 + k
    const int64_t base = (w2 * kWin - l1.front) * kWin - l0.front;
    double xv[kWin];
    int32_t yv[kWin];
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      const int64_t i = base + r * kWin + lane;
      const int64_t at = i < 0 ? 0 : (i >= n ? n - 1 : i);
      xv[r] = __ldg(src.x + at);
      yv[r] = kCh == 2 ? __ldg(src.y + at) : 0;
    }
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        const int64_t i = base + r * kWin + lane;
        tile[warp][r][lane] = i >= src.lo && i < src.hi ? src.value(c, xv[r], yv[r]) : 0.0;
      }
      __syncwarp();
      double s1 = 0.0;                  // level-1 window `lane`, in sequence
#pragma unroll
      for (int k = 0; k < kWin; ++k) s1 += tile[warp][lane][k];
      double s2 = 0.0;                  // their level-2 window, in sequence
#pragma unroll
      for (int r = 0; r < kWin; ++r) s2 += __shfl_sync(RMI_FULL_MASK, s1, r);
      if (lane == 0) out[c * stride + w2] = s2;
      __syncwarp();
    }
  }
}

// one block: the pass's sums from the level-2 sums (or from the keys
// where level 1 has at most 32 windows), then its finish (thread 0):
// pass 0 the means into head[0:2]; pass 1 the row
template <int kPass, int kCh>
__global__ void __launch_bounds__(kTailThreads)
tail(Source<kPass, kCh> src, int64_t n, double* __restrict__ scratch, int64_t stride,
     const int32_t* __restrict__ y, double* __restrict__ row) {
  double* head = scratch;
  double* a = scratch + kHead;
  double* b = a + kCh * stride;
  if constexpr (kPass == 1) {
    src.mx = head[0];
    src.my = head[1];
  }
  double total[kCh];
  if (n <= kWin) {                      // no window: one loop in sequence
    if (threadIdx.x != 0) return;
#pragma unroll
    for (int c = 0; c < kCh; ++c) total[c] = 0.0;
    if constexpr (kPass == 0) {         // the masked array summed from 0
      for (int64_t i = 0; i < n; ++i) {
        double v[kCh];
        src.at(i, v);
#pragma unroll
        for (int c = 0; c < kCh; ++c) total[c] += v[c];
      }
    } else {                            // XLA's FMA chain over [lo, hi)
      for (int64_t i = src.lo; i < src.hi; ++i) {
        double dx, dy;
        src.centered(i, dx, dy);
        total[0] = fma(dx, dx, total[0]);
        if constexpr (kCh == 2) total[kCh - 1] = fma(dx, dy, total[kCh - 1]);
      }
    }
  } else {
    const Level l0(n);
    const double* cur = a;
    double* nxt = b;
    int64_t len = Level(l0.windows).windows;
    if (l0.windows <= kWin) {           // level 0 -> 1 here, into b
      for (int64_t w = threadIdx.x; w < l0.windows; w += kTailThreads) {
        double acc[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[c] = 0.0;
        for (int k = 0; k < kWin; ++k) {
          double v[kCh];
          src.at(w * kWin - l0.front + k, v);
#pragma unroll
          for (int c = 0; c < kCh; ++c) acc[c] += v[c];
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) b[c * stride + w] = acc[c];
      }
      __syncthreads();
      cur = b;
      nxt = a;
      len = l0.windows;
    }
    while (len > kWin) {
      const Level l(len);
      for (int64_t w = threadIdx.x; w < l.windows; w += kTailThreads) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          double v[kWin];               // every load in flight, then in sequence
#pragma unroll
          for (int k = 0; k < kWin; ++k) {
            const int64_t j = w * kWin - l.front + k;
            v[k] = cur[c * stride + (j < 0 ? 0 : (j >= len ? len - 1 : j))];
          }
          double acc = 0.0;
#pragma unroll
          for (int k = 0; k < kWin; ++k) {
            const int64_t j = w * kWin - l.front + k;
            acc += j >= 0 && j < len ? v[k] : 0.0;
          }
          nxt[c * stride + w] = acc;
        }
      }
      __syncthreads();
      double* t = nxt;
      nxt = const_cast<double*>(cur);
      cur = t;
      len = l.windows;
    }
    if (threadIdx.x != 0) return;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      total[c] = 0.0;
      for (int64_t j = 0; j < len; ++j) total[c] += cur[c * stride + j];
    }
  }
  const double cnt = (double)(src.hi - src.lo);
  const double safe = cnt < 1.0 ? 1.0 : cnt;
  if constexpr (kPass == 0) {
    if constexpr (kCh == 2) {           // linear: the count's reciprocal, folded by XLA
      const double inv = 1.0 / safe;
      head[0] = total[0] * inv;
      head[1] = total[1] * inv;
    } else {                            // normal
      head[0] = cnt == 0.0 ? 0.0 : total[0] / safe;
      head[1] = 0.0;
    }
  } else if constexpr (kCh == 2) {      // _slr_from_moments
    const double m2 = total[0], c = total[1];
    const bool var_zero = m2 <= 0.0;
    double beta = var_zero ? 0.0 : c / m2;
    double alpha = fma(-beta, src.mx, src.my);
    alpha = cnt == 0.0 ? 0.0 : (cnt == 1.0 || var_zero ? src.my : alpha);
    beta = cnt <= 1.0 || var_zero ? 0.0 : beta;
    row[0] = alpha;
    row[1] = beta;
  } else {                              // _ncdf_ranges
    const double ss = total[0];
    const double clamped = isnan(ss) ? ss : (ss < 0.0 ? 0.0 : ss);
    row[0] = src.mx;
    row[1] = sqrt(cnt == 0.0 ? __longlong_as_double(0x7ff8000000000000ll) : clamped / safe);
    row[2] = cnt == 0.0 ? -INFINITY : target(y[n - 1], src.sf, src.scaled);
  }
}

template <int kCh>
void moments(const double* x, const int32_t* y, int64_t n, int64_t lo, int64_t hi, double sf,
             bool scaled, double* scratch, double* row, cudaStream_t stream) {
  const int64_t stride = channel_stride(n);
  double* a = scratch + kHead;
  const bool grid = Level(n).windows > kWin;
  const unsigned int blocks = rmi_grid(Level(Level(n).windows).windows, kWarps);
  const Source<0, kCh> s0{x, y, lo, hi, sf, scaled, 0.0, 0.0};
  if (grid) window_sums<0, kCh><<<blocks, kWarps * 32, 0, stream>>>(s0, n, scratch, a, stride);
  tail<0, kCh><<<1, kTailThreads, 0, stream>>>(s0, n, scratch, stride, y, row);
  const Source<1, kCh> s1{x, y, lo, hi, sf, scaled, 0.0, 0.0};
  if (grid) window_sums<1, kCh><<<blocks, kWarps * 32, 0, stream>>>(s1, n, scratch, a, stride);
  tail<1, kCh><<<1, kTailThreads, 0, stream>>>(s1, n, scratch, stride, y, row);
}

// table[b] of a hint-table top with `bits` bits over the n integer-key
// images (models/radix._make_table_fit_top), w_int = (prefix, bits)
__global__ void __launch_bounds__(kTableThreads)
table_fit(const int64_t* __restrict__ images, const int32_t* __restrict__ y, int64_t n,
          double sf, bool scaled, int64_t bits, int32_t* __restrict__ table,
          int64_t* __restrict__ w_int) {
  const int64_t size = (int64_t)1 << bits;
  const int64_t first = __ldg(images), last = __ldg(images + n - 1);
  // common_prefix_size: clz of the images' xor, which is their bits' xor
  const int64_t prefix = __clzll(first ^ last);
  const int64_t shift = prefix + bits > 64 ? 0 : 64 - prefix - bits;   // _table_shift
  const uint64_t mask = rmi_shr(~0ull, prefix);
  const uint64_t last_bucket = rmi_shr(int_bits<RmiKey::kU64>(last) & mask, shift);
  const int64_t stride = (int64_t)gridDim.x * kTableThreads;
  for (int64_t b = (int64_t)blockIdx.x * kTableThreads + threadIdx.x; b < size; b += stride) {
    int32_t v = 0;
    if ((uint64_t)b > last_bucket) {
      v = (int32_t)size;
    } else if (b > 0) {
      // #{keys whose bucket < b} (segments.sorted_starts), clipped to n - 1
      int64_t lo = 0, hi = n;
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        const uint64_t bucket =
            rmi_shr(int_bits<RmiKey::kU64>(__ldg(images + mid)) & mask, shift);
        if (bucket < (uint64_t)b) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      v = (int32_t)target(__ldg(y + (lo < n - 1 ? lo : n - 1)), sf, scaled);
    }
    table[b] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    w_int[0] = prefix;
    w_int[1] = bits;
  }
}

}  // namespace

// row[0 : ppm] of a linear-family (model 0: alpha, beta) or normal (model 1:
// mean, stdev, scale) top fitted over the keys [lo, hi) of the n of x and
// their FixDups positions y (the targets y scaled by sf where
// scale_targets is nonzero); scratch a buffer of `capacity` doubles,
// refused if smaller than 16 + 4 channel_stride(n) (ops/top_kernel.
// moments_scratch), as are n < 1, a span outside [0, n) and an unknown
// model
RMI_API int rmi_top_moments(const double* x, const int32_t* y, int64_t n, int64_t lo,
                            int64_t hi, double sf, int64_t scale_targets, int64_t model,
                            double* scratch, int64_t capacity, double* row, void* stream) {
  if (n < 1 || lo < 0 || hi < lo || hi > n || (model != kLinearTop && model != kNormalTop) ||
      capacity < kHead + 4 * channel_stride(n)) {
    return (int)cudaErrorInvalidValue;
  }
  if (model == kLinearTop) {
    moments<2>(x, y, n, lo, hi, sf, scale_targets != 0, scratch, row, (cudaStream_t)stream);
  } else {
    moments<1>(x, y, n, lo, hi, sf, scale_targets != 0, scratch, row, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// table[2^bits] and w_int[2] of a hint-table top over the n sorted
// integer-key images (keys.int_image; a u64 key's own) and their FixDups
// positions y, the targets y scaled by sf where scale_targets is nonzero;
// n < 1 or bits outside [1, 30] is refused
RMI_API int rmi_top_table_fit(const int64_t* images, const int32_t* y, int64_t n, double sf,
                              int64_t scale_targets, int64_t bits, int32_t* table,
                              int64_t* w_int, void* stream) {
  if (n < 1 || bits < 1 || bits > 30) return (int)cudaErrorInvalidValue;
  table_fit<<<rmi_grid((int64_t)1 << bits, kTableThreads), kTableThreads, 0,
              (cudaStream_t)stream>>>(images, y, n, sf, scale_targets != 0, bits, table, w_int);
  return (int)cudaGetLastError();
}
