// Stage A of the build: the whole-array fits of the linear-family, normal
// and hint-table tops (csrc/top.cu has the cubic top's), each one entry
// with no host step inside it.
//
//   rmi_top_moments     the linear and robust_linear tops' least squares
//                       (models/linear._slr_ranges over one span) or the
//                       normal top's (mean, stdev, scale)
//                       (models/normal._ncdf_ranges), over the keys
//                       [lo, hi) (robust_linear's trim, linear.trimmed, is
//                       the caller's, from n): pass 0 sums x and the
//                       targets y = trunc(yfix * sf), made in registers
//                       from the int32 FixDups positions, and writes the
//                       means to the scratch's head; pass 1 reads them
//                       there and sums the centered terms (x - mx)^2 and
//                       (x - mx)(y - my); the warp that adds pass 1's last
//                       sum writes the [1, ppm] row with _slr_from_moments'
//                       and _ncdf_ranges' degenerate cases;
//   rmi_top_table_fit   a hint-table top (radix8/18/22/26/28,
//                       models/radix._make_table_fit_top): the keys'
//                       common prefix from the first and last key, and a
//                       lane a slot b: table[b] the target of the first key
//                       whose bucket is at least b, the table's size past
//                       the last key's bucket, table[0] = 0.
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
// same bits in every run, whichever warp adds a window.
//
// rmi_top_moments is bound by memory: each pass reads x (8 bytes) and,
// for the linear tops, yfix (4 bytes) a key, 12 bytes a key a pass for a
// linear top and 8 for the normal one (0.716 and 0.478 ms a pass at 200M
// keys and 3.35 TB/s); the means between the passes make two passes the
// floor.  The first design (a lane's 32 keys loaded into registers, a
// warp's 32 x 33 tile a channel, then one block adding the n / 1024
// level-2 sums) took 2.25 ms for a linear top and 1.26 for the normal one
// on an H100 80GB HBM3 at 700 W: its one-block tails 0.23-0.26 ms each (a
// thread a window, each of its 32 loads in another sector, all through
// one SM), pass 1's grid 0.96-1.06 ms at 242 registers a thread (8 warps
// an SM), pass 0's 0.81 at 136 (tools/time_torch_stage_a.py --split).
// This design, a pass two kernels:
//   - walk: a persistent walk of the level-2 windows (warp g of the
//     resident warps takes g, g + G, ...; pass 1 from the far end, so
//     that its first windows may still lie in L2), each warp's next
//     window in flight by 16-byte cp.async copies into a ring of
//     XOR-swizzled tiles in shared memory while it adds one, so no
//     register holds a key in flight (80-96 registers; 8 warps an SM for
//     a linear top, 12 for the normal one, as fast as 16 and 28 warps
//     with one window a warp);
//     lane r adds row r (a level-1 window) in sequence, lanes 0 and 1 the
//     32 row sums, and lane 0 writes them: 0.76-0.77 ms a pass for a
//     linear top, 0.51 for the normal one (0.93 of the pass's bound);
//   - tree: the level-2 sums (n / 1024 a channel) added across the card,
//     a warp a level-3 window; a warp that completes a window of the
//     next level (one integer atomicAdd on its counter) adds it and climbs
//     on (climb), and the warp that adds the last level finishes the pass:
//     0.012 ms.  The counters are zeroed once a call (a memset before
//     pass 0) and again by the warp that completes each.
// Adding the tree inside the walk (a warp counting its level-2 sums in
// every 32 windows) took 1.06-1.47 ms a pass against 0.75: the fence
// before the counts waits for the warp's copies in flight.  The 8- and 4-byte cp.async copies of
// a padded tile reached 2.1 TB/s, one bulk copy (cp.async.bulk) a window
// with skewed reads of a row-major tile less (measured on the same card).
// n <= 32 is one thread (small), both passes.
//
// rmi_top_table_fit is bound by dependent reads and by device memory's
// rate of random 64-byte reads (~2.5e10 a second on the H100): a slot's
// first key is a lower bound over n keys.  The first design ran each
// slot's own binary search by bucket over all n keys, log2(n) dependent
// reads (28 at 200M keys), the last ~10 in the slot's own sectors:
// 0.0885 ms for path 5's radix18 table at 200M keys (H100 80GB HBM3,
// 700 W), against 0.0053 ms for a sector a slot.  This design
// (table_fit) still gives a thread a slot, but each search reads a 64-byte
// block a round, placed by interpolation between the masked key bits
// known on either side of the slot's threshold (b << shift), at most
// kInterp times, then halving by blocks.  Its host mirror
// (tools/count_torch_table_reads.py --shift 3: 25M keys, 763 a slot as
// path 5's at 200M) counts 4.37 dependent reads (the position's
// included) and 4.35 distinct 64-byte blocks a searched slot.
#include "common.cuh"
#include "int_top.cuh"

namespace {

constexpr int kWin = 32;               // segments._XLA_WINDOW
constexpr int kWarps = 4;              // warps of a walk block
constexpr int kStages = 2;             // level-2 windows in each warp's ring
constexpr int kHead = 16;              // the scratch's head: the means
constexpr int kMaxLevels = 14;         // levels of sums above level 1 (n < 2^63)
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

// The sums above level 1 and where the scratch holds them.  len[0] is the
// walk's level-2 sums (one, the level-1 sums summed in sequence, where
// level 1 has at most 32 windows), len[i + 1] the windows of len[i] while
// len[i] > 32; the last level, at most 32 sums, is summed in sequence.
// Level i's two channels are values[arr[i] + c * len[i]]; from level 1 on
// its windows' arrival counters are counters[cnt[i] + j] (the last level
// one); level 0's windows need none, the tree kernel giving each its own
// warp.  The scratch holds kHead doubles, the counters as int32 in
// ceil(counters / 2) doubles, then the values; ops/top_kernel.
// moments_scratch asks for a bound above that, which the entry checks.
struct Tree {
  int64_t len[kMaxLevels], arr[kMaxLevels], cnt[kMaxLevels];
  int64_t front1;                      // level 1's front, 0 where it is not windowed
  int64_t counters, values;
  int levels;
  __host__ __device__ explicit Tree(int64_t n) {
    const Level l0(n);
    const bool windowed = l0.windows > kWin;
    front1 = windowed ? Level(l0.windows).front : 0;
    int64_t length = windowed ? Level(l0.windows).windows : 1;
    counters = values = 0;
    for (levels = 0;; length = Level(length).windows) {
      len[levels] = length;
      arr[levels] = values;
      cnt[levels] = counters;
      values += 2 * length;
      const bool counted = levels > 0;
      ++levels;
      if (length <= kWin) {
        counters += counted ? 1 : 0;
        break;
      }
      counters += counted ? Level(length).windows : 0;
    }
  }
  __host__ __device__ int64_t doubles() const { return kHead + (counters + 1) / 2 + values; }
};

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
};

// the pass's end (one thread): pass 0 the means into head[0:2]; pass 1 the
// row, _slr_from_moments' or _ncdf_ranges' cases
template <int kPass, int kCh>
__device__ void finish(const Source<kPass, kCh>& src, int64_t n, const double (&total)[2],
                       double* head, double* row) {
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
    row[2] = cnt == 0.0 ? -INFINITY : target(__ldg(src.y + n - 1), src.sf, src.scaled);
  }
}

// n <= 32, one thread, both passes: the masked array summed from 0, the
// means, then XLA's FMA chain over [lo, hi) (a reduction of 32 or fewer
// is one fused loop)
template <int kCh>
__global__ void small(Source<0, kCh> s0, int64_t n, double* __restrict__ head,
                      double* __restrict__ row) {
  if (threadIdx.x != 0) return;
  double total[2] = {0.0, 0.0};
  for (int64_t i = 0; i < n; ++i) {
    const bool in = i >= s0.lo && i < s0.hi;
    const double xi = in ? s0.x[i] : 0.0;
    const int32_t yi = in && kCh == 2 ? s0.y[i] : 0;
#pragma unroll
    for (int c = 0; c < kCh; ++c) total[c] += in ? s0.value(c, xi, yi) : 0.0;
  }
  finish(s0, n, total, head, row);
  const Source<1, kCh> s1{s0.x, s0.y, s0.lo, s0.hi, s0.sf, s0.scaled, head[0], head[1]};
  total[0] = total[1] = 0.0;
  for (int64_t i = s1.lo; i < s1.hi; ++i) {
    const double dx = s1.x[i] - s1.mx;
    total[0] = fma(dx, dx, total[0]);
    if constexpr (kCh == 2) total[1] = fma(dx, target(s1.y[i], s1.sf, s1.scaled) - s1.my, total[1]);
  }
  finish(s1, n, total, head, row);
}

// A warp's shared memory: a ring of kStages level-2 windows, x as 32 rows
// of 16 16-byte chunks (row r the level-1 window r, chunk c its keys 2c
// and 2c + 1) and, for the linear tops, yfix as 32 rows of 8 chunks of 4,
// each chunk c of row r stored at c ^ (r mod 16) (x) or c ^ (r mod 8)
// (yfix), so that the 8 lanes of a quarter-warp reading chunk c of rows
// r..r+7 hit 8 distinct 16-byte bank groups; then [2][32] doubles for the
// sums a lane hands to another.
template <int kCh>
struct Ring {
  static constexpr int kX = kWin * kWin * 8;
  static constexpr int kY = kCh == 2 ? kWin * kWin * 4 : 0;
  static constexpr int kStage = kX + kY;
  static constexpr int kBytes = kStages * kStage + 2 * kWin * 8;
  unsigned char* base;

  __device__ __forceinline__ double2* x(int s, int r, int c) const {
    return reinterpret_cast<double2*>(base + s * kStage + r * 256 + ((c ^ (r & 15)) << 4));
  }
  __device__ __forceinline__ int4* y(int s, int r, int c) const {
    return reinterpret_cast<int4*>(base + s * kStage + kX + r * 128 + ((c ^ (r & 7)) << 4));
  }
  __device__ __forceinline__ double* buf() const {
    return reinterpret_cast<double*>(base + kStages * kStage);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"((unsigned int)__cvta_generic_to_shared(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// lane c < kCh: channel c's sum of buf[c][0:32] in sequence from 0
__device__ __forceinline__ double row_of_buf(const double* buf, int lane, int ch) {
  double acc = 0.0;
  if (lane < ch) {
#pragma unroll
    for (int k = 0; k < kWin; ++k) acc += buf[lane * kWin + k];
  }
  return acc;
}

// Where element w of tree level lv is counted: the window j of level
// lv + 1 that holds it, that window's first element and how many of its
// elements exist (the last level: one window of all its elements, counted
// by the one top counter).
struct Parent {
  int64_t j, first, count;
  int* counter;

  __device__ __forceinline__ Parent(const Tree& t, int* counters, int lv, int64_t w)
      : j(0), first(0), count(t.len[lv]), counter(counters + t.cnt[lv]) {
    const int64_t len = t.len[lv];
    if (len > kWin) {
      const Level l(len);
      j = (w + l.front) / kWin;
      first = j * kWin - l.front;
      count = (first + kWin < len ? first + kWin : len) - (first > 0 ? first : 0);
      counter += j;
    }
  }
  // one element counted in, after the fence that orders its write; whether
  // it completed the window
  __device__ __forceinline__ bool arrive() const {
    const bool last = atomicAdd(counter, 1) == (int)(count - 1);
    if (last) *counter = 0;             // zero again for the next pass
    return last;
  }
};

// v on every lane: the warp's sum of the window of level lv that starts at
// element `first`, its 32 elements in sequence (those outside the level
// as zeros), read after the counts that completed it
template <int kCh>
__device__ __forceinline__ void window_sum(const Tree& t, const double* __restrict__ values,
                                           double* buf, int lane, int lv, int64_t first,
                                           double (&v)[2]) {
  const int64_t len = t.len[lv];
  const double* arr = values + t.arr[lv];
  __threadfence();                      // the other warps' elements, after their counts
  const int64_t e = first + lane;
#pragma unroll
  for (int c = 0; c < kCh; ++c) buf[c * kWin + lane] = e >= 0 && e < len ? __ldcg(arr + c * len + e) : 0.0;
  __syncwarp();
  const double acc = row_of_buf(buf, lane, kCh);
  __syncwarp();
  v[0] = __shfl_sync(RMI_FULL_MASK, acc, 0);
  v[1] = __shfl_sync(RMI_FULL_MASK, acc, 1);
}

// The warp completed window p of level lv: it sums it and, below the last
// level, writes the sum as element p.j of level lv + 1 and counts it into
// that level's window, climbing on while it completes one.  Returns whether
// it summed the last level, whose sums v then holds.
template <int kCh>
__device__ bool climb(const Tree& t, double* __restrict__ values, int* __restrict__ counters,
                      double* buf, int lane, int lv, Parent p, double (&v)[2]) {
  for (;; ++lv) {
    window_sum<kCh>(t, values, buf, lane, lv, p.first, v);
    if (t.len[lv] <= kWin) return true;
    const int64_t w = p.j, len = t.len[lv + 1];
    double* arr = values + t.arr[lv + 1];
    p = Parent(t, counters, lv + 1, w);
    int last = 0;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) __stcg(arr + c * len + w, v[c]);
      __threadfence();                  // the element, before its count
      last = p.arrive();
    }
    if (!__shfl_sync(RMI_FULL_MASK, last, 0)) return false;
  }
}

// One pass over the keys, up to level 2: a persistent walk of the level-2
// windows (warp g of G takes g, g + G, ...; pass 1 from the far end,
// where pass 0's last reads may still lie in L2), each warp's next
// kStages windows in flight in its Ring by 16-byte cp.async copies.  Lane
// r adds row r, a level-1 window, in sequence (the positions outside
// [lo, hi) as zeros), four keys a chunk read; the 32 row sums go through
// the warp's buffer to lanes 0 and 1, which add them in sequence, and
// lane 0 writes the window's level-2 sums.
template <int kPass, int kCh>
__global__ void __launch_bounds__(kWarps * 32)
walk(Source<kPass, kCh> src, int64_t n, Tree t, bool aligned, double* __restrict__ scratch) {
  using R = Ring<kCh>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const R ring{smem + warp * R::kBytes};
  if constexpr (kPass == 1) {
    src.mx = scratch[0];
    src.my = scratch[1];
  }
  const int64_t front0 = Level(n).front, l2 = t.len[0];
  const int64_t walkers = (int64_t)gridDim.x * kWarps;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t mine = g < l2 ? (l2 - 1 - g) / walkers + 1 : 0;
  // the k-th window of this warp, and its first position
  auto window = [&](int64_t k) {
    const int64_t w2 = g + k * walkers;
    return kPass == 1 ? l2 - 1 - w2 : w2;
  };
  auto base = [&](int64_t w2) { return (w2 * kWin - t.front1) * kWin - front0; };
  // stage s gets the warp's k-th window: lane l a 16-byte chunk of each
  // of two rows of x (of four rows of yfix) an instruction, coalesced;
  // where the window lies inside [0, n) with its chunks on 16-byte
  // boundaries by cp.async, else by the lane's own loads (zeros outside)
  auto fill = [&](int s, int64_t k) {
    if (k < mine) {
      const int64_t at = base(window(k));
      if (aligned && at >= 0 && at + kWin * kWin <= n) {
#pragma unroll
        for (int j = 0; j < kWin / 2; ++j) {
          const int r = 2 * j + (lane >> 4), c = lane & 15;
          cp_async16(ring.x(s, r, c), src.x + at + r * kWin + 2 * c);
        }
        if constexpr (kCh == 2) {
#pragma unroll
          for (int j = 0; j < kWin / 4; ++j) {
            const int r = 4 * j + (lane >> 3), c = lane & 7;
            cp_async16(ring.y(s, r, c), src.y + at + r * kWin + 4 * c);
          }
        }
      } else {
        auto xat = [&](int64_t i) { return i >= 0 && i < n ? __ldg(src.x + i) : 0.0; };
        auto yat = [&](int64_t i) { return i >= 0 && i < n ? __ldg(src.y + i) : 0; };
        for (int j = 0; j < kWin / 2; ++j) {
          const int r = 2 * j + (lane >> 4), c = lane & 15;
          const int64_t i = at + r * kWin + 2 * c;
          *ring.x(s, r, c) = make_double2(xat(i), xat(i + 1));
        }
        if constexpr (kCh == 2) {
          for (int j = 0; j < kWin / 4; ++j) {
            const int r = 4 * j + (lane >> 3), c = lane & 7;
            const int64_t i = at + r * kWin + 4 * c;
            *ring.y(s, r, c) = make_int4(yat(i), yat(i + 1), yat(i + 2), yat(i + 3));
          }
        }
      }
    }
    cp_commit();                        // a group a stage, empty or not
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) fill(s, s);
  double* l2sums = scratch + kHead + (t.counters + 1) / 2 + t.arr[0];
  for (int64_t k = 0; k < mine; ++k) {
    const int s = (int)(k % kStages);
    cp_wait<kStages - 1>();
    __syncwarp();
    const int64_t w2 = window(k);
    const int64_t first = base(w2) + lane * kWin;     // row `lane`'s first position
    const int64_t klo = src.lo - first, khi = src.hi - first;
    double s1[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) s1[c] = 0.0;
#pragma unroll
    for (int c4 = 0; c4 < kWin / 4; ++c4) {      // keys 4 c4 .. 4 c4 + 3 of row `lane`
      const double2 xa = *ring.x(s, lane, 2 * c4), xb = *ring.x(s, lane, 2 * c4 + 1);
      int4 yq = make_int4(0, 0, 0, 0);
      if constexpr (kCh == 2) yq = *ring.y(s, lane, c4);
      const double xs[4] = {xa.x, xa.y, xb.x, xb.y};
      const int32_t ys[4] = {yq.x, yq.y, yq.z, yq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * c4 + e;
        const bool in = kk >= klo && kk < khi;
#pragma unroll
        for (int c = 0; c < kCh; ++c) s1[c] += in ? src.value(c, xs[e], ys[e]) : 0.0;
      }
    }
    __syncwarp();                       // the stage read: refill it
    fill(s, k + kStages);
    double* buf = ring.buf();
#pragma unroll
    for (int c = 0; c < kCh; ++c) buf[c * kWin + lane] = s1[c];
    __syncwarp();
    const double s2 = row_of_buf(buf, lane, kCh);
    __syncwarp();
    const double v1 = __shfl_sync(RMI_FULL_MASK, s2, 1);
    if (lane == 0) {                    // level-2 sum w2 of each channel
      __stcg(l2sums + w2, s2);
      if constexpr (kCh == 2) __stcg(l2sums + t.len[0] + w2, v1);
    }
  }
  cp_wait<0>();
}

// The pass's sums above level 2, a kernel after the walk (whose end
// orders its level-2 sums before these reads): warp q of the grid sums the
// windows q, q + Q, ... of the level-2 sums and climbs from each; the warp
// that sums the last level finishes the pass.  (Counting the walk's own
// sums into their windows as it goes cost a fence a flush, and a fence
// waits for the warp's copies in flight: 1.06-1.47 ms a pass on an H100,
// against 0.75 without.)
template <int kPass, int kCh>
__global__ void __launch_bounds__(kWarps * 32)
tree(Source<kPass, kCh> src, int64_t n, Tree t, double* __restrict__ scratch,
     double* __restrict__ row) {
  __shared__ double bufs[kWarps][2 * kWin];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* counters = reinterpret_cast<int*>(scratch + kHead);
  double* values = scratch + kHead + (t.counters + 1) / 2;
  if constexpr (kPass == 1) {
    src.mx = scratch[0];
    src.my = scratch[1];
  }
  const int64_t len = t.len[0];
  const int64_t windows = len > kWin ? Level(len).windows : 1;
  const int64_t front = len > kWin ? Level(len).front : 0;
  for (int64_t j = (int64_t)blockIdx.x * kWarps + warp; j < windows;
       j += (int64_t)gridDim.x * kWarps) {
    const int64_t w = j * kWin - front;
    double v[2];
    if (climb<kCh>(t, values, counters, bufs[warp], lane, 0,
                   Parent(t, counters, 0, w > 0 ? w : 0), v) && lane == 0) {
      finish(src, n, v, scratch, row);
    }
  }
}

// the blocks of walk<kPass, kCh> resident on the current device at once,
// asked once per device, the kernel first allowed its shared memory
template <int kPass, int kCh>
cudaError_t walk_blocks(int* blocks) {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    const int smem = kWarps * Ring<kCh>::kBytes;
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(walk<kPass, kCh>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk<kPass, kCh>, kWarps * 32,
                                                          smem);
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    counts[dev] = sms * per_sm;
  }
  *blocks = counts[dev];
  return cudaSuccess;
}

template <int kPass, int kCh>
cudaError_t launch_walk(const Source<kPass, kCh>& src, int64_t n, const Tree& t, bool aligned,
                        double* scratch, double* row, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = walk_blocks<kPass, kCh>(&resident);
  if (err != cudaSuccess) return err;
  const int64_t wanted = (t.len[0] + kWarps - 1) / kWarps;
  const unsigned int grid = (unsigned int)(wanted < resident ? wanted : resident);
  walk<kPass, kCh><<<grid, kWarps * 32, kWarps * Ring<kCh>::kBytes, stream>>>(src, n, t, aligned,
                                                                              scratch);
  const int64_t windows = t.len[0] > kWin ? Level(t.len[0]).windows : 1;
  tree<kPass, kCh><<<rmi_grid(windows, kWarps), kWarps * 32, 0, stream>>>(src, n, t, scratch, row);
  return cudaGetLastError();
}

template <int kCh>
int moments(const double* x, const int32_t* y, int64_t n, int64_t lo, int64_t hi, double sf,
            bool scaled, double* scratch, double* row, cudaStream_t stream) {
  const Source<0, kCh> s0{x, y, lo, hi, sf, scaled, 0.0, 0.0};
  if (n <= kWin) {
    small<kCh><<<1, 32, 0, stream>>>(s0, n, scratch, row);
    return (int)cudaGetLastError();
  }
  const Tree t(n);
  // the windows' 16-byte copies need x and yfix on 16-byte boundaries at
  // the windows' starts, which lie 1024 keys apart
  const int64_t start = -(t.front1 * kWin + Level(n).front);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) + 8 * start) % 16 == 0 &&
                       (kCh == 1 || (reinterpret_cast<uintptr_t>(y) + 4 * start) % 16 == 0);
  cudaError_t err = cudaMemsetAsync(scratch + kHead, 0, t.counters * sizeof(int), stream);
  if (err == cudaSuccess) err = launch_walk(s0, n, t, aligned, scratch, row, stream);
  const Source<1, kCh> s1{x, y, lo, hi, sf, scaled, 0.0, 0.0};
  if (err == cudaSuccess) err = launch_walk(s1, n, t, aligned, scratch, row, stream);
  return (int)err;
}

// --- the hint table ------------------------------------------------------

constexpr int kTableThreads = 256;
constexpr int kBlock = 8;              // keys a read: a 64-byte block of the images
constexpr int kInterp = 8;             // interpolated reads a search at most, then halving

// A search for the first key j whose masked bits m[j] >= T in (p, r]:
// m[p] < T with value lov where has_lo, m[r] >= T with value hiv where
// has_hi; p = -1 and r = n are the ends, never read.
struct Bracket {
  int64_t p, r;
  uint64_t lov, hiv;
  bool has_lo, has_hi;

  __device__ __forceinline__ void narrow(int64_t j, uint64_t v, uint64_t T) {
    if (j > p && j < r) {
      if (v < T) {
        p = j;
        lov = v;
        has_lo = true;
      } else {
        r = j;
        hiv = v;
        has_hi = true;
      }
    }
  }
};

// the keys as the table sees them: each image's u64 bits below the keys'
// common prefix
struct TableKeys {
  const int64_t* __restrict__ images;
  int64_t n, off;                      // off: the entry a 64-byte block starts past images[0]
  uint64_t mask;

  __device__ __forceinline__ uint64_t m(int64_t image) const {
    return int_bits<RmiKey::kU64>(image) & mask;
  }
  __device__ __forceinline__ int64_t block_of(int64_t j) const {
    return ((j + off) & ~(int64_t)(kBlock - 1)) - off;
  }
  // (-1, n] narrowed by the first and last key, whose masked bits m0 and
  // mlast every thread holds
  __device__ __forceinline__ Bracket ends(uint64_t m0, uint64_t mlast, uint64_t T) const {
    Bracket b{-1, n, 0, 0, false, false};
    b.narrow(0, m0, T);
    b.narrow(n - 1, mlast, T);
    return b;
  }

  // b narrowed to r = p + 1: each round reads the block that holds the
  // keys left where one does, else the one where the values known on
  // either side place T (kInterp times at most), else the middle one
  __device__ void find(uint64_t T, Bracket& b) const {
    int left = kInterp;
#pragma unroll 1
    while (b.r - b.p > 1) {
      const int64_t first = b.p + 1, last = b.r - 1;
      int64_t j;
      if (block_of(first) == block_of(last)) {
        j = first;
      } else if (b.has_lo && b.has_hi && left > 0) {
        --left;
        double f = (double)(T - b.lov) / (double)(b.hiv - b.lov);
        f = fmin(fmax(f, 0.0), 1.0);
        j = first + (int64_t)(f * (double)(b.r - b.p - 1));
        j = j > last ? last : j;
      } else {
        j = b.p + ((b.r - b.p) >> 1);
      }
      const int64_t s = block_of(j);
      int64_t v[kBlock];
      if (s >= 0 && s + kBlock <= n) {
        const longlong2* p2 = reinterpret_cast<const longlong2*>(images + s);
#pragma unroll
        for (int h = 0; h < kBlock / 2; ++h) {
          const longlong2 t = __ldg(p2 + h);
          v[2 * h] = t.x;
          v[2 * h + 1] = t.y;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kBlock; ++t) v[t] = s + t >= 0 && s + t < n ? __ldg(images + s + t) : 0;
      }
#pragma unroll
      for (int t = 0; t < kBlock; ++t) b.narrow(s + t, m(v[t]), T);
    }
  }
};

// table[b] of a hint-table top with `bits` bits over the n integer-key
// images (models/radix._make_table_fit_top), w_int = (prefix, bits): a
// thread a slot, grid-stride, each searched slot's first key found from
// the keys' two ends
__global__ void __launch_bounds__(kTableThreads)
table_fit(const int64_t* __restrict__ images, const int32_t* __restrict__ y, int64_t n,
          double sf, bool scaled, int64_t bits, int32_t* __restrict__ table,
          int64_t* __restrict__ w_int) {
  const int64_t size = (int64_t)1 << bits;
  const int64_t first = __ldg(images), last = __ldg(images + n - 1);
  // common_prefix_size: clz of the images' xor, which is their bits' xor
  const int64_t prefix = __clzll(first ^ last);
  const int64_t shift = prefix + bits > 64 ? 0 : 64 - prefix - bits;   // _table_shift
  const TableKeys k{images, n, (int64_t)((reinterpret_cast<uintptr_t>(images) >> 3) & (kBlock - 1)),
                    rmi_shr(~0ull, prefix)};
  const uint64_t m0 = k.m(first), mlast = k.m(last);
  const uint64_t last_bucket = rmi_shr(mlast, shift);
  const int64_t stride = (int64_t)gridDim.x * kTableThreads;
  for (int64_t b = (int64_t)blockIdx.x * kTableThreads + threadIdx.x; b < size; b += stride) {
    int32_t v = 0;
    if ((uint64_t)b > last_bucket) {
      v = (int32_t)size;
    } else if (b > 0) {                 // the target of the first key whose bucket is
                                        // at least b, clipped to n - 1
      const uint64_t T = (uint64_t)b << shift;
      Bracket br = k.ends(m0, mlast, T);
      k.find(T, br);
      v = (int32_t)target(__ldg(y + (br.r < n - 1 ? br.r : n - 1)), sf, scaled);
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
// refused if smaller than Tree(n).doubles() (ops/top_kernel.
// moments_scratch), as are n < 1, a span outside [0, n) and an unknown
// model
RMI_API int rmi_top_moments(const double* x, const int32_t* y, int64_t n, int64_t lo,
                            int64_t hi, double sf, int64_t scale_targets, int64_t model,
                            double* scratch, int64_t capacity, double* row, void* stream) {
  if (n < 1 || lo < 0 || hi < lo || hi > n || (model != kLinearTop && model != kNormalTop) ||
      capacity < Tree(n).doubles()) {
    return (int)cudaErrorInvalidValue;
  }
  if (model == kLinearTop) {
    return moments<2>(x, y, n, lo, hi, sf, scale_targets != 0, scratch, row, (cudaStream_t)stream);
  }
  return moments<1>(x, y, n, lo, hi, sf, scale_targets != 0, scratch, row, (cudaStream_t)stream);
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
              (cudaStream_t)stream>>>(
      images, y, n, sf, scale_targets != 0, bits, table, w_int);
  return (int)cudaGetLastError();
}
