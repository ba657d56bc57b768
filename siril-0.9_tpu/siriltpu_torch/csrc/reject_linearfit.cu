// Linear-fit clipping of every pixel of an (F, P) uint16 stack in float64,
// in one launch, for Hopper: per pixel the sort, then passes of a
// least-squares line over (rank, sorted value), sigma = the mean absolute
// residual, and the clip by residual, until a pass removes nothing or at
// most 3 values survive; then round_to_WORD of the survivors' mean.
//
// Replaces no Pallas kernel. The JAX package computes linearfit in XLA
// (siril-0.9_tpu/siriltpu/ops/rejection.py:reject_linearfit, a float32 fit
// whose knife-edge pixels its callers re-run on the host). Its plain twin
// is siriltpu_torch/ops/rejection.py:linearfit_settle, the same float64
// arithmetic over every column of a tensor, which this kernel matches bit
// for bit: mean and both counters, every one
// verify/oracle.py:c_reject_block's (stacking.c:1750-1783). So there is no
// float32 fit and no knife-edge guard band on this route.
//
// Per pixel and pass, the C's float64 arithmetic in the C's order (no
// product is fused into an add: the library builds with -fmad=false):
// - gsl_fit_linear over x = 0 .. N-1 and the survivors y in sorted order:
//   the running mean m_y += (y - m_y) / (i + 1.0), then m_dxdy += (dx * dy
//   - m_dxdy) / (i + 1.0) with dx = i - m_x, dy = y - m_y; m_x and m_dx2
//   depend on N alone and come from a table (rejection.py:_gsl_x_moments,
//   made once for each F and kept on the device); a = m_dxdy / m_dx2,
//   b = m_y - m_x * a;
// - sigma = (the sum of |y - (a * i + b)| in rank order) / N;
// - line_clipping left to right, low before high: ((a * i + b) - y) /
//   sigma > siglow, else ((y - a * i) - b) / sigma > sighigh; siglow and
//   sighigh are doubles of the caller's values (positive normal numbers
//   below 2^1000; the launch refuses others);
// - the flag scan walks the survivors by rank writing rejected[rank] and
//   counting r across passes, and stops after the rank where N - r <= 4;
//   the removal reads rejected[rank] for every rank, so ranks past the
//   break remove values by the previous pass's stale flags, uncounted;
// - the loop goes on while the pass removed a value and N > 3 (at most
//   kMaxIters passes, as rejection.py's MAX_ITERS).
// Every quotient is the IEEE division's, but none is an IEEE division: one
// takes ~10 dependent float64 instructions and a call whose register
// saves spilled. A division by a rank or by N is a product with the rank's
// correctly rounded reciprocal and two fused corrections (div_rank), by
// m_dx2 a product with its reciprocal and a one-ulp fix-up read from the
// exact residual (div_table), both from the table; the clip compares num
// with sigma * sig and settles the few within 2^-49 of it by exact integer
// arithmetic (Clip, lf_exceeds).
//
// What bounds it on an H100: the bytes are (2F + 2) P, 0.43 GB at 50 x
// 4.19M, 0.128 ms at 3.35 TB/s. The work is float64 arithmetic and its
// issue: ~2.6 passes a pixel on the deep-sky cell's frames, each four
// loops over the ~48 survivors, ~36 float64 instructions a value in all
// (1.2 ms at the card's 16.7 T float64 instructions a second), and about
// as many others. The passes a pixel takes vary from 1 to ~16, so lanes that ran
// their passes together (a warp waiting for its slowest pixel) would run
// ~3 passes for every one that a lane needs.
//
// The design here: one thread a pixel, and a lane whose pixel has ended
// takes the next one from its block's queue, so that no lane waits for the
// slowest pixel of its warp. A launch has as many blocks as the card holds
// at once; block b owns a span of neighbouring pixels. The pixel's
// survivors stay packed in sorted order at the head of its lane's column,
// so the rank is the loop index: each loop runs to the lane's own N, and a
// warp's lanes in their first pass or their tenth run the same
// instructions. Loops over all F slots under a survivor mask (a select on
// every value) took 7.36 ms where the packed loops take 5.64, with the
// same column loads and 16 warps an SM.
// - F <= 64, the wires form (linearfit_wires): the block stages its span's
//   columns kLfHalf at a time with 16-byte row loads (stage_columns) into
//   a ring of two halves in shared memory; a lane without a pixel takes
//   the next staged column, reads it by 16-byte loads into 2H registers
//   (pads at 65535), sorts it there (the BitonicStage network) and writes
//   it to its working column in shared memory. The lanes' pixel passes end
//   on a block barrier, where the block stages its next half. Loading each
//   column from device memory instead (64 scattered loads in flight) took
//   116 registers, 16 warps an SM and 5.6 ms. rejected[] is a 64-bit
//   register;
// - larger F, or a launch with no room in shared memory (linearfit_memory):
//   a lane without a pixel takes the next one of the span by a counter in
//   shared memory, copies its column into its slot and sorts it there
//   (sort_column), in shared memory (the shared form) or a device-memory
//   scratch laid out (F, lanes) (the scratch form), with rejected[] in
//   ceil(F / 32) words beside it; its warp goes on while any lane has a
//   pixel.
// At 50 x 4.19M on the deep-sky cell's frames: 72 registers, 28 warps an
// SM, 4.45 ms, lane use 0.948 (H100 80GB HBM3 at 700 W). With a counter
// buffer (tracing on), each warp adds its pixel passes and the lane-pass
// slots it issued (32 a pass of the warp): their ratio is the lane use.

#include <algorithm>

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

constexpr int kLfThreads = 128;
// Blocks of the wires form an SM should hold: the launch bound that keeps
// its registers to 72 (the sort of 64 wires at F <= 64 the most of them),
// 28 warps an SM, as many as its shared memory allows. Timed on the card at
// 50 x 4.19M: 4.45 ms at 7, 4.79 at 6 (24 warps), 5.6 without a bound
// (16 warps at 116 registers, with the column's 64 loads all in flight).
constexpr int kLfBlocks = 7;
// Threads a block of the memory forms, largest first (0 ends).
constexpr int kLfTiles[] = {128, 64, 32, 0};

struct LfOut {
  uint16_t* mean;
  int32_t* rejl;
  int32_t* rejh;
};

// A launch's arguments, one struct so that every form takes the same.
struct LfArgs {
  const uint16_t* vals;
  int64_t ld;                      // row stride of vals, elements
  const double* moments;           // (4, F): m_x, m_dx2, RN(1 / k), RN(1 / m_dx2)
  LfOut out;
  int f;
  int64_t p;
  int64_t span;                    // pixels a block
  double siglow, sighigh;
  unsigned long long* counters;    // pixel passes, lane-pass slots; or null
  uint16_t* scratch;               // the scratch form's columns and masks
};

// The exact double of a word, by its bits: 2^52 + v less 2^52 (one add,
// where a conversion instruction runs at a quarter of the float64 rate).
__device__ __forceinline__ double word_double(uint32_t v) {
  return __hiloint2double(0x43300000, static_cast<int>(v)) - 4503599627370496.0;
}

// rejected[rank] of a pixel, read and written by rank (nonzero or not),
// F <= 64: one 64-bit register.
struct RegRejected {
  uint64_t bits;
  __device__ __forceinline__ void init(int) { bits = 0ull; }
  __device__ __forceinline__ bool get(int j) const { return (bits >> j) & 1ull; }
  // rejected[j] = v where set
  __device__ __forceinline__ void put(int j, bool set, bool v) {
    const uint64_t bit = static_cast<uint64_t>(set) << j;
    bits = (bits & ~bit) | (v ? bit : 0ull);
  }
};

// The same in memory, any F: word k at p[k * stride].
template <typename S>
struct MemRejected {
  uint32_t* p;
  S stride;
  int nw;
  __device__ __forceinline__ uint32_t& word(int k) const { return p[static_cast<S>(k) * stride]; }
  __device__ __forceinline__ void init(int) {
    for (int k = 0; k < nw; ++k) word(k) = 0u;
  }
  __device__ __forceinline__ bool get(int j) const { return (word(j >> 5) >> (j & 31)) & 1u; }
  __device__ __forceinline__ void put(int j, bool set, bool v) {
    if (!set) return;
    uint32_t& x = word(j >> 5);
    x = (x & ~(1u << (j & 31))) | (static_cast<uint32_t>(v) << (j & 31));
  }
};

// RN(d / k) for a rank divisor k = kd in [1, 2^31) whose reciprocal
// yk = RN(1 / k) is given, by one product and two fused corrections
// (Markstein): q0 = RN(d yk) is within 2 ulps of d / k, so r = d - k q0 is
// a multiple of ulp(q0) below 2k ulps of it, exact in one fma; q0 + r yk
// lies within 2^-52 ulp of d / k, while d / k, a fraction of denominator k,
// lies at least ulp / 2k from every midpoint and on none (an odd k would
// need 54 bits in d; an even k divides d by a power of two exactly), so
// the last fma rounds to RN(d / k). It holds for |d| >= 2^-900, where no
// product underflows; 0 / k is d itself, and a smaller d is scaled by
// 2^200 first (exact while the quotient stays a normal number, which it
// does for every dividend of this fit: sums and products of words and
// their means). The IEEE division would take ~10 dependent float64
// instructions on this chain, and a call.
__device__ __forceinline__ double div_rank(double d, double kd, double yk) {
  double s = 1.0;
  if (fabs(d) < 0x1p-900) {
    if (d == 0.0) return d;
    d *= 0x1p200;
    s = 0x1p-200;
  }
  const double q0 = d * yk;
  return fma(fma(-kd, q0, d), yk, q0) * s;
}

// RN(a / b) for b > 0 normal whose reciprocal y = RN(1 / b) is given, a
// finite: q0 = RN(a y) and one fused correction put q within an ulp of
// a / b (it lies within 2^-51 ulp of q0 + r0 y, r0 = a - b q0 exact), so
// RN(a / b) is q or a neighbour; the residual a - b q, exact in one fma,
// against b times half the gap to each neighbour (exact products by
// powers of two) picks it. a / b is never a midpoint (54 bits in a).
// Small |a| is scaled by 2^200 as in div_rank.
__device__ __forceinline__ double div_table(double a, double b, double y) {
  double x = fabs(a), s = 1.0;
  if (x < 0x1p-900) {
    if (x == 0.0) return a;
    x *= 0x1p200;
    s = 0x1p-200;
  }
  const double q0 = x * y;
  double q = fma(fma(-b, q0, x), y, q0);
  const double r = fma(-b, q, x);
  const long long bq = __double_as_longlong(q);
  const double up = __longlong_as_double(bq + 1), dn = __longlong_as_double(bq - 1);
  if (r > 0.0 && r > b * ((up - q) * 0.5)) q = up;
  if (r < 0.0 && -r > b * ((q - dn) * 0.5)) q = dn;
  return copysign(q * s, a);
}

// RN(num / sigma) > s decided without the division, for positive normal
// num, sigma and s with num / sigma near s: RN(x) > s just where x passes
// the midpoint of s and its successor s+ (a tie would go to the even one,
// but num / sigma is never a midpoint: that would take 54 bits in num).
// So 2 num is compared with sigma (s + s+) as exact integers: mantissas
// of 53 bits, the sum's 55, their product under 2^108, in 128 bits.
// The 53-bit mantissa m and exponent e of a positive finite double, m 2^e,
// with m in [2^52, 2^53) (a subnormal's shifted up).
__device__ __forceinline__ uint64_t lf_split(double v, int& e) {
  const uint64_t b = __double_as_longlong(v);
  const int field = static_cast<int>(b >> 52);
  uint64_t m = (b & ((1ull << 52) - 1ull)) | (field != 0 ? 1ull << 52 : 0ull);
  e = (field != 0 ? field : 1) - 1075;
  const int z = __clzll(static_cast<long long>(m)) - 11;
  m <<= z;
  e -= z;
  return m;
}

// RN(num / sigma) > s for positive finite num and sigma and positive
// normal s below 2^1000 (so its successor is finite and normal).
__device__ __forceinline__ bool lf_exceeds(double num, double sigma, double s) {
  int en, eg, es, es1;
  const uint64_t mn = lf_split(num, en), mg = lf_split(sigma, eg), ms = lf_split(s, es);
  const uint64_t ms1 = lf_split(__longlong_as_double(__double_as_longlong(s) + 1), es1);
  // s + s+ = d 2^es; the successor may start the next binade
  const uint64_t d = ms + (ms1 << (es1 - es));
  const unsigned __int128 rhs = static_cast<unsigned __int128>(mg) * d;
  // 2 num = (mn 2^k) 2^(eg + es); rhs lies in [2^105, 2^109)
  const int k = en + 1 - eg - es;
  if (k < 0 || k > 70) return k > 0;
  const unsigned __int128 lhs = static_cast<unsigned __int128>(mn) << k;
  return lhs > rhs || (lhs == rhs && (ms & 1ull));
}

// line_clipping's test num / sigma > s as the IEEE division and comparison
// decide it, for the two sides of a pass (0: low, 1: high), s positive
// normal below 2^1000. Where t = RN(sigma s) is a normal number, it is
// within 2^-53 of sigma s, so num >= RN(t (1 + 2^-49)) puts num / sigma
// above s (1 + 2^-51), past s's successor: the quotient rounds above s;
// and num <= RN(t (1 - 2^-49)) puts it below s: it rounds to s at most. A
// num between the two, or any positive num where t is not normal, is
// decided by lf_exceeds. A num at or below 0 gives a quotient at most 0;
// sigma 0 gives +inf for a positive num, and a sigma that is not a number
// gives no flag.
struct Clip {
  // one side: its sig, and num's bounds where t = RN(sigma sig) is normal
  struct Side {
    double s, lo, hi;
    bool fast;
  };
  double sigma;
  Side low, high;
  __device__ __forceinline__ Clip(double sg, double siglow, double sighigh)
      : sigma(sg), low(side(sg, siglow)), high(side(sg, sighigh)) {}
  static __device__ __forceinline__ Side side(double sg, double s) {
    const double t = sg * s;
    return {s, t * (1.0 - 0x1p-49), t * (1.0 + 0x1p-49), sg > 0.0 && t > 0x1p-900 && t < 0x1p1000};
  }
  __device__ __forceinline__ bool above(const Side& d, double num) const {
    if (d.fast) return num >= d.hi || (num > d.lo && lf_exceeds(num, sigma, d.s));
    if (!(num > 0.0)) return false;
    return sigma == 0.0 || (sigma > 0.0 && lf_exceeds(num, sigma, d.s));
  }
};

// One pixel's clip state: survivors, flags counted across passes, the
// low and high counts, the passes run and the survivors' sum.
struct LfPixel {
  int n, r, rejl, rejh, passes;
  int64_t sum;
};

// One pass of linear-fit clipping on the pixel's survivors, kept packed in
// sorted order at the head of its column x[0, n), and its rejected[rank];
// false once the pixel is done. The loops run to the lane's own n: a warp
// runs each to the largest n of its lanes, and a lane past its n idles.
// moments holds m_x and m_dx2 by N - 1, RN(1 / k) by k - 1 and RN(1 / m_dx2)
// by N - 1.
template <class C, class Rejected>
__device__ __forceinline__ bool lf_pass(const C& x, Rejected& rej, int f,
                                        const double* __restrict__ moments, double siglow,
                                        double sighigh, LfPixel& px) {
  const int n = px.n;
  const double* __restrict__ rcp = moments + 2 * f;
  const double m_x = __ldg(moments + n - 1), m_dx2 = __ldg(moments + f + n - 1);
  double m_y = 0.0, i = 0.0;
  for (int w = 0; w < n; ++w) {
    const double y = word_double(x.at(w));
    m_y = m_y + div_rank(y - m_y, i + 1.0, __ldg(rcp + w));
    i = i + 1.0;
  }
  double m_dxdy = 0.0;
  i = 0.0;
  for (int w = 0; w < n; ++w) {
    const double y = word_double(x.at(w));
    const double dx = i - m_x, dy = y - m_y;
    m_dxdy = m_dxdy + div_rank(dx * dy - m_dxdy, i + 1.0, __ldg(rcp + w));
    i = i + 1.0;
  }
  // m_dx2 is 0 at N = 1 alone, where m_dxdy is 0 too: 0 / 0
  const double a = m_dx2 == 0.0 ? (m_dxdy == 0.0 ? __longlong_as_double(0x7ff8000000000000ll)
                                                 : copysign(__longlong_as_double(0x7ff0000000000000ll), m_dxdy))
                                : div_table(m_dxdy, m_dx2, __ldg(moments + 3 * f + n - 1));
  const double b = m_y - m_x * a;
  double total = 0.0;
  i = 0.0;
  for (int w = 0; w < n; ++w) {
    const double y = word_double(x.at(w));
    total = total + fabs(y - (a * i + b));
    i = i + 1.0;
  }
  const double sigma = div_rank(total, static_cast<double>(n), __ldg(rcp + n - 1));
  const Clip clip(sigma, siglow, sighigh);
  // the flag scan, then the removal by rejected[rank], stale flags past
  // the break included, packing the survivors in place
  int kept = 0;
  int64_t sum = 0;
  bool broke = false;
  i = 0.0;
  for (int w = 0; w < n; ++w) {
    const uint32_t v = x.at(w);
    const double y = word_double(v);
    const double ai = a * i;
    const bool low = clip.above(clip.low, (ai + b) - y);
    const bool high = !low && clip.above(clip.high, (y - ai) - b);
    const bool visit = !broke;
    const bool out = visit ? low || high : rej.get(w);
    rej.put(w, visit, out);
    px.rejl += visit && low;
    px.rejh += visit && high;
    px.r += visit && out;
    broke = broke || n - px.r <= 4;
    if (!out) {
      x[kept++] = static_cast<uint16_t>(v);
      sum += v;
    }
    i = i + 1.0;
  }
  px.n = kept;
  px.sum = sum;
  return kept < n && kept > 3;
}

// round_to_WORD of the survivors' mean, as linearfit_settle: their exact
// sum over N in float64, then floor(m + 0.5); 0 for N == 0.
__device__ __forceinline__ int32_t lf_mean(int64_t s, int n, const double* __restrict__ rcp) {
  if (n <= 0) return 0;
  const double m = div_rank(static_cast<double>(s), static_cast<double>(n), __ldg(rcp + n - 1));
  return static_cast<int32_t>(fmin(floor(m + 0.5), 65535.0));
}

// A pixel's outputs.
__device__ __forceinline__ void lf_write(const LfArgs& a, int64_t px, const LfPixel& st) {
  a.out.mean[px] = static_cast<uint16_t>(lf_mean(st.sum, st.n, a.moments + 2 * a.f));
  a.out.rejl[px] = st.rejl;
  a.out.rejh[px] = st.rejh;
}

// One pass of the lane's pixel, if it has one, counted; false where the
// pixel has ended (its outputs written).
template <class C, class Rejected>
__device__ __forceinline__ bool lf_step(const LfArgs& a, const C& x, Rejected& rej, int64_t px,
                                        LfPixel& st, unsigned long long& passes) {
  ++passes;
  if (lf_pass(x, rej, a.f, a.moments, a.siglow, a.sighigh, st) && ++st.passes < kMaxIters)
    return true;
  lf_write(a, px, st);
  return false;
}

// The warp's pixel passes and lane-pass slots, added to the counters.
__device__ __forceinline__ void lf_count(const LfArgs& a, unsigned long long passes,
                                         unsigned long long slots) {
  if (a.counters == nullptr) return;
  atomicAdd(a.counters, passes);
  if (lane_id() == 0) atomicAdd(a.counters + 1, slots);
}

// Bytes of the working columns of F frames at stride `stride` halfwords,
// rounded up to 16 bytes: what lies after them starts on 16 bytes.
__host__ __device__ __forceinline__ int64_t lf_columns(int64_t f, int64_t stride) {
  return (f * stride * 2 + 15) / 16 * 16;
}

// Raw columns a block keeps staged, in two halves of kLfHalf.
constexpr int kLfHalf = 64;

// 32-bit words of a staged raw column of 2H halfwords: an odd multiple of
// 4, so that every column starts on 16 bytes and the 16-byte reads of
// neighbouring columns touch different banks.
__host__ __device__ constexpr int64_t lf_raw_words(int h) { return (h / 4 | 1) * 4; }

// F <= 2H <= 64, the wires form: 128 threads a block over shared memory
// laid out as each lane's working column (its survivors, packed, at stride
// blockDim + 2), then a ring of 2 kLfHalf raw columns of the block's span.
// The block stages kLfHalf columns at a time into the half of the ring
// whose columns have all been taken (stage_columns: 16-byte row loads),
// keeping kLfHalf or more ahead of the lanes. A lane without a pixel takes
// the next staged column, reads it by 16-byte loads into its registers,
// sorts it there (2H wires, pads at 65535) and writes it to its working
// column. Each pass of the block's warps ends on a barrier (the staging
// is the block's), which costs little: every warp's pass walks about the
// same F values.
template <int H>
__global__ void __launch_bounds__(kLfThreads, kLfBlocks) linearfit_wires(LfArgs a) {
  extern __shared__ uint16_t slab[];
  __shared__ int head, staged;
  const int f = a.f;
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * a.span;
  const int npx = static_cast<int>(a.p - px0 < a.span ? a.p - px0 : a.span);
  const int stride = kLfThreads + 2;
  const Column<int> x{slab + threadIdx.x, stride};
  constexpr int64_t words = lf_raw_words(H);
  const int64_t half_words = slot_word(kLfHalf, words);
  uint32_t* ring = reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(slab) + lf_columns(f, stride));
  // pads at 65535 past F in every raw column, once: staging writes frames
  // below F only
  for (int c = threadIdx.x; c < 2 * kLfHalf; c += kLfThreads) {
    uint16_t* raw = reinterpret_cast<uint16_t*>(ring + half_words * (c / kLfHalf) +
                                                slot_word(c % kLfHalf, words));
    for (int i = f; i < 2 * H; ++i) raw[i] = 0xffffu;
  }
  if (threadIdx.x == 0) head = staged = 0;
  __syncthreads();
  RegRejected rej;
  LfPixel st{0, 0, 0, 0, 0, 0};
  int64_t px = 0;
  bool have = false;
  unsigned long long passes = 0, slots = 0;
  for (;;) {
    // stage while kLfHalf or fewer columns are left: the half to fill holds
    // columns staged - 2 kLfHalf .. staged - kLfHalf, all taken
    while (staged < npx && staged - min(head, staged) <= kLfHalf) {
      const int c0 = staged, n = min(kLfHalf, npx - c0);
      stage_columns(a.vals, a.ld, ring + half_words * ((c0 / kLfHalf) & 1), words, f, px0 + c0,
                    n, kLfHalf);
      __syncthreads();
      if (threadIdx.x == 0) {
        head = min(head, c0);
        staged = c0 + n;
      }
      __syncthreads();
    }
    // every thread has read head above before any takes a column
    __syncthreads();
    if (!have) {
      const int k = atomicAdd(&head, 1);
      if (k < staged) {
        px = px0 + k;
        uint32_t v[H];
        load_run(v, ring + half_words * ((k / kLfHalf) & 1) + slot_word(k % kLfHalf, words));
        BitonicStage<2 * H, 2, 1>::run(v);
        const Wires<H> wv{v};
        wv.each(0, f, [&](int w, int32_t val) { x[w] = static_cast<uint16_t>(val); });
        rej.init(f);
        st = {f, 0, 0, 0, 0, 0};
        have = true;
      }
    }
    // the block is done once no lane has a pixel and none is left to stage
    if (!__syncthreads_or(have) && staged >= npx) break;
    if (__any_sync(kFull, have)) slots += 32;
    if (have) have = lf_step(a, x, rej, px, st, passes);
  }
  lf_count(a, passes, slots);
}

// Any F, the memory forms: the lane's column in shared memory at stride
// blockDim + 2 (the shared form) or in the scratch laid out (F, lanes)
// (the scratch form), and its rejected[] beside the columns, ceil(F / 32)
// words a lane. A lane without a pixel takes the next one of the block's
// span, copies its column from device memory and sorts it in place
// (sort_column); the warp goes on while any of its lanes has a pixel.
template <bool kScratch>
__global__ void __launch_bounds__(kLfThreads, 4) linearfit_memory(LfArgs a) {
  extern __shared__ uint16_t slab[];
  __shared__ int head;
  using S = std::conditional_t<kScratch, int64_t, int>;
  const int f = a.f;
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * a.span;
  const int64_t npx = a.p - px0 < a.span ? a.p - px0 : a.span;
  Column<S> x;
  MemRejected<S> rej;
  if constexpr (kScratch) {
    const int64_t lanes = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    x = {a.scratch + g, lanes};
    rej = {reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(a.scratch) + lf_columns(f, lanes)) +
               g,
           lanes, (f + 31) / 32};
  } else {
    const int stride = static_cast<int>(blockDim.x) + 2;
    x = {slab + threadIdx.x, stride};
    rej = {reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(slab) + lf_columns(f, stride)) +
               threadIdx.x,
           static_cast<int>(blockDim.x), (f + 31) / 32};
  }
  if (threadIdx.x == 0) head = 0;
  __syncthreads();
  LfPixel st{0, 0, 0, 0, 0, 0};
  int64_t px = 0;
  bool have = false, drained = false;
  unsigned long long passes = 0, slots = 0;
  for (;;) {
    if (!have && !drained) {
      const int k = atomicAdd(&head, 1);
      if (k < npx) {
        px = px0 + k;
        for (int w = 0; w < f; ++w) x[w] = a.vals[static_cast<int64_t>(w) * a.ld + px];
        sort_column(x, f);
        rej.init(f);
        st = {f, 0, 0, 0, 0, 0};
        have = true;
      } else {
        drained = true;
      }
    }
    if (!__any_sync(kFull, have)) break;
    slots += 32;
    if (have) have = lf_step(a, x, rej, px, st, passes);
  }
  lf_count(a, passes, slots);
}

using LfKernel = void (*)(LfArgs);

// The wires form's entry for F <= 64 frames.
LfKernel wires_kernel(int64_t f) {
  if (f <= 4) return linearfit_wires<2>;
  if (f <= 8) return linearfit_wires<4>;
  if (f <= 16) return linearfit_wires<8>;
  if (f <= 32) return linearfit_wires<16>;
  return linearfit_wires<32>;
}

// How a launch runs at F frames over p pixels.
struct LfPlan {
  LfKernel kernel = nullptr;
  int threads = 0;
  int64_t blocks = 0, span = 0, smem = 0, scratch = 0;
  int warps = 0;  // resident on one SM
  Form form = kShared;
};

// Bytes of the memory forms' working columns and rejected[] buffers,
// ceil(F / 32) words a lane after the columns.
int64_t lf_memory(int64_t f, int64_t stride, int64_t lanes) {
  return lf_columns(f, stride) + (f + 31) / 32 * lanes * 4;
}

// Registers a wire run of the wires form at F <= 64: 2H >= F, 2 at least.
int wire_regs(int64_t f) {
  int h = 2;
  while (2 * h < f) h *= 2;
  return h;
}

// The plan at F frames over p pixels where a block's shared memory fits in
// smem_limit bytes (< 0: the 227 KB a block may use): F <= 64, the wires
// form, 128 threads a block, its working columns and raw ring; larger F,
// the shared form at the most threads a block, 128, 64 or 32, whose
// columns fit. Else the scratch form at 128 threads a block, with no more
// blocks than scratch_limit bytes hold (one at least). The blocks are those
// the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SMs), each owning a span of ceil(p / blocks) pixels (in the
// wires form rounded up to whole halves of its ring, so that the staged
// rows start on 16 bytes where vals and ld allow). Returns a cudaError_t.
int lf_plan(int64_t f, int64_t p, int64_t smem_limit, int64_t scratch_limit, LfPlan& pl) {
  if (f < 1 || f > 0x7fffffff || p < 1) return cudaErrorInvalidValue;
  const int64_t limit = smem_limit < 0 || smem_limit > kMaxSmemBytes ? kMaxSmemBytes : smem_limit;
  pl = LfPlan{};
  if (f <= 64) {
    const int64_t smem = lf_columns(f, kLfThreads + 2) +
                         2 * slot_word(kLfHalf, lf_raw_words(wire_regs(f))) * 4;
    if (smem <= limit) pl = {wires_kernel(f), kLfThreads, 0, 0, smem, 0, 0, kWires};
  } else {
    for (const int* t = kLfTiles; *t != 0 && pl.kernel == nullptr; ++t) {
      const int64_t smem = lf_memory(f, *t + 2, *t);
      if (smem <= limit) pl = {linearfit_memory<false>, *t, 0, 0, smem, 0, 0, kShared};
    }
  }
  if (pl.kernel == nullptr) pl = {linearfit_memory<true>, kLfThreads, 0, 0, 0, 0, 0, kScratch};
  cudaError_t err = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel, pl.threads,
                                                        static_cast<size_t>(pl.smem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (pl.form == kScratch) {
    const int64_t per_block = lf_memory(f, pl.threads, pl.threads) + 4;
    blocks = std::max<int64_t>(1, std::min(blocks, scratch_limit / per_block));
  }
  blocks = std::min(blocks, p);
  pl.span = (p + blocks - 1) / blocks;
  if (pl.form == kWires) pl.span = (pl.span + kLfHalf - 1) / kLfHalf * kLfHalf;
  pl.blocks = (p + pl.span - 1) / pl.span;
  if (pl.span > 0x3fffffff) return cudaErrorInvalidValue;
  if (pl.form == kScratch) {
    const int64_t lanes = pl.blocks * pl.threads;
    pl.scratch = lf_memory(f, lanes, lanes);
  }
  pl.warps = per_sm * pl.threads / 32;
  return cudaSuccess;
}

}  // namespace

// Launch linear-fit clipping over p pixels on `stream`: vals is (F, p)
// with row stride ld (elements); moments the (4, F) float64 table of
// reject_stack._x_moments; the outputs (p,); scratch is nullptr or scratch_bytes of
// device memory, which must hold the plan's scratch; counters nullptr or
// two zeroed uint64 (pixel passes, lane-pass slots), added to. The plan is
// lf_plan's at (F, p, smem_limit, scratch_limit), as reject_linearfit_plan
// reports it. Returns a cudaError_t; the launch is asynchronous.
extern "C" int reject_linearfit_u16(const void* vals, int64_t ld, void* scratch,
                                    int64_t scratch_bytes, const void* moments, void* mean,
                                    void* rejl, void* rejh, int64_t f, int64_t p, double siglow,
                                    double sighigh, void* counters, int64_t smem_limit,
                                    int64_t scratch_limit, void* stream) {
  using namespace siriltpu;
  LfPlan pl;
  int err = lf_plan(f, p, smem_limit, scratch_limit, pl);
  if (err != cudaSuccess) return err;
  // the sigs the exact clip takes: positive normal numbers below 2^1000
  for (const double s : {siglow, sighigh})
    if (!(s >= 0x1p-1022 && s < 0x1p1000)) return cudaErrorInvalidValue;
  if (ld < p || moments == nullptr || pl.blocks > 0x7fffffff ||
      (pl.form == kScratch && (scratch == nullptr || pl.scratch > scratch_bytes)))
    return cudaErrorInvalidValue;
  const LfArgs args{static_cast<const uint16_t*>(vals),
                    ld,
                    static_cast<const double*>(moments),
                    {static_cast<uint16_t*>(mean), static_cast<int32_t*>(rejl),
                     static_cast<int32_t*>(rejh)},
                    static_cast<int>(f),
                    p,
                    pl.span,
                    siglow,
                    sighigh,
                    static_cast<unsigned long long*>(counters),
                    static_cast<uint16_t*>(scratch)};
  pl.kernel<<<static_cast<unsigned>(pl.blocks), pl.threads, static_cast<size_t>(pl.smem),
              static_cast<cudaStream_t>(stream)>>>(args);
  return cudaGetLastError();
}

// The plan at F frames over p pixels. out[7]: pixels a block, scratch form
// (0 or 1), pixels a launch (p: one launch takes any p), shared memory a
// block and scratch a launch (bytes), warps resident on one SM, and the
// Form. Returns a cudaError_t.
extern "C" int reject_linearfit_plan(int64_t f, int64_t p, int64_t smem_limit,
                                     int64_t scratch_limit, int64_t* out) {
  using namespace siriltpu;
  if (out == nullptr) return cudaErrorInvalidValue;
  LfPlan pl;
  const int err = lf_plan(f, p, smem_limit, scratch_limit, pl);
  if (err != cudaSuccess) return err;
  const int64_t got[7] = {pl.span, pl.form == kScratch ? 1 : 0, p, pl.smem, pl.scratch,
                          pl.warps, pl.form};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
  return cudaSuccess;
}
