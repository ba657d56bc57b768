// What the five rejection-stack kernels share: the column view, the
// per-column sorts, the exact sd and mean, the sigma flag scan, the window
// step of the windowed clips, the reference's exact masked loop for the
// pixels the window form cannot settle, and the launch with its plan (the
// block, shared memory and scratch layout, reported to the wrapper by
// reject_<name>_plan).
//
// Each kernel replaces one static branch of
// siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:_make_kernel, reached
// through the pallas_call in _reject_stack_raw (:1079-1122). The input is
// (F, P) uint16, F frames by P pixels, and every kernel writes (P,)
// outputs: a uint16 mean, an int32 degenerate flag and int32 low and high
// rejection counts.
//
// Who owns a pixel:
// - median, and percentile and sigmedian past F = 128 (reject_kernel
//   below): one thread a pixel column. It copies the column's F values from
//   device memory once, sorts them with a pruned bitonic network in shared
//   memory and runs its rejection on the sorted column; neighbouring
//   threads own neighbouring pixels, so every frame row is read by
//   coalesced 2-byte loads. The column lives in shared memory at stride
//   `tile` (F * tile * 2 bytes a block), or in a device-memory scratch laid
//   out (F, P) when even tile 32 does not fit in the 227 KB a block may use;
// - percentile and sigmedian up to F = 128 (wire_kernel below): one thread
//   a pixel as well, but the column is sorted in registers by a network
//   unrolled at compile time (Wires). Percentile runs its whole clip on the
//   registers; sigmedian writes the sorted column to shared memory once
//   for its clip passes;
// - sigma (reject_sigma.cu): up to F = 128 a team of T lanes a pixel (one
//   or two, chosen from F; warp wires below), its column sorted and clipped
//   in the team's registers; past it one thread a pixel on a column in
//   shared memory or the scratch;
// - winsorized (reject_winsorized.cu): a warp a pixel (a team of 32
//   lanes). Up to F = 2048 the column lives in the warp's registers
//   (warp wires below), sorted there by a warp-wide network and walked
//   there by every fixed-point step and clip count; past that the warp
//   sorts it together in shared memory and splits every step and clip
//   scan across its lanes.
//
// Degenerate pixels: a pass whose scan would hit the reference's mid-scan
// break (N - r <= 4, stacking.c:1684-1688) cannot be told by the window
// form, which freezes the pixel (Window::step). Sigma and winsorized then
// settle it inside the kernel: the warp that owns it (for sigma, the warp
// of its thread or team, one degenerate pixel at a time) re-runs the
// reference's masked loop, exact_masked below, on its sorted column in
// shared memory.
// That is rejection.py:_stale_pass with its positional stale buffer: two
// bits a frame (the validity mask by slot and the rejected[] buffer by
// rank, double-buffered), 3 * ceil(F / 32) words a warp, kept beside the
// columns in shared memory (or in the scratch). The degen output stays 1
// for such pixels; their mean and counters are the exact ones.
//
// Bit-exactness rules (each changes clip decisions if broken):
// - the sd is exact integer sums of an 8-bit split of deviations from the
//   set's upper middle value (x[lo + n/2] of a window), combined in float in the order of the JAX code; the
//   library is built without fast math and with -fmad=false, so division
//   and sqrt are IEEE and no product is fused into an add. A team adds its
//   integer sums in any order: they are exact;
// - sums are int32 while 2 * F * 65535 + F < 2^31 (F < 16384) and int64
//   past that;
// - the median is 0.5f * ((float)v1 + (float)v2);
// - the mean is the exact integer (2s + n) / (2n), clipped to [0, 65535];
// - the pass cap is rejection.py's MAX_ITERS = 512 (the Pallas kernel
//   stops at 50, a quirk of the TPU path).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace siriltpu {

constexpr int kMaxIters = 512;
// Shared memory one block may use on sm_90 (227 KB).
constexpr int64_t kMaxSmemBytes = 232448;
// Frame counts from here on sum in int64.
constexpr int64_t kWideFrames = 16384;

// The low and high flag counts of a clip pass.
struct Flags {
  int low, high;
};

// One pixel's column: element i at p[i * stride]. S is int for a column in
// shared memory and int64_t for one in the device-memory scratch.
//
// A sorted column, in memory (Column) or in registers (Wires), is read by
// the bodies through one interface: at(k), the k-th value; each(lo, hi,
// fn), fn(i, value) for every i in [lo, hi); flags(f, low, high), the
// counts of values among the first f that the predicate `low` holds for
// (it holds on a prefix of [0, 65535]) and that `high` holds for (on a
// suffix).
template <typename S>
struct Column {
  uint16_t* p;
  S stride;
  __device__ __forceinline__ uint16_t& operator[](int i) const {
    return p[static_cast<S>(i) * stride];
  }
  __device__ __forceinline__ int32_t at(int i) const { return (*this)[i]; }
  template <class Fn>
  __device__ __forceinline__ void each(int lo, int hi, Fn fn) const {
    for (int i = lo; i < hi; ++i) fn(i, at(i));
  }
  // the flags are a prefix and a suffix of the sorted column: scans in
  // from both ends
  template <class Low, class High>
  __device__ __forceinline__ Flags flags(int f, Low low, High high) const {
    Flags fl{0, 0};
    while (fl.low < f && low(at(fl.low))) ++fl.low;
    while (fl.high < f && high(at(f - 1 - fl.high))) ++fl.high;
    return fl;
  }
};

// ------------------------------------------------------ register columns
//
// A column of F <= W values sorted in W / 2 registers of one thread, two
// uint16 wires a register (W = 32, 64 or 128, pads at 65535): wire w lives
// in half w / H of register w % H (H = W / 2). Every loop over the
// registers has a constant trip count and is unrolled, so every register
// index is a compile-time constant and nothing goes to local memory.

// Launch bound of the thread-a-pixel kernels; tile is 32, 64 or 128.
constexpr int kThreads = 128;

// Blocks of kThreads an SM should hold (0: no bound) for the register sort
// of W wires (W == 0: sigma's shared-memory or scratch sort), which bounds
// ptxas's registers a thread. With no bound ptxas spills sigma's
// shared-memory and scratch sorts; at W = 32, 64 and 128 percentile takes
// 54, 54 and 84 registers, sigmedian 80, 55 and 118, none spilling.
constexpr int min_blocks(int w) { return w == 64 || w == 128 ? 0 : 4; }

// One compare-exchange stage of the bitonic sort of W uint16 wires, then
// the next stages: K is the size of the bitonic sequences being merged, J
// the distance of the wires compared. One __vminu2 / __vmaxu2 pair does the
// two compare-exchanges of registers r and r ^ J at once. Where the two
// halves go opposite ways (K == H) a byte permute puts each minimum in
// place; J == H compares the two halves of one register. The stages run up
// to the merge of sequences of KEnd wires: KEnd == W sorts all the wires,
// KEnd == W / 2 leaves wires [0, H) ascending and [H, W) descending.
template <int W, int K, int J, int KEnd = W>
struct BitonicStage {
  static constexpr int H = W / 2;
  static __device__ __forceinline__ void run(uint32_t (&v)[H]) {
    if constexpr (J == H) {
      // only at K == W, ascending: wire r against wire r + H
#pragma unroll
      for (int r = 0; r < H; ++r) {
        const uint32_t a = v[r], swapped = __byte_perm(a, 0u, 0x1032);
        v[r] = __byte_perm(__vminu2(a, swapped), __vmaxu2(a, swapped), 0x7610);
      }
    } else {
#pragma unroll
      for (int r = 0; r < H; ++r) {
        const int l = r ^ J;
        if (l > r) {
          const uint32_t lo = __vminu2(v[r], v[l]), hi = __vmaxu2(v[r], v[l]);
          if constexpr (K == H) {
            // half 0 ascending, half 1 descending
            v[r] = __byte_perm(lo, hi, 0x7610);
            v[l] = __byte_perm(hi, lo, 0x7610);
          } else {
            // both halves go one way: K < H, or K == W (all ascending)
            const bool up = (r & K) == 0;
            v[r] = up ? lo : hi;
            v[l] = up ? hi : lo;
          }
        }
      }
    }
    if constexpr (J > 1) {
      BitonicStage<W, K, J / 2, KEnd>::run(v);
    } else if constexpr (K < KEnd) {
      BitonicStage<W, 2 * K, K, KEnd>::run(v);
    }
  }
};

// Load the column of pixel px (F values at row stride ld) into the wires,
// pads (and every wire of a thread that is not `live`) at 65535, and sort
// them: the full bitonic network of W = 2H wires.
template <int H>
__device__ __forceinline__ void load_sorted(uint32_t (&v)[H], const uint16_t* __restrict__ vals,
                                            int64_t ld, int64_t px, int f, bool live) {
  auto load = [&](int i) -> uint32_t { return live && i < f ? vals[i * ld + px] : 0xffffu; };
#pragma unroll
  for (int r = 0; r < H; ++r) v[r] = load(r) | load(r + H) << 16;
  BitonicStage<2 * H, 2, 1>::run(v);
}

// The sorted wires as the bodies read them (the interface of Column).
template <int H>
struct Wires {
  const uint32_t (&v)[H];

  // the k-th smallest value, k < 2H, by compare-and-select over the
  // registers
  __device__ __forceinline__ int32_t at(int k) const {
    const int r = k & (H - 1);
    uint32_t word = v[0];
#pragma unroll
    for (int i = 1; i < H; ++i) word = r == i ? v[i] : word;
    return static_cast<int32_t>(k < H ? word & 0xffffu : word >> 16);
  }
  // wire w, for a w known at compile time (an unrolled loop's index)
  __device__ __forceinline__ int32_t wire(int w) const {
    return static_cast<int32_t>(w < H ? v[w] & 0xffffu : v[w - H] >> 16);
  }
  template <class Fn>
  __device__ __forceinline__ void each(int lo, int hi, Fn fn) const {
#pragma unroll
    for (int w = 0; w < 2 * H; ++w)
      if (w >= lo && w < hi) fn(w, wire(w));
  }
  // scans in from both ends, each over one half of the registers, then the
  // other: nvcc leaves a loop of 128 steps with an early exit rolled (and
  // the registers in local memory), and one of 64 unrolled
  template <class Low, class High>
  __device__ __forceinline__ Flags flags(int f, Low low, High high) const {
    Flags fl{0, 0};
    if (scan_half<false, true>(f, low, fl.low)) scan_half<true, true>(f, low, fl.low);
    if (scan_half<true, false>(f, high, fl.high)) scan_half<false, false>(f, high, fl.high);
    return fl;
  }
  // Add to n the wires w < f of one half (kHi: the upper halves, wires H
  // and up) that pred holds for, up (kUp) or down, until the first it
  // fails for; false if the scan ended there. Going up, w == f ends it;
  // going down, the pads w >= f are passed over.
  template <bool kHi, bool kUp, class Pred>
  __device__ __forceinline__ bool scan_half(int f, Pred pred, int& n) const {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int w = (kUp ? i : H - 1 - i) + (kHi ? H : 0);
      if (w >= f) {
        if (kUp) return false;
        continue;
      }
      if (!pred(wire(w))) return false;
      ++n;
    }
    return true;
  }
};

template <class C>
__device__ __forceinline__ void cmp_swap(const C& col, int i, int l) {
  const uint16_t a = col[i];
  const uint16_t b = col[l];
  col[i] = a < b ? a : b;
  col[l] = a < b ? b : a;
}

// Ascending sort of col[0..f): the bitonic network of the next power of
// two in its all-ascending form (a flip stage, then half-cleaners),
// keeping only comparators with both wires < f. A pad wire would hold the
// maximum value, so every comparator that touches one is a no-op. The
// control flow is data-independent: a warp never diverges while sorting.
template <class C>
__device__ __forceinline__ void sort_column(const C& col, int f) {
  for (int k = 2; k < 2 * f; k <<= 1) {
    for (int base = 0; base < f; base += k) {
      for (int t = 0; t < k / 2; ++t) {
        const int l = base + k - 1 - t;
        if (l < f) cmp_swap(col, base + t, l);
      }
    }
    for (int j = k / 4; j > 0; j >>= 1) {
      for (int base = 0; base < f; base += 2 * j) {
        for (int t = 0; t < j; ++t) {
          const int l = base + t + j;
          if (l < f) cmp_swap(col, base + t, l);
        }
      }
    }
  }
}

// Exact sums of the deviations d from an anchor and of their squares,
// split into 8-bit halves (|d| <= 65535).
template <typename Acc>
struct SdSums {
  Acc s1 = 0, shh = 0, shl = 0, sll = 0;
  __device__ __forceinline__ void add(int32_t d) {
    const int32_t ad = d < 0 ? -d : d;
    const int32_t h8 = ad >> 8, l8 = ad & 255;
    s1 += d;
    shh += h8 * h8;
    shl += h8 * l8;
    sll += l8 * l8;
  }
  // add d `times` times (times < 0 takes them off)
  __device__ __forceinline__ void add(int32_t d, Acc times) {
    const int32_t ad = d < 0 ? -d : d;
    const int32_t h8 = ad >> 8, l8 = ad & 255;
    s1 += times * d;
    shh += times * (h8 * h8);
    shl += times * (h8 * l8);
    sll += times * (l8 * l8);
  }
  // gsl_stats sample sd of the n values: the one float combine.
  __device__ __forceinline__ float sd(int n) const {
    const float nf = static_cast<float>(n);
    const float s2 = static_cast<float>(shh) * 65536.0f + static_cast<float>(shl) * 512.0f +
                     static_cast<float>(sll);
    const float s1f = static_cast<float>(s1);
    const float var = (s2 - s1f * s1f / fmaxf(nf, 1.0f)) / fmaxf(nf - 1.0f, 1.0f);
    return n > 1 ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
  }
};

__device__ __forceinline__ float median_of(int32_t v1, int32_t v2) {
  return 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
}

// round_to_WORD of the exact mean s / n: (2s + n) / (2n), clipped to
// [0, 65535]; 0 for n == 0.
template <typename Acc>
__device__ __forceinline__ int32_t round_mean(Acc s, Acc n) {
  Acc m = n > 0 ? (2 * s + n) / (2 * n) : 0;
  m = m < 0 ? 0 : (m > 65535 ? 65535 : m);
  return static_cast<int32_t>(m);
}

// The exact sum of the values lo..hi-1 of a sorted column (Column or Wires).
template <typename Acc, class C>
__device__ __forceinline__ Acc sum_of(const C& col, int lo, int hi) {
  Acc s = 0;
  col.each(lo, hi, [&](int, int32_t v) { s += v; });
  return s;
}

// round_to_WORD of the exact mean of col[lo..hi).
template <typename Acc, class C>
__device__ __forceinline__ int32_t window_mean(const C& col, int lo, int hi) {
  return round_mean<Acc>(sum_of<Acc>(col, lo, hi), hi - lo);
}

// The low and high flag counts of sigma clipping on the sorted window
// col[lo..hi), in a domain shifted by `shift`: values v with
// med - (v - shift) > thr_low, and with (v - shift) - med > thr_high. Both
// predicates are monotone in v, so the flags are a prefix and a suffix of
// the window, counted by scans in from both ends.
template <class C>
__device__ __forceinline__ Flags sigma_flags(const C& col, int lo, int hi, float med,
                                             float thr_low, float thr_high, int32_t shift) {
  Flags fl{0, 0};
  while (lo + fl.low < hi &&
         med - static_cast<float>(static_cast<int32_t>(col[lo + fl.low]) - shift) > thr_low)
    ++fl.low;
  while (hi - 1 - fl.high >= lo &&
         static_cast<float>(static_cast<int32_t>(col[hi - 1 - fl.high]) - shift) - med > thr_high)
    ++fl.high;
  return fl;
}

// The surviving window [lo, hi) of a windowed clip, the values removed so
// far, and the degenerate flag.
struct Window {
  int lo, hi, r, degen;

  // Apply one pass's flags; false once the pixel is done. A pass whose
  // scan would hit the reference's mid-scan break (N - r <= 4,
  // stacking.c:1684-1688) freezes the pixel and flags it degenerate: its
  // stale-buffer removals are not window-shaped, so its owner re-runs it
  // through exact_masked.
  __device__ __forceinline__ bool step(Flags fl) {
    const int removed = fl.low + fl.high;
    if (hi - lo - r - removed <= 4) {
      degen = 1;
      return false;
    }
    lo += fl.low;
    hi -= fl.high;
    r += removed;
    return removed != 0 && hi - lo > 3;
  }
};

struct Result {
  int32_t mean, degen, rejl, rejh;
};

struct Outputs {
  uint16_t* mean;
  int32_t* degen;
  int32_t* rejl;
  int32_t* rejh;

  __device__ __forceinline__ void write(int64_t px, const Result& r) const {
    mean[px] = static_cast<uint16_t>(r.mean);
    degen[px] = r.degen;
    rejl[px] = r.rejl;
    rejh[px] = r.rejh;
  }
};

// ------------------------------------------------------------ warp teams
//
// Every function below is called by all 32 lanes of a warp with the same
// arguments, and returns the same value to every lane.

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return static_cast<int>(threadIdx.x & 31u); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename Acc>
__device__ __forceinline__ SdSums<Acc> warp_sums(SdSums<Acc> s) {
  s.s1 = warp_sum(s.s1);
  s.shh = warp_sum(s.shh);
  s.shl = warp_sum(s.shl);
  s.sll = warp_sum(s.sll);
  return s;
}

__device__ __forceinline__ int32_t clamp_i(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Position of the m-th (0-based) set bit of `word`, which has more than m.
__device__ __forceinline__ int select_bit(uint32_t word, int m) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int c = __popc(word & ((1u << width) - 1u));
    if (m >= c) {
      m -= c;
      word >>= width;
      pos += width;
    }
  }
  return pos;
}

// A pixel's surviving values as a team sees them: the window [lo, hi) of
// the sorted column...
struct WindowSet {
  int lo, hi;
  __device__ __forceinline__ int kth(int k) const { return lo + k; }
  template <class Fn>
  __device__ __forceinline__ void for_each(Fn fn) const {
    for (int i = lo + lane_id(); i < hi; i += 32) fn(i);
  }
};

// ...or the slots whose bit is set in the validity mask valid[0, nw).
struct MaskSet {
  const uint32_t* valid;
  int nw;
  // slot of the k-th valid value: the words' popcounts, scanned across
  // the lanes 32 words at a time
  __device__ __forceinline__ int kth(int k) const {
    const int lane = lane_id();
    int base = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t word = w < nw ? valid[w] : 0u;
      const int c = __popc(word);
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (k < base + total) {
        const int src = __ffs(__ballot_sync(kFull, base + incl > k)) - 1;
        const int slot = w * 32 + select_bit(word, k - (base + incl - c));
        return __shfl_sync(kFull, slot, src);
      }
      base += total;
    }
    return 0;  // k < the number of valid slots: not reached
  }
  template <class Fn>
  __device__ __forceinline__ void for_each(Fn fn) const {
    const int lane = lane_id();
    for (int j = 0; j < nw; ++j)
      if ((valid[j] >> lane) & 1u) fn(32 * j + lane);
  }
};

// Exact sums of v(i) - a over the set, added across the team.
template <typename Acc, class Set, class V>
__device__ __forceinline__ float team_sd(const Set& s, int n, int32_t a, V v) {
  SdSums<Acc> sums;
  s.for_each([&](int i) { sums.add(v(i) - a); });
  return warp_sums(sums).sd(n);
}

// round_to_WORD of the exact mean of the set's values.
template <typename Acc, class C, class Set>
__device__ __forceinline__ int32_t team_mean(const C& x, const Set& s, int n) {
  Acc sum = 0;
  s.for_each([&](int i) { sum += x[i]; });
  return round_mean<Acc>(warp_sum(sum), n);
}

// The winsorization fixed point of one outer pass, on a set of n values of
// a sorted column, in the domain shifted by `anchor` (stacking.c:
// 1710-1740). It starts from the median and the sd of the set (the sd
// anchored on its element n/2), then clamps to round_shift(med -+
// 1.5f*sig) and measures the median and 1.134f * sd of the clamped values
// (again anchored on element n/2) until sig <= 0 or |sig_new - sig| /
// max(sig, 1e-30f) <= 0.0005f, at most kMaxIters steps. The working copy
// is never stored: clamps compose (clamp(clamp(v, A, B), r0, r1) ==
// clamp(v, clamp(A, r0, r1), clamp(B, r0, r1))), so after any number of
// steps it is clamp(x, A, B) with two bounds.
//
// x1 and x2 are the set's elements (n-1)/2 and n/2; sd(A, B, a) is the sd
// of clamp(v, A, B) over the set's values v, anchored on a: a team's exact
// sums, on a column in memory (winsor_converge) or in registers
// (winsor_wires in reject_winsorized.cu).
template <class Sd>
__device__ __forceinline__ void winsor_fixed_point(int32_t x1, int32_t x2, int32_t anchor, Sd sd,
                                                   float& med, float& sig) {
  const float lo_clip = -static_cast<float>(anchor);
  const float hi_clip = 65535.0f - static_cast<float>(anchor);
  // round_shift of the JAX code, back in the original domain
  auto bound = [&](float t) -> int32_t {
    float r = floorf(t + 0.5f);
    if (t <= lo_clip) r = lo_clip;
    if (t > hi_clip) r = hi_clip;
    return static_cast<int32_t>(r) + anchor;
  };
  med = median_of(x1 - anchor, x2 - anchor);
  sig = sd(0, 65535, x2);
  int32_t A = 0, B = 65535;
  for (int it = 0; it < kMaxIters; ++it) {
    const int32_t r0 = bound(med - 1.5f * sig);
    const int32_t r1 = bound(med + 1.5f * sig);
    A = clamp_i(A, r0, r1);
    B = clamp_i(B, r0, r1);
    const int32_t w1 = clamp_i(x1, A, B), w2 = clamp_i(x2, A, B);
    const float med_new = median_of(w1 - anchor, w2 - anchor);
    const float sig_new = 1.134f * sd(A, B, w2);
    const bool conv = sig <= 0.0f || fabsf(sig_new - sig) / fmaxf(sig, 1e-30f) <= 0.0005f;
    med = med_new;
    sig = sig_new;
    if (conv) break;
  }
}

// The fixed point on the set's values of the sorted column x in memory.
template <typename Acc, class C, class Set>
__device__ __forceinline__ void winsor_converge(const C& x, const Set& s, int n, int32_t anchor,
                                                float& med, float& sig) {
  winsor_fixed_point(
      x[s.kth((n - 1) / 2)], x[s.kth(n / 2)], anchor,
      [&](int32_t A, int32_t B, int32_t a) {
        return team_sd<Acc>(s, n, a, [&](int i) { return clamp_i(x[i], A, B); });
      },
      med, sig);
}

// Validity mask and the two rank buffers of one warp's exact pass, each
// ceil(F / 32) words.
struct Masks {
  uint32_t* valid;
  uint32_t* cur;
  uint32_t* nxt;
};

__device__ __forceinline__ Masks masks_at(uint32_t* base, int nw) {
  return {base, base + nw, base + 2 * nw};
}

// The statistics of one masked pass: (median, sigma) in the domain
// shifted by `shift`.
// Sigma (rejection.py:reject_sigma): the median and the sd of the valid
// values, the sd anchored on the valid element n/2.
struct SigmaStats {
  static constexpr int32_t shift = 0;
  template <typename Acc, class C>
  __device__ __forceinline__ void run(const C& x, const MaskSet& s, int n, float& med,
                                      float& sig) const {
    const int32_t v1 = x[s.kth((n - 1) / 2)], v2 = x[s.kth(n / 2)];
    med = median_of(v1, v2);
    sig = team_sd<Acc>(s, n, v2, [&](int i) { return static_cast<int32_t>(x[i]); });
  }
};

// Winsorized (rejection.py:reject_winsorized): the fixed point on the
// valid values, shifted by x[F/2] of the full sorted column.
struct WinsorStats {
  int32_t shift;
  template <typename Acc, class C>
  __device__ __forceinline__ void run(const C& x, const MaskSet& s, int n, float& med,
                                      float& sig) const {
    winsor_converge<Acc>(x, s, n, shift, med, sig);
  }
};

// The reference's masked loop for one pixel, run by a whole warp on the
// sorted column x of F values (rejection.py:reject_sigma and
// reject_winsorized with _stale_pass, stacking.c:1674-1748): every pass
// flags values by the sigma predicate, walks the valid values in sorted
// order counting r cumulatively and stops flagging once N - r <= 4; the
// removal then reads the positional buffer rejected[rank] for every rank,
// so ranks past the break remove by the previous pass's stale entries,
// uncounted. Starts from every slot valid and a zeroed buffer. The team
// walks 32 slots at a time: slot 32j + lane, the mask word j, ballots for
// the flag prefix counts and the break.
template <typename Acc, class C, class Stats>
__device__ __forceinline__ Result exact_masked(const C& x, int f, Masks m, float siglow, float sighigh,
                               const Stats& stats) {
  const int lane = lane_id();
  const int nw = (f + 31) / 32;
  const uint32_t lt = (1u << lane) - 1u, le = lt | (1u << lane);
  for (int w = lane; w < nw; w += 32) {
    const int left = f - 32 * w;
    m.valid[w] = left >= 32 ? kFull : (1u << left) - 1u;
    m.cur[w] = 0u;
  }
  __syncwarp();
  const MaskSet set{m.valid, nw};
  int n = f, r = 0, rl = 0, rh = 0;
  for (int it = 0; it < kMaxIters; ++it) {
    float med, sig;
    stats.template run<Acc>(x, set, n, med, sig);
    const float thr_low = siglow * sig, thr_high = sighigh * sig;
    for (int w = lane; w < nw; w += 32) m.nxt[w] = 0u;
    __syncwarp();
    int base = 0, cbase = 0, removed = 0, counted = 0;
    bool broke = false;
    for (int j = 0; j < nw; ++j) {
      const uint32_t vw = m.valid[j];
      const bool vb = (vw >> lane) & 1u;
      const float v = vb ? static_cast<float>(static_cast<int32_t>(x[32 * j + lane]) - stats.shift)
                         : 0.0f;
      const bool low = vb && med - v > thr_low;
      const bool high = vb && v - med > thr_high;
      const uint32_t fw = __ballot_sync(kFull, low || high);
      // the scan breaks after the first valid slot where N - (r + c) <= 4,
      // c counting the flags up to and including it
      const int c = cbase + __popc(fw & le);
      const uint32_t bw = __ballot_sync(kFull, vb && !broke && n - (r + c) <= 4);
      const uint32_t upto = bw ? ((bw & (0u - bw)) << 1) - 1u : kFull;
      const bool visited = vb && !broke && ((upto >> lane) & 1u);
      const int rank = base + __popc(vw & lt);
      const bool entry =
          visited ? (low || high) : (vb && ((m.cur[rank >> 5] >> (rank & 31)) & 1u));
      const uint32_t vis = __ballot_sync(kFull, visited);
      rl += __popc(__ballot_sync(kFull, low) & vis);
      rh += __popc(__ballot_sync(kFull, high) & vis);
      counted += __popc(fw & vis);
      const bool remove = vb && entry;
      const uint32_t rw = __ballot_sync(kFull, remove);
      // the entries of this word's valid slots, at their ranks
      const uint32_t comp = __reduce_or_sync(kFull, remove ? 1u << __popc(vw & lt) : 0u);
      __syncwarp();
      if (lane == 0) {
        m.valid[j] = vw & ~rw;
        const int sh = base & 31;
        m.nxt[base >> 5] |= comp << sh;
        if (sh != 0 && __popc(vw) > 32 - sh) m.nxt[(base >> 5) + 1] |= comp >> (32 - sh);
      }
      __syncwarp();
      removed += __popc(rw);
      cbase += __popc(fw);
      base += __popc(vw);
      broke = broke || bw != 0u;
    }
    n -= removed;
    r += counted;
    uint32_t* t = m.cur;
    m.cur = m.nxt;
    m.nxt = t;
    if (removed == 0 || n <= 3) break;
  }
  return {team_mean<Acc>(x, set, n), 1, rl, rh};
}

// ------------------------------------------------------------ warp wires
//
// A column of F <= 2HT values held by a team of T lanes (T a power of two,
// the warp at T = 32; a warp holds 32 / T teams, each on its own pixel), H
// registers a lane, two uint16 wires a register, pads at 65535: lane l of
// the team holds the run of wires 2Hl .. 2Hl + 2H - 1, wire 2Hl + w in half
// w / H of register w % H (the layout of Wires, one run a lane). Sorted,
// the wires are the column in ascending order. Every loop over the
// registers has a constant trip count and is unrolled, so every register
// index is a compile-time constant. Every function below is called by all
// 32 lanes of a warp, and a value it returns is the same in every lane of a
// team.

// The exact sum of a value over the team's lanes: the warp's reduction
// at T = 32, else shuffles across the team (a reduction under a mask of a
// few lanes is slower).
template <int T>
__device__ __forceinline__ uint32_t team_add(uint32_t x) {
  static_assert(T >= 1 && T <= 32 && (T & (T - 1)) == 0, "a power of two of lanes, 32 at most");
  if constexpr (T == 32) {
    return __reduce_add_sync(kFull, x);
  } else {
#pragma unroll
    for (int o = T / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
  }
}

// The first stage of the merge of sorted runs of m + 1 lanes (m + 1 a
// power of two, at least 2): wire g against wire g ^ (2H(m + 1) - 1), the
// all-ascending flip of sort_column. Wire w of a lane meets wire 2H - 1 - w
// of lane ^ m: register r meets the partner's register H - 1 - r with its
// halves swapped. The lane in the lower half of its block keeps the minima.
template <int H>
__device__ __forceinline__ void lanes_flip(uint32_t (&v)[H], int m) {
  const bool keep_min = (lane_id() & ((m + 1) >> 1)) == 0;
#pragma unroll
  for (int r = 0; r < H / 2; ++r) {
    const int s = H - 1 - r;
    // both of a pair are read before either is written
    const uint32_t a = __byte_perm(__shfl_xor_sync(kFull, v[s], m), 0u, 0x1032);
    const uint32_t b = __byte_perm(__shfl_xor_sync(kFull, v[r], m), 0u, 0x1032);
    v[r] = keep_min ? __vminu2(v[r], a) : __vmaxu2(v[r], a);
    v[s] = keep_min ? __vminu2(v[s], b) : __vmaxu2(v[s], b);
  }
}

// A half-cleaner stage across lanes: wire g against wire g ^ (2Hm), the
// same register of lane ^ m; the lower lane keeps the minima.
template <int H>
__device__ __forceinline__ void lanes_half(uint32_t (&v)[H], int m) {
  const bool keep_min = (lane_id() & m) == 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const uint32_t o = __shfl_xor_sync(kFull, v[r], m);
    v[r] = keep_min ? __vminu2(v[r], o) : __vmaxu2(v[r], o);
  }
}

// Ascending sort of each team's 2HT wires: each lane's run by the register
// network of BitonicStage, then the merges of runs of 2, 4, ..., T lanes,
// each a flip across lanes, the half-cleaners that cross lanes (shuffles)
// and those inside a lane (BitonicStage at K == W, all ascending). A
// shuffle by lane ^ m, m < T, stays inside the team.
template <int T = 32, int H>
__device__ __forceinline__ void warp_sort(uint32_t (&v)[H]) {
  static_assert(H >= 2 && (H & (H - 1)) == 0, "a power of two of registers, two at least");
  constexpr int W = 2 * H;
  BitonicStage<W, 2, 1>::run(v);
#pragma unroll
  for (int lanes = 2; lanes <= T; lanes <<= 1) {
    lanes_flip(v, lanes - 1);
#pragma unroll
    for (int m = lanes / 4; m >= 1; m >>= 1) lanes_half(v, m);
    BitonicStage<W, W, H>::run(v);
  }
}

// Register O + (r mod N) of v, by a tree of selects on the bits of r (every
// register index a constant).
template <int O, int N, int H>
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[H], int r) {
  if constexpr (N == 1) {
    return v[O];
  } else {
    const uint32_t lo = pick<O, N / 2>(v, r), hi = pick<O + N / 2, N / 2>(v, r);
    return (r & (N / 2)) != 0 ? hi : lo;
  }
}

// Wire k of the team's sorted column (k < 2HT, the same k in every lane
// of the team), read by the lane that holds it and handed round the team.
template <int T, int H>
__device__ __forceinline__ int32_t team_at(const uint32_t (&v)[H], int k) {
  const uint32_t w = pick<0, H>(v, k);
  const int32_t x = static_cast<int32_t>((k & H) != 0 ? w >> 16 : w & 0xffffu);
  if constexpr (T == 1) {
    return x;
  } else {
    return __shfl_sync(kFull, x, k / (2 * H), T);
  }
}

// The wires of the team at most L (L in [-1, 65535]) and at least U (U in
// [0, 65536]): per half, max(v, L + 1) - v is nonzero just where v <= L,
// and v - min(v, U - 1) just where v >= U (neither borrows across the
// halves); each, capped at 1, is added. L = 65535 and U = 0 take every
// wire.
template <int T, int H>
__device__ __forceinline__ Flags wire_counts(const uint32_t (&v)[H], int32_t L, int32_t U) {
  const uint32_t ll = static_cast<uint32_t>(L < 65535 ? L + 1 : 65535) * 0x10001u;
  const uint32_t uu = static_cast<uint32_t>(U > 65535 ? 65535 : U > 0 ? U - 1 : 0) * 0x10001u;
  uint32_t nl = 0, nh = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    nl += __vminu2(__vmaxu2(v[r], ll) - v[r], 0x00010001u);
    nh += __vminu2(v[r] - __vminu2(v[r], uu), 0x00010001u);
  }
  const int low = static_cast<int>(team_add<T>(__dp2a_lo(nl, 0x0101u, 0u)));
  const int high = static_cast<int>(team_add<T>(__dp2a_lo(nh, 0x0101u, 0u)));
  return {L < 65535 ? low : 2 * H * T, U > 0 ? high : 2 * H * T};
}

// Put `fill` in every wire outside the window [lo, hi) of the sorted
// column; the wires inside keep their values.
template <int H>
__device__ __forceinline__ void narrow(uint32_t (&v)[H], int lo, int hi, int32_t fill) {
  const int g0 = lane_id() * 2 * H;
  const uint32_t ff = static_cast<uint32_t>(fill) * 0x10001u;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int a = g0 + r, b = g0 + r + H;
    const uint32_t keep =
        (a >= lo && a < hi ? 0x0000ffffu : 0u) | (b >= lo && b < hi ? 0xffff0000u : 0u);
    v[r] = (v[r] & keep) | (ff & ~keep);
  }
}

// The exact sum of every wire of the team.
template <int T = 32, int H>
__device__ __forceinline__ int32_t wire_total(const uint32_t (&v)[H]) {
  uint32_t s = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) s = __dp2a_lo(v[r], 0x0101u, s);
  return static_cast<int32_t>(team_add<T>(s));
}

// The exact sum of every wire of the team, each clamped to [A, B].
template <int T, int H>
__device__ __forceinline__ int32_t wire_total(const uint32_t (&v)[H], int32_t A, int32_t B) {
  const uint32_t aa = static_cast<uint32_t>(A) * 0x10001u;
  const uint32_t bb = static_cast<uint32_t>(B) * 0x10001u;
  uint32_t s = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) s = __dp2a_lo(__vmaxu2(__vminu2(v[r], bb), aa), 0x0101u, s);
  return static_cast<int32_t>(team_add<T>(s));
}

// Exact sums of clamp(v, A, B) - a over every wire of the team (A <= B),
// two wires a register: the clamp and |d| by 16-bit SIMD (max - min has no
// borrow across the halves), the 8-bit split products by __dp4a, the sum by
// __dp2a. A wire whose value clamps to a adds 0: narrow() fills the wires
// outside a window with its element n/2, which clamps to the step's anchor.
// int32 holds them: 2HT <= 2048 wires of at most 65535. kClamp = false
// skips the clamp, for A = 0 and B = 65535.
template <int T = 32, bool kClamp = true, int H>
__device__ __forceinline__ SdSums<int32_t> wire_sums(const uint32_t (&v)[H], int32_t A, int32_t B,
                                                     int32_t a) {
  const uint32_t aa = static_cast<uint32_t>(A) * 0x10001u;
  const uint32_t bb = static_cast<uint32_t>(B) * 0x10001u;
  const uint32_t cc = static_cast<uint32_t>(a) * 0x10001u;
  uint32_t sc = 0, hh = 0, hl = 0, ll = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const uint32_t c = kClamp ? __vmaxu2(__vminu2(v[r], bb), aa) : v[r];
    const uint32_t d = __vmaxu2(c, cc) - __vminu2(c, cc);
    const uint32_t l8 = d & 0x00ff00ffu, h8 = __byte_perm(d, 0u, 0x4341);
    ll = __dp4a(l8, l8, ll);
    hh = __dp4a(h8, h8, hh);
    hl = __dp4a(l8, h8, hl);
    sc = __dp2a_lo(c, 0x0101u, sc);
  }
  SdSums<int32_t> s;
  s.s1 = static_cast<int32_t>(team_add<T>(sc)) - 2 * H * T * a;
  s.shh = static_cast<int32_t>(team_add<T>(hh));
  s.shl = static_cast<int32_t>(team_add<T>(hl));
  s.sll = static_cast<int32_t>(team_add<T>(ll));
  return s;
}

// sigma_flags on the window of n values of the sorted wires, whose other
// wires narrow() filled with `fill`: each lane counts its wires that meet
// each predicate, the warp adds the counts, and the 64H - n filled wires'
// share comes off. Both predicates are monotone in v, so on a sorted
// column the counts are the lengths of the prefix and the suffix that
// sigma_flags scans. t = v - shift as a float, exactly as
// static_cast<float>(v - shift): 2^23 + v by its bits, less 2^23 + shift
// (both exact, and so is their difference).
template <int H>
__device__ __forceinline__ Flags wire_flags(const uint32_t (&v)[H], int n, int32_t fill, float med,
                                            float thr_low, float thr_high, int32_t shift) {
  const float k = 8388608.0f + static_cast<float>(shift);
  auto low = [&](float t) { return med - t > thr_low; };
  auto high = [&](float t) { return t - med > thr_high; };
  int nl = 0, nh = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float t = __int_as_float(__byte_perm(v[r], 0x4b000000u, half ? 0x7432 : 0x7410)) - k;
      nl += low(t);
      nh += high(t);
    }
  }
  const float tf = static_cast<float>(fill - shift);
  const int out = 64 * H - n;
  return {static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(nl))) - (low(tf) ? out : 0),
          static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(nh))) -
              (high(tf) ? out : 0)};
}

// The first word of pixel k's slot: k * words, and 4 more for every 8
// pixels before it, so that the slots of 8 neighbouring pixels (one 16-byte
// chunk of a row) start 4 banks after the 8 before them.
__host__ __device__ __forceinline__ int64_t slot_word(int k, int64_t words) {
  return k * words + (k >> 3) * 4;
}

// Copy a block's columns into its pixels' slots: pixel k of the block at
// ws + slot_word(k, words), frame i at its halfword i; `tile` pixels a
// block, npx of them past the launch's first pixel px0. Each row gives
// 2 * npx contiguous bytes. Where those are whole aligned 16-byte chunks
// (8 pixels each), thread t loads the chunks t, t + blockDim, ... of the
// pairs of rows in turn (a pair's chunks numbered up to the next power of
// two, those past its last skipped), and stores frames 2j and 2j + 1 of a
// pixel as one word (an odd F's last frame alone), so a warp reads whole
// sectors and a block's loads are few and all in flight at once; else
// thread t reads pixel t % tile of every (blockDim / tile)-th row from row
// t / tile.
__device__ __forceinline__ void stage_columns(const uint16_t* __restrict__ vals, int64_t ld,
                                              uint32_t* ws, int64_t words, int f, int64_t px0,
                                              int npx, int tile) {
  const uint16_t* src = vals + px0;
  if (npx % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(ld) * 2) & 15) == 0) {
    const int chunks = npx / 8, lg = 32 - __clz(chunks - 1);
    for (int c = threadIdx.x; c < (f + 1) / 2 << lg; c += blockDim.x) {
      const int j = c >> lg, g = c & ((1 << lg) - 1);
      if (g >= chunks) continue;
      const uint16_t* row = src + 2 * j * ld + 8 * g;
      const uint4 a = *reinterpret_cast<const uint4*>(row);
      const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
      if (2 * j + 1 < f) {
        const uint4 b = *reinterpret_cast<const uint4*>(row + ld);
        const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          ws[slot_word(8 * g + k, words) + j] =
              __byte_perm(wa[k / 2], wb[k / 2], k % 2 ? 0x7632 : 0x5410);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          reinterpret_cast<uint16_t*>(ws + slot_word(8 * g + k, words))[2 * j] =
              static_cast<uint16_t>(wa[k / 2] >> (16 * (k % 2)));
      }
    }
    return;
  }
  const int k = threadIdx.x & (tile - 1);
  if (k >= npx) return;
  const int first = threadIdx.x / tile;
  const int rows = blockDim.x / tile;
  const int64_t step = rows * ld;
  src += first * ld + k;
  uint16_t* dst = reinterpret_cast<uint16_t*>(ws + slot_word(k, words));
  for (int i = first; i < f; i += rows, src += step) dst[i] = *src;
}

// Read a lane's run of 2H halfwords from src into its H registers, 16
// bytes a load where the run is a multiple of 16 bytes: register r takes
// word r, halfwords 2r and 2r + 1 (any order will do for a run about to be
// sorted).
template <int H>
__device__ __forceinline__ void load_run(uint32_t (&v)[H], const uint32_t* src) {
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[q];
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < H; ++r) v[r] = src[r];
  }
}

// Write the lane's run of sorted wires to its 2H halfwords of dst, 16
// bytes a store where the run is a multiple of 16 bytes: word k of the run
// holds wires 2k and 2k + 1.
template <int H>
__device__ __forceinline__ void store_run(const uint32_t (&v)[H], uint32_t* dst) {
  auto word = [&](int k) -> uint32_t {
    return 2 * k < H ? __byte_perm(v[2 * k], v[2 * k + 1], 0x5410)
                     : __byte_perm(v[2 * k - H], v[2 * k + 1 - H], 0x7632);
  };
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int q = 0; q < H / 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(word(4 * q), word(4 * q + 1), word(4 * q + 2), word(4 * q + 3));
  } else {
#pragma unroll
    for (int k = 0; k < H; ++k) dst[k] = word(k);
  }
}

// ----------------------------------------------------------- launching

using KernelFn = void (*)(const uint16_t*, int64_t, uint16_t*, Outputs, int, int64_t, float,
                          float);

// How a kernel runs at F frames over p pixels: its entry, its block
// (threads and the pixels they own), its dynamic shared memory a block and
// its device-memory scratch a launch, in bytes (0 off the scratch path);
// kernel == nullptr for a tile the kernel does not take; and its form.
// Each kernel's plan function, Plan(f, tile, scratch, p), is the one place
// its layout is written down: the launch and the plan query both read it.
// Where a launch sorts its columns: in registers (a thread's or a warp's),
// in shared memory, in the device-memory scratch (plan_query sets that one
// for the scratch path), or in the registers of a team of lanes.
enum Form : int { kShared = 0, kWires = 1, kScratch = 2, kTeam = 3 };

struct Plan {
  KernelFn kernel;
  int threads, pixels;
  int64_t smem, scratch;
  Form form = kShared;
};

// Pixels a block of the thread-a-pixel kernels, largest first (0 ends).
constexpr int kThreadTiles[] = {128, 64, 32, 0};

// A thread a pixel: Body::run<Acc>(x, f, siglow, sighigh) -> Result, on
// the sorted column x, in shared memory at stride `tile` or in the scratch
// laid out (F, P).
template <class Body, bool kScratch, typename Acc>
__global__ void reject_kernel(const uint16_t* __restrict__ vals, int64_t ld,
                              uint16_t* __restrict__ scratch, Outputs out, int f, int64_t p,
                              float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  using S = std::conditional_t<kScratch, int64_t, int>;
  const int64_t px = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (px >= p) return;
  Column<S> x;
  if constexpr (kScratch) {
    x = {scratch + px, p};
  } else {
    x = {slab + threadIdx.x, static_cast<int>(blockDim.x)};
  }
  // F * P reaches 1.7e9 at 100 x 4096^2: offsets are 64-bit.
  for (int i = 0; i < f; ++i) x[i] = vals[static_cast<int64_t>(i) * ld + px];
  sort_column(x, f);
  out.write(px, Body::template run<Acc>(x, f, siglow, sighigh));
}

// tile pixels a block (32, 64 or 128), F * tile * 2 bytes of shared
// memory, or the scratch: the (F, p) columns.
template <class Body>
Plan thread_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (tile != 32 && tile != 64 && tile != 128) return {};
  const int t = static_cast<int>(tile);
  if (!scratch) return {reject_kernel<Body, false, int32_t>, t, t, f * tile * 2, 0};
  if (f < kWideFrames) return {reject_kernel<Body, true, int32_t>, t, t, 0, f * p * 2};
  return {reject_kernel<Body, true, int64_t>, t, t, 0, f * p * 2};
}

// A thread a pixel with its column of F <= W sorted in registers, then
// Body::run<int32_t>(x, f, siglow, sighigh) -> Result: on the sorted wires,
// or, for a body that keeps a column in memory (Body::kColumn), on the
// wires written once to shared memory at stride tile + 2 (an odd number of
// words, so a warp's lanes touch 32 different banks).
template <class Body, int W>
__global__ void __launch_bounds__(kThreads, min_blocks(W))
    wire_kernel(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__,
                Outputs out, int f, int64_t p, float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  const int64_t px = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (px >= p) return;
  uint32_t v[W / 2];
  load_sorted(v, vals, ld, px, f, true);
  const Wires<W / 2> w{v};
  if constexpr (Body::kColumn) {
    const Column<int> x{slab + threadIdx.x, static_cast<int>(blockDim.x) + 2};
    w.each(0, f, [&](int i, int32_t val) { x[i] = static_cast<uint16_t>(val); });
    out.write(px, Body::template run<int32_t>(x, f, siglow, sighigh));
  } else {
    out.write(px, Body::template run<int32_t>(w, f, siglow, sighigh));
  }
}

// F <= 128 on the register sort of 32, 64 or 128 wires, with F * (tile + 2)
// * 2 bytes of shared memory a block where Body::kColumn, else none; larger
// F, and the scratch path, as thread_plan.
template <class Body>
Plan wire_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (scratch || f > 128 || (tile != 32 && tile != 64 && tile != 128))
    return thread_plan<Body>(f, tile, scratch, p);
  const int t = static_cast<int>(tile);
  const KernelFn k = f <= 32   ? wire_kernel<Body, 32>
                     : f <= 64 ? wire_kernel<Body, 64>
                               : wire_kernel<Body, 128>;
  return {k, t, t, Body::kColumn ? f * (tile + 2) * 2 : 0, 0, kWires};
}

// Launch a plan over p pixels on `stream`. vals is (F, p) with row stride
// ld (elements); the outputs are (p,); scratch is nullptr or scratch_bytes
// of device memory, which must hold the plan's scratch. Returns a
// cudaError_t; the launch is asynchronous.
inline int launch_plan(const Plan& pl, const void* vals, int64_t ld, void* scratch,
                       int64_t scratch_bytes, void* mean, void* degen, void* rejl, void* rejh,
                       int64_t f, int64_t p, float siglow, float sighigh, void* stream) {
  if (pl.kernel == nullptr || f < 1 || f > 0x7fffffff || p < 1 || ld < p ||
      pl.smem > kMaxSmemBytes || (scratch != nullptr && pl.scratch > scratch_bytes))
    return cudaErrorInvalidValue;
  const int64_t blocks = (p + pl.pixels - 1) / pl.pixels;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  const Outputs out{static_cast<uint16_t*>(mean), static_cast<int32_t*>(degen),
                    static_cast<int32_t*>(rejl), static_cast<int32_t*>(rejh)};
  pl.kernel<<<static_cast<unsigned>(blocks), pl.threads, static_cast<size_t>(pl.smem),
              static_cast<cudaStream_t>(stream)>>>(static_cast<const uint16_t*>(vals), ld,
                                                   static_cast<uint16_t*>(scratch), out,
                                                   static_cast<int>(f), p, siglow, sighigh);
  return cudaGetLastError();
}

// Warps of the plan's kernel resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -cudaError_t.
inline int resident_warps(const Plan& pl) {
  if (pl.kernel == nullptr || pl.smem > kMaxSmemBytes) return -cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pl.kernel, pl.threads,
                                                        static_cast<size_t>(pl.smem));
  return err == cudaSuccess ? blocks * pl.threads / 32 : -static_cast<int>(err);
}

// The launch of a kernel at F frames over p pixels: the first of `tiles`
// (largest first, 0 ends) whose block fits in smem_limit bytes of shared
// memory (< 0: the 227 KB a block may use); where none fits, the scratch
// path at the first tile, with the pixels a launch cut to whole blocks
// until a launch's scratch fits in scratch_limit bytes (one block at
// least). out[7]: tile, scratch path (0 or 1), pixels a launch, shared
// memory a block, scratch a launch (bytes), warps resident on one SM, and
// the Form. Returns a cudaError_t.
template <class PlanFn>
inline int plan_query(PlanFn plan, const int* tiles, int64_t f, int64_t p, int64_t smem_limit,
                      int64_t scratch_limit, int64_t* out) {
  if (f < 1 || f > 0x7fffffff || p < 1 || out == nullptr) return cudaErrorInvalidValue;
  const int64_t limit = smem_limit < 0 || smem_limit > kMaxSmemBytes ? kMaxSmemBytes : smem_limit;
  int64_t tile = tiles[0], chunk = p;
  bool scratch = true;
  Plan pl{};
  for (const int* t = tiles; *t != 0 && scratch; ++t) {
    pl = plan(f, *t, false, p);
    if (pl.kernel != nullptr && pl.smem <= limit) {
      tile = *t;
      scratch = false;
    }
  }
  if (scratch) {
    // a launch's scratch grows by the same bytes with each block
    const int64_t blocks = scratch_limit / plan(f, tile, true, tile).scratch;
    chunk = (blocks > 1 ? blocks : 1) * tile;
    chunk = chunk < p ? chunk : p;
    pl = plan(f, tile, true, chunk);
  }
  const int warps = resident_warps(pl);
  if (warps < 0) return -warps;
  const int64_t got[7] = {tile, scratch ? 1 : 0, chunk, pl.smem, pl.scratch, warps,
                          scratch ? kScratch : pl.form};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
  return cudaSuccess;
}

}  // namespace siriltpu

// The C entries of one kernel, given its plan function Plan(f, tile,
// scratch, p) and its tiles: reject_<name>_u16 launches it over p pixels
// (see launch_plan; scratch is nullptr or scratch_bytes of device memory),
// and reject_<name>_plan reports its launch at F frames over p pixels (see
// plan_query).
#define SIRILTPU_REJECT_ENTRY(name, plan, tiles)                                              \
  extern "C" int reject_##name##_u16(const void* vals, int64_t ld, void* scratch,             \
                                     int64_t scratch_bytes, void* mean, void* degen,          \
                                     void* rejl, void* rejh, int64_t f, int64_t p,            \
                                     int64_t tile, float siglow, float sighigh,               \
                                     void* stream) {                                          \
    return siriltpu::launch_plan(plan(f, tile, scratch != nullptr, p), vals, ld, scratch,     \
                                 scratch_bytes, mean, degen, rejl, rejh, f, p, siglow,        \
                                 sighigh, stream);                                            \
  }                                                                                           \
  extern "C" int reject_##name##_plan(int64_t f, int64_t p, int64_t smem_limit,               \
                                      int64_t scratch_limit, int64_t* out) {                  \
    return siriltpu::plan_query(plan, tiles, f, p, smem_limit, scratch_limit, out);           \
  }
