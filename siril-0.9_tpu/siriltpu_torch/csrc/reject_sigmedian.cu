// Median sigma clipping: per-pixel sort + replace-by-median passes +
// mean, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "sigmedian") (:297-354), reached through the
// pallas_call in _reject_stack_raw (:1079-1122). Its plain PyTorch
// version is siriltpu_torch/ops/rejection.py:reject_sigmedian with
// _mean_of_survivors (stacking.c:1696-1708), which it matches bit for bit.
//
// Each pass measures the median and the sd of all F values (the sd
// anchored on element F/2), flags values as sigma clipping does, and
// replaces every flagged value by round_to_WORD(median) = floor(median +
// 0.5) clipped to [0, 65535]. Nothing is removed: n stays F, and the mean
// is over all F values. The counters add up the flags of every pass. The
// loop stops after a pass that flagged nothing (the first pass always
// runs) or after any pass when F <= 3.
//
// The flags are a prefix and a suffix of the sorted column, and every
// replaced value becomes the same number, so the column is sorted again
// by a merge in O(F) instead of a new sort: the unflagged middle values
// below the replacement move down, those at or above it move up, and the
// replacements fill the gap.
//
// What bounds it on an H100: the kernel must read F*P*2 bytes once (0.14
// ms at config 2's 50 x 2048^2); the sort is the work, then one O(F)
// statistics pass and one O(F) merge a pass. A first design sorted in
// shared memory (see reject_percentile.cu): 2.3 ms.
//
// The design here, one thread a pixel:
// - F <= 128 (wire_kernel in reject_common.cuh): the column sorted in
//   registers as sigma does (load_sorted), written to shared memory once
//   at stride tile + 2, and every pass there. A first pass on the
//   registers, with a column written only for a pixel it flags, took more
//   registers and was slower: on config 2's data nearly every warp holds
//   such a pixel (PERF.md);
// - larger F, or the scratch: the first design (thread_plan), every pass
//   on the column in shared memory or the scratch.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

// round_to_WORD of the median: the value that replaces the flagged ones.
__device__ __forceinline__ int32_t replacement(float median) {
  const float mr = floorf(median + 0.5f);
  return static_cast<int32_t>(median <= 0.0f ? 0.0f : (median > 65535.0f ? 65535.0f : mr));
}

// The median and the flag counts of one pass on the sorted column x of f
// values.
template <typename Acc, class C>
__device__ __forceinline__ Flags sigmedian_flags(const C& x, int f, float siglow, float sighigh,
                                                 float& median) {
  const int32_t anchor = x.at(f / 2);
  const float med = median_of(x.at((f - 1) / 2), anchor);
  SdSums<Acc> sums;
  x.each(0, f, [&](int, int32_t v) { sums.add(v - anchor); });
  const float sigma = sums.sd(f);
  const float thr_low = siglow * sigma, thr_high = sighigh * sigma;
  median = med;
  return x.flags(
      f, [&](int32_t v) { return med - static_cast<float>(v) > thr_low; },
      [&](int32_t v) { return static_cast<float>(v) - med > thr_high; });
}

// Replace the flagged values of the sorted column x in memory (its first
// fl.low and last fl.high) by medw, and merge so that x stays sorted.
template <class C>
__device__ __forceinline__ void replace_merge(const C& x, int f, Flags fl, uint16_t medw) {
  const int nlow = fl.low, nhigh = fl.high;
  if (nlow + nhigh >= f) {
    for (int i = 0; i < f; ++i) x[i] = medw;
    return;
  }
  // the unflagged middle is x[nlow .. f - nhigh), sorted
  const int mid_end = f - nhigh;
  int below = 0;
  while (nlow + below < mid_end && x[nlow + below] < medw) ++below;
  for (int i = 0; i < below; ++i) x[i] = x[nlow + i];
  for (int i = mid_end - 1; i >= nlow + below; --i) x[i + nhigh] = x[i];
  for (int i = below; i < below + nlow + nhigh; ++i) x[i] = medw;
}

// One pass on the sorted column x in memory: the flags, added to the
// counters, and the replacement. False once the clip is done: the pass
// flagged nothing, or F <= 3.
template <typename Acc, class C>
__device__ __forceinline__ bool sigmedian_pass(const C& x, int f, float siglow, float sighigh,
                                               int& rl, int& rh) {
  float median;
  const Flags fl = sigmedian_flags<Acc>(x, f, siglow, sighigh, median);
  rl += fl.low;
  rh += fl.high;
  if (fl.low + fl.high == 0) return false;
  replace_merge(x, f, fl, static_cast<uint16_t>(replacement(median)));
  return f > 3;
}

struct SigmedianBody {
  // the register path writes every sorted column to shared memory
  static constexpr bool kColumn = true;

  // Every pass on the sorted column in memory.
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float siglow, float sighigh) {
    int rl = 0, rh = 0;
    for (int it = 0; it < kMaxIters && sigmedian_pass<Acc>(x, f, siglow, sighigh, rl, rh); ++it) {
    }
    return {window_mean<Acc>(x, 0, f), 0, rl, rh};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(sigmedian, wire_plan<SigmedianBody>, kThreadTiles)
