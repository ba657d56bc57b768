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
// What bounds it on an H100: the first sort in shared memory, then one
// O(F) statistics pass and one O(F) merge per pass.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct SigmedianBody {
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float siglow, float sighigh) {
    int rl = 0, rh = 0;
    for (int it = 0; it < kMaxIters; ++it) {
      const float median = median_of(x[(f - 1) / 2], x[f / 2]);
      const int32_t anchor = x[f / 2];
      SdSums<Acc> sums;
      for (int i = 0; i < f; ++i) sums.add(static_cast<int32_t>(x[i]) - anchor);
      const float sigma = sums.sd(f);
      const Flags fl = sigma_flags(x, 0, f, median, siglow * sigma, sighigh * sigma, 0);
      const int nlow = fl.low, nhigh = fl.high;
      rl += nlow;
      rh += nhigh;
      if (nlow + nhigh == 0) break;

      const float mr = floorf(median + 0.5f);
      const uint16_t medw =
          static_cast<uint16_t>(median <= 0.0f ? 0.0f : (median > 65535.0f ? 65535.0f : mr));
      if (nlow + nhigh >= f) {
        for (int i = 0; i < f; ++i) x[i] = medw;
      } else {
        // the unflagged middle is x[nlow .. f - nhigh), sorted
        const int mid_end = f - nhigh;
        int below = 0;
        while (nlow + below < mid_end && x[nlow + below] < medw) ++below;
        for (int i = 0; i < below; ++i) x[i] = x[nlow + i];
        for (int i = mid_end - 1; i >= nlow + below; --i) x[i + nhigh] = x[i];
        for (int i = below; i < below + nlow + nhigh; ++i) x[i] = medw;
      }
      if (f <= 3) break;
    }
    return {window_mean<Acc>(x, 0, f), 0, rl, rh};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(sigmedian, thread_plan<SigmedianBody>, kThreadTiles)
