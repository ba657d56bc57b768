// Percentile clipping: per-pixel sort + one clip pass on the relative
// distance from the median + survivor mean, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "percentile") (:271-295), reached through the
// pallas_call in _reject_stack_raw (:1079-1122). Its plain PyTorch
// version is siriltpu_torch/ops/rejection.py:reject_percentile with
// _mean_of_survivors (stacking.c:1130-1143, loop :1656-1673), which it
// matches bit for bit.
//
// plow and phigh arrive as siglow and sighigh. The predicates are IEEE
// float divisions, (median - v) / medsafe > plow and (v - median) /
// medsafe > phigh, with medsafe = 1e-30f where the median is 0. Both are
// monotone in v, so on the sorted column the flags are a prefix and a
// suffix, counted by scans in from both ends, and the survivors are a
// window. If every value is flagged (F > 1) only the last, largest one
// survives, yet the counters count every flag; F == 1 removes nothing.
// There is no degenerate path.
//
// What bounds it on an H100: the per-column sort in shared memory, as in
// reject_sigma.cu; the clip is one O(F) pass.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct PercentileBody {
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float plow, float phigh) {
    const float median = median_of(x[(f - 1) / 2], x[f / 2]);
    const float medsafe = median == 0.0f ? 1e-30f : median;
    int nlow = 0;
    while (nlow < f && (median - static_cast<float>(x[nlow])) / medsafe > plow) ++nlow;
    int nhigh = 0;
    while (nhigh < f && (static_cast<float>(x[f - 1 - nhigh]) - median) / medsafe > phigh)
      ++nhigh;
    int lo = 0, hi = f;
    if (f > 1) {
      if (nlow + nhigh >= f) {
        lo = f - 1;
      } else {
        lo = nlow;
        hi = f - nhigh;
      }
    }
    return {window_mean<Acc>(x, lo, hi), 0, nlow, nhigh};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(percentile, thread_plan<PercentileBody>, kThreadTiles)
