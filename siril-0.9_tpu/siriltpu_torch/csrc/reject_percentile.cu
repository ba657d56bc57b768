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
// monotone in v (the subtraction is exact and medsafe > 0), so on the
// sorted column the flags are a prefix and a suffix, and the survivors are
// a window. If every value is flagged (F > 1) only the last, largest one
// survives, yet the counters count every flag; F == 1 removes nothing.
// There is no degenerate path.
//
// What bounds it on an H100: the kernel must read F*P*2 bytes once (0.42
// GB at config 2's 50 x 2048^2, 0.14 ms at 3.35 TB/s); the clip is one
// O(F) pass, so the sort is the work. A first design sorted in shared
// memory with a pruned bitonic network, two loads and two stores a
// compare-exchange (~2,000 shared-memory instructions a pixel at F = 50):
// bound by shared-memory instructions, 1.8 ms.
//
// The design here, one thread a pixel:
// - F <= 128 (wire_kernel in reject_common.cuh): the column sorted in
//   registers as sigma does (load_sorted), and the whole body on the
//   registers: the median by two selects over the wires, the flags by
//   scans in from both ends unrolled over the wires (Wires::flags; a
//   division for each flag and one more each end) and the survivors' sum
//   by a predicated add over the wires. No shared memory, so the registers
//   alone set the occupancy;
// - larger F, or the scratch: the first design (thread_plan).

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct PercentileBody {
  // the whole body runs on the registers: no shared memory
  static constexpr bool kColumn = false;

  // On a sorted Column or Wires.
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float plow, float phigh) {
    const float median = median_of(x.at((f - 1) / 2), x.at(f / 2));
    const float medsafe = median == 0.0f ? 1e-30f : median;
    const Flags fl = x.flags(
        f, [&](int32_t v) { return (median - static_cast<float>(v)) / medsafe > plow; },
        [&](int32_t v) { return (static_cast<float>(v) - median) / medsafe > phigh; });
    int lo = 0, hi = f;
    if (f > 1) {
      if (fl.low + fl.high >= f) {
        lo = f - 1;
      } else {
        lo = fl.low;
        hi = f - fl.high;
      }
    }
    return {window_mean<Acc>(x, lo, hi), 0, fl.low, fl.high};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(percentile, wire_plan<PercentileBody>, kThreadTiles)
