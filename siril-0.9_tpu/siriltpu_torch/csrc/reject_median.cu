// Median stack pixel op: per-pixel sort + GSL median, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "median") (:255-269), reached through the pallas_call
// in _reject_stack_raw (:1079-1122). Its plain PyTorch version is
// siriltpu_torch/ops/rejection.py:masked_median (stacking.c:765-767),
// which it matches bit for bit.
//
// The median is 0.5f * ((float)v1 + (float)v2) of the two middle order
// statistics of the full sorted column, truncated toward zero to WORD as
// the C assignment does. There is no clip loop, so the degenerate flag and
// both counters are 0.
//
// What bounds it on an H100: the per-column sort in shared memory, as in
// reject_sigma.cu; the kernel reads F*P*2 bytes once. Only the two middle
// order statistics are needed, so a selection would do less work than
// the full sort: later work.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct MedianBody {
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float, float) {
    const float med = median_of(x[(f - 1) / 2], x[f / 2]);
    const int32_t m = static_cast<int32_t>(fminf(fmaxf(med, 0.0f), 65535.0f));
    return {m, 0, 0, 0};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(median, thread_plan<MedianBody>, kThreadTiles)
