// Fused per-pixel sort + windowed sigma clip + survivor mean, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "sigma") (the sigma body, :797-856) together with the
// pallas_call in _reject_stack_raw (:1079-1122). Its plain PyTorch version
// is siriltpu_torch/ops/rejection.py:reject_sigma_window, which it matches
// bit for bit: mean, degenerate flag, and the low/high rejection counts.
// The column layout, sort and exact sums are in reject_common.cuh.
//
// What bounds it on an H100: the kernel reads F*P*2 bytes once (3.36 GB
// for 100 x 4096^2, about 1 ms at 3.35 TB/s) and writes 14 bytes a pixel.
// Against that, every pixel sorts its F values (~F log^2 F compare-
// exchanges, 1334 for F = 100) and runs a few clip passes of O(F) each,
// all on shared memory. The sort is the larger cost, so the kernel is
// bound by shared-memory instruction throughput, not by device memory.
//
// The clip loop reads the median and the sd anchor x[lo + (n-1)/2] by
// index and counts the flags with sigma_flags; siglow * sigma is a float
// product. A pixel whose scan would hit the reference's mid-scan break is
// frozen and flagged degenerate (Window::step); the wrapper re-runs it
// exactly. For F <= 4 that is every pixel (the JAX package sends such
// stacks to its HBM path instead): correct, only slower.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct SigmaBody {
  static constexpr int kSlabs = 1;

  template <typename Acc, class C>
  static __device__ Result run(const C& x, const C&, int f, float siglow, float sighigh) {
    Window win{0, f, 0, 0};
    for (int it = 0; it < kMaxIters; ++it) {
      const int lo = win.lo, hi = win.hi, n = hi - lo;
      const int32_t v1 = x[lo + (n - 1) / 2];
      const int32_t v2 = x[lo + n / 2];
      const float median = median_of(v1, v2);
      SdSums<Acc> sums;
      for (int i = lo; i < hi; ++i) sums.add(static_cast<int32_t>(x[i]) - v1);
      const float sigma = sums.sd(n);
      if (!win.step(sigma_flags(x, lo, hi, median, siglow * sigma, sighigh * sigma, 0))) break;
    }
    return {window_mean<Acc>(x, win.lo, win.hi), win.degen, win.lo, f - win.hi};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(sigma, SigmaBody)
