// Winsorized sigma clipping: per-pixel sort + winsorization fixed point +
// windowed outer sigma clip + survivor mean, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "winsorized"), both its full-height body (:611-795)
// and its strip body (:358-609, F > 896), reached through the pallas_call
// in _reject_stack_raw (:1079-1122). The TPU needs two bodies only
// because of its scoped-VMEM limit; this is one kernel for every F. Its
// plain PyTorch version is
// siriltpu_torch/ops/rejection.py:reject_winsorized_window, which it
// matches bit for bit: mean, degenerate flag and both counters.
//
// Per pixel, on the sorted column x (stacking.c:1710-1748):
// - all arithmetic is centred on anchor = x[F/2] of the full column: a
//   value v is v - anchor in the f32 statistics;
// - each pass of the outer clip starts the fixed point from the window
//   [lo, hi) as it is: the median, and the sd anchored on x[lo + n/2];
//   and it re-seeds the working copy w from x;
// - a fixed-point step clamps w's window to round_shift(med -+ 1.5f*sig)
//   (floor(t + 0.5), clipped to [-anchor, 65535 - anchor]), then takes
//   the median of the clamped window and sig = 1.134f * its sd, anchored
//   on w[lo + n/2] (not on lo + (n-1)/2 as sigma does: that flips clip
//   decisions). It stops once sig <= 0 or |sig_new - sig| /
//   max(sig, 1e-30f) <= 0.0005f, or after 512 steps. Clamping is monotone,
//   so the window stays sorted, and the clamps of successive steps
//   compose, so w is a copy of its own: clamped values stay within
//   [0, 65535] in the original domain and w is a second uint16 slab;
// - the outer predicate is sigma's, med - v > siglow * sig, on the
//   unclamped x. The degenerate rule is sigma's (N - r <= 4 freezes and
//   flags the pixel for the wrapper's exact re-run; for F <= 4 that is
//   every pixel: correct, only slower), rejl = lo and rejh = F - hi;
// - the mean is the exact integer mean of x over the window.
//
// What bounds it on an H100: two slabs of F * tile * 2 bytes, so at F =
// 1000 a block of 32 pixels takes 128 KB of shared memory and an SM holds
// one block, one warp. Each fixed-point step is one fused clamp + sums
// pass over the window; the steps, not the sort, dominate.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

struct WinsorizedBody {
  static constexpr int kSlabs = 2;

  template <typename Acc, class C>
  static __device__ Result run(const C& x, const C& w, int f, float siglow, float sighigh) {
    const int32_t anchor = x[f / 2];
    const float lo_clip = -static_cast<float>(anchor);
    const float hi_clip = 65535.0f - static_cast<float>(anchor);
    // round_shift of the JAX code, back in the original domain
    auto bound = [&](float t) -> int32_t {
      float r = floorf(t + 0.5f);
      if (t <= lo_clip) r = lo_clip;
      if (t > hi_clip) r = hi_clip;
      return static_cast<int32_t>(r) + anchor;
    };
    auto shifted_median = [&](const C& v, int k1, int k2) {
      return median_of(static_cast<int32_t>(v[k1]) - anchor, static_cast<int32_t>(v[k2]) - anchor);
    };

    Window win{0, f, 0, 0};
    for (int oit = 0; oit < kMaxIters; ++oit) {
      const int lo = win.lo, hi = win.hi, n = hi - lo;
      const int k1 = lo + (n - 1) / 2, k2 = lo + n / 2;
      float med = shifted_median(x, k1, k2);
      float sig;
      {
        const int32_t a = x[k2];
        SdSums<Acc> sums;
        for (int i = lo; i < hi; ++i) {
          const uint16_t v = x[i];
          w[i] = v;
          sums.add(static_cast<int32_t>(v) - a);
        }
        sig = sums.sd(n);
      }
      for (int iit = 0; iit < kMaxIters; ++iit) {
        const int32_t r0 = bound(med - 1.5f * sig);
        const int32_t r1 = bound(med + 1.5f * sig);
        auto clamp = [&](int32_t v) { return v < r0 ? r0 : (v > r1 ? r1 : v); };
        const int32_t a = clamp(w[k2]);
        SdSums<Acc> sums;
        for (int i = lo; i < hi; ++i) {
          const int32_t v = clamp(w[i]);
          w[i] = static_cast<uint16_t>(v);
          sums.add(v - a);
        }
        const float med_new = shifted_median(w, k1, k2);
        const float sig_new = 1.134f * sums.sd(n);
        const bool conv = sig <= 0.0f || fabsf(sig_new - sig) / fmaxf(sig, 1e-30f) <= 0.0005f;
        med = med_new;
        sig = sig_new;
        if (conv) break;
      }
      if (!win.step(sigma_flags(x, lo, hi, med, siglow * sig, sighigh * sig, anchor))) break;
    }
    return {window_mean<Acc>(x, win.lo, win.hi), win.degen, win.lo, f - win.hi};
  }
};

}  // namespace

SIRILTPU_REJECT_ENTRY(winsorized, WinsorizedBody)
