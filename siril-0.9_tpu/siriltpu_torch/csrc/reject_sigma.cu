// Fused per-pixel sort + windowed sigma clip + survivor mean, with the
// exact re-run of degenerate pixels, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "sigma") (the sigma body, :797-856) together with the
// pallas_call in _reject_stack_raw (:1079-1122) and the wrapper's fix-up of
// degenerate pixels (reject_stack_pallas :1143-1167). Its plain PyTorch
// version is siriltpu_torch/ops/cuda/reject_stack.py:reject_plain
// ("sigma": reject_sigma_window, then the masked reject_sigma on the
// degenerate pixels), which it matches bit for bit: mean, degenerate flag,
// and the low/high rejection counts.
//
// What bounds it on an H100: the kernel must read F*P*2 bytes once (3.36
// GB for 100 x 4096^2, 1.07 ms at 3.35 TB/s) and write 14 bytes a pixel.
// Against that, every pixel sorts its F values and runs a few clip passes
// of O(F) each. A first design sorted in shared memory with a pruned
// bitonic network, four shared-memory accesses a compare-exchange (~5.3k
// a pixel at F = 100): bound by shared-memory instructions, 18.6 ms.
//
// The design here, one thread a pixel:
// - F <= 128: the thread loads its column (coalesced across the warp:
//   neighbouring threads, neighbouring pixels) into W / 2 registers, two
//   uint16 wires a register, W = 32, 64 or 128 wires with pads at 65535,
//   and sorts them with the full bitonic network of W wires unrolled at
//   compile time (load_sorted in reject_common.cuh, shared with percentile
//   and sigmedian; every register index a constant, so nothing goes to
//   local memory), one __vminu2 / __vmaxu2 pair for two compare-exchanges:
//   ALU work, no shared memory. It then writes the sorted column to shared
//   memory once (F stores) for the clip passes, which read the median and
//   the anchor by a runtime index;
// - larger F: that first body, the pruned network on the column in shared
//   memory; past 227 KB at tile 32, on a device-memory scratch laid out
//   (F, P).
// Columns in shared memory sit at stride tile + 2 (an odd number of
// words), so a thread's own column and a warp reading one column across
// its lanes both touch 32 different banks.
//
// The clip loop reads the median and the sd anchor by index (the anchor is
// the upper middle value x[lo + n/2], as _gsl_sd and SigmaStats take it:
// at even n the float32 combine of a lower anchor rounds some sds apart)
// and counts the flags with sigma_flags; siglow * sigma is a float
// product. A pixel whose scan would hit the reference's mid-scan break is
// frozen and flagged degenerate (Window::step); then the warp settles each
// of its degenerate pixels in turn with exact_masked (reject_common.cuh),
// all 32 lanes on that pixel's column. For F <= 4 that is every pixel:
// correct, only slower.

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

// The windowed sigma clip of one thread's sorted column.
template <typename Acc, class C>
__device__ __forceinline__ Result sigma_window(const C& x, int f, float siglow,
                                               float sighigh) {
  Window win{0, f, 0, 0};
  for (int it = 0; it < kMaxIters; ++it) {
    const int lo = win.lo, hi = win.hi, n = hi - lo;
    const int32_t v1 = x[lo + (n - 1) / 2];
    const int32_t v2 = x[lo + n / 2];
    const float median = median_of(v1, v2);
    SdSums<Acc> sums;
    for (int i = lo; i < hi; ++i) sums.add(static_cast<int32_t>(x[i]) - v2);
    const float sigma = sums.sd(n);
    if (!win.step(sigma_flags(x, lo, hi, median, siglow * sigma, sighigh * sigma, 0))) break;
  }
  return {window_mean<Acc>(x, win.lo, win.hi), win.degen, win.lo, f - win.hi};
}

// W > 0: the register sort of W wires (F <= W); W == 0: the shared-memory
// or scratch sort.
template <int W, bool kScratch, typename Acc>
__global__ void __launch_bounds__(kThreads, min_blocks(W))
    sigma_kernel(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__ scratch,
                 Outputs out, int f, int64_t p, float siglow, float sighigh) {
  static_assert(W == 0 || !kScratch, "the register sort keeps its column in shared memory");
  extern __shared__ uint16_t slab[];
  using S = std::conditional_t<kScratch, int64_t, int>;
  const int lane = lane_id();
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x - lane);
  if (warp0 >= p) return;  // the whole warp is past the last pixel
  const int64_t px = warp0 + lane;
  const bool live = px < p;
  const int nw = (f + 31) / 32;
  Column<S> x;
  uint32_t* masks;
  if constexpr (kScratch) {
    x = {scratch + px, p};
    masks = reinterpret_cast<uint32_t*>(scratch + (static_cast<int64_t>(f) * p + 1) / 2 * 2) +
            warp0 / 32 * 3 * nw;
  } else {
    const int stride = blockDim.x + 2;
    x = {slab + threadIdx.x, stride};
    masks = reinterpret_cast<uint32_t*>(slab + (f * stride + 1) / 2 * 2) +
            threadIdx.x / 32 * 3 * nw;
  }
  if constexpr (W > 0) {
    constexpr int H = W / 2;
    uint32_t v[H];
    load_sorted(v, vals, ld, px, f, live);
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (live && r < f) x[r] = static_cast<uint16_t>(v[r] & 0xffffu);
      if (live && r + H < f) x[r + H] = static_cast<uint16_t>(v[r] >> 16);
    }
  } else if (live) {
    // F * P reaches 1.7e9 at 100 x 4096^2: offsets are 64-bit.
    for (int i = 0; i < f; ++i) x[i] = vals[static_cast<int64_t>(i) * ld + px];
    sort_column(x, f);
  }
  Result res{0, 0, 0, 0};
  if (live) res = sigma_window<Acc>(x, f, siglow, sighigh);
  __syncwarp();
  // the warp settles its degenerate pixels one at a time
  for (unsigned deg = __ballot_sync(kFull, live && res.degen); deg != 0u; deg &= deg - 1u) {
    const int d = __ffs(deg) - 1;
    const Column<S> xd{x.p - lane + d, x.stride};
    const Result e =
        exact_masked<Acc>(xd, f, masks_at(masks, nw), siglow, sighigh, SigmaStats{});
    if (lane == d) res = e;
  }
  if (live) out.write(px, res);
}

// Shared memory of a block of `tile` threads: the columns at stride tile +
// 2, then 3 * ceil(F / 32) mask words a warp. The scratch of a launch over
// p pixels holds the (F, p) columns (rounded up to a whole word), then
// 3 * ceil(F / 32) words for each warp of p pixels.
Plan sigma_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (tile != 32 && tile != 64 && tile != 128) return {};
  const int t = static_cast<int>(tile);
  const int64_t warp_masks = 3 * ((f + 31) / 32) * 4;
  if (scratch) {
    return {f < kWideFrames ? sigma_kernel<0, true, int32_t> : sigma_kernel<0, true, int64_t>, t,
            t, 0, (f * p + 1) / 2 * 4 + (p + 31) / 32 * warp_masks};
  }
  const int64_t smem = (f * (tile + 2) + 1) / 2 * 4 + tile / 32 * warp_masks;
  const KernelFn k = f <= 32    ? sigma_kernel<32, false, int32_t>
                     : f <= 64  ? sigma_kernel<64, false, int32_t>
                     : f <= 128 ? sigma_kernel<128, false, int32_t>
                                : sigma_kernel<0, false, int32_t>;
  return {k, t, t, smem, 0, f <= 128 ? kWires : kShared};
}

}  // namespace

SIRILTPU_REJECT_ENTRY(sigma, sigma_plan, kThreadTiles)
