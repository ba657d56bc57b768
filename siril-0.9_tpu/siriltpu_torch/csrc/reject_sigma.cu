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
// of O(F) each (1.04 a pixel on the deep-sky cell's frames), which is
// instruction issue: the sort of 128 wires is ~1.8k 16-bit min/max a
// pixel. A first design sorted in shared memory, four shared-memory
// accesses a compare-exchange: 18.6 ms. The one before this, a thread a
// pixel with its column sorted in 64 registers and clipped on a copy in
// shared memory, took 166 registers, so 12 warps an SM: too few to cover
// its 100 scattered row loads and its shared-memory passes, 7.66 ms at
// 100 x 4096^2 (the cell's frames), a quarter of its issue rate.
//
// The design here, up to F = 128 (the team form, sigma_team): a team of T
// lanes a pixel, T = 1 up to F = 64 and 2 past it (team_lanes: the least
// of T = 1, 2, 4, 8, 16, 32 timed on the card at F = 50 and 100), each
// lane holding 2H <= 64 wires in H registers, two uint16 wires a register.
// - the block (128 pixels) stages its columns into shared memory with
//   16-byte row loads, two rows a 32-bit store (stage_columns, shared with
//   winsorized; 2-byte loads where a row is not aligned), pads them to 2HT
//   with 65535, and each lane reads its run by 16-byte loads;
// - the team sorts its wires in registers: each lane's run by the bitonic
//   network (BitonicStage), then across the team by shuffles (warp_sort);
// - every pass reads the median and the anchor x[lo + n/2] from the lane
//   that holds them (team_at), adds the exact 8-bit split sums over every
//   wire by __dp4a (wire_sums) and takes off the known share of the wires
//   outside the window: the window holds just the values in [A, B], those
//   below it clamp to A and those above (the pads too) to B. Its flags are
//   counted only where the window's ends show some (wire_counts: the wires
//   at most the low bound and at least the high bound, integers found from
//   the float predicates of sigma_flags). Nothing is written to shared
//   memory on this path;
// - a warp's teams run their passes together (__any_sync) until the last
//   is done; a pixel whose last pass removed nothing has its mean from
//   that pass's sums.
// At 100 x 4096^2 on the cell's frames: 78 registers, 24 warps an SM,
// 4.44 ms (1.07 ms of bytes: 24%), ~150 warp instructions a pixel (sort
// ~86, staging ~10, the pass ~45), about half the issue rate of 24 warps.
// Larger F: a thread a pixel, the pruned network on its column in shared
// memory; past 227 KB at tile 32, on a device-memory scratch laid out
// (F, P). Those columns sit at stride tile + 2 (an odd number of words),
// so a thread's own column and a warp reading one column across its lanes
// both touch 32 different banks.
//
// Every form keeps the reference's arithmetic: the median and the sd
// anchor are x[(n-1)/2] and x[n/2] of the window (the anchor the upper
// middle value, as _gsl_sd and SigmaStats take it: at even n the float32
// combine of a lower anchor rounds some sds apart), the sd is SdSums::sd
// of exact integer sums, siglow * sigma is a float product. A pixel whose
// scan would hit the reference's mid-scan break is frozen and flagged
// degenerate (Window::step); then the warp settles each of its degenerate
// pixels in turn with exact_masked (reject_common.cuh), all 32 lanes on
// that pixel's sorted column in shared memory (in the team form only a
// warp with such a pixel writes its columns there). For F <= 4 that is
// every pixel: correct, only slower.

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

// F > 128: a thread a pixel, its column sorted in shared memory or in the
// scratch.
template <bool kScratch, typename Acc>
__global__ void __launch_bounds__(kThreads, min_blocks(0))
    sigma_kernel(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__ scratch,
                 Outputs out, int f, int64_t p, float siglow, float sighigh) {
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
  if (live) {
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

// ------------------------------------------------------------- team form

// Largest F of the team form, and its pixels a block.
constexpr int kMaxTeamFrames = 128;
constexpr int kTeamPixels = 128;

// Lanes a pixel (T) at F <= kMaxTeamFrames, from F alone: one lane (the
// column in one thread's registers) up to 64 frames, two past it, so that
// a lane never holds more than 64 wires.
constexpr int team_lanes(int64_t f) { return f <= 64 ? 1 : 2; }

// Registers a lane (H): the least power of two, 2 at least, whose 2HT
// wires hold F.
constexpr int team_regs(int64_t f, int t) {
  int h = 2;
  while (2 * h * t < f) h *= 2;
  return h;
}

// 32-bit words of one pixel's slot: its column with the pads (2HT
// halfwords), then its 3 * ceil(F / 32) mask words; an odd multiple of 4,
// so that every lane's run starts on 16 bytes and the 16-byte reads of
// neighbouring pixels' slots touch different banks.
__host__ __device__ constexpr int64_t team_words(int64_t f, int t, int h) {
  return ((t * h + 3 * ((f + 31) / 32) + 3) / 4 | 1) * 4;
}

// The integer bounds of a pass's flags. low_bound: the largest v in
// [-1, 65535] with med - v > thr (sigma_flags' low predicate), -1 if none;
// high_bound: the least v in [0, 65536] with v - med > thr (its high
// predicate), 65536 if none. med - v is exact in float, so each predicate
// holds on a prefix (a suffix) of the integers; the float floor (ceil) of
// med -+ thr is within one of the bound, and one test on each side
// settles it.
__device__ __forceinline__ int32_t low_bound(float med, float thr) {
  auto low = [&](int32_t v) { return med - static_cast<float>(v) > thr; };
  int32_t v = static_cast<int32_t>(fminf(fmaxf(floorf(med - thr), -1.0f), 65535.0f));
  if (v >= 0 && !low(v)) {
    --v;
  } else if (v < 65535 && low(v + 1)) {
    ++v;
  }
  return v;
}

__device__ __forceinline__ int32_t high_bound(float med, float thr) {
  auto high = [&](int32_t v) { return static_cast<float>(v) - med > thr; };
  int32_t v = static_cast<int32_t>(fminf(fmaxf(ceilf(med + thr), 0.0f), 65536.0f));
  if (v <= 65535 && !high(v)) {
    ++v;
  } else if (v > 0 && high(v - 1)) {
    --v;
  }
  return v;
}

// F <= 2HT: a team of T lanes a pixel, kTeamPixels pixels a block.
// The block stages its columns in shared memory (stage_columns) and pads
// each to 2HT frames with 65535; each lane reads its run of 2H frames
// into H registers and the team sorts the 2HT wires (warp_sort). The wires
// then stay as they are. The window [lo, hi) holds just the values in
// [A, B]: the wires below it are at most A, those above it (the pads too)
// at least B. Every pass reads its median and anchor from the lanes that
// hold them (team_at), adds the exact split sums over every wire clamped
// to [A, B] (wire_sums) and takes off the known share of the wires outside
// the window. Its flags are the values at most the low bound and at least
// the high bound; where the window's ends show some, the team counts the
// wires past each bound (wire_counts), and the flags are what of that
// prefix and that suffix lies inside the window. A warp's teams run their
// passes together until the last of them is done. A pixel whose last pass
// removed nothing has its sum from that pass. Only a warp with a
// degenerate pixel writes its sorted columns to their slots, and settles
// each such pixel with exact_masked.
template <int T, int H>
__global__ void __launch_bounds__(kTeamPixels * T)
    sigma_team(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__,
               Outputs out, int f, int64_t p, float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  constexpr int kTeamWires = 2 * H * T;
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * kTeamPixels;
  const int64_t words = team_words(f, T, H);
  uint32_t* ws = reinterpret_cast<uint32_t*>(slab);
  const int npx = static_cast<int>(p - px0 < kTeamPixels ? p - px0 : kTeamPixels);
  stage_columns(vals, ld, ws, words, f, px0, npx, kTeamPixels);
  // thread t pads pixel t % kTeamPixels, every T-th frame from F on
  const int k = threadIdx.x % kTeamPixels;
  for (int i = f + static_cast<int>(threadIdx.x) / kTeamPixels; i < kTeamWires; i += T)
    slab[2 * slot_word(k, words) + i] = 0xffffu;
  __syncthreads();
  const int team = threadIdx.x / T, lane = threadIdx.x & (T - 1);
  const bool live = team < npx;
  uint32_t* mine = ws + slot_word(team, words);
  uint32_t v[H];
  load_run(v, mine + lane * H);
  warp_sort<T>(v);
  Window win{0, f, 0, 0};
  int32_t A = 0, B = 65535, sum = 0;
  bool active = live, summed = false;
  for (int it = 0; it < kMaxIters && __any_sync(kFull, active); ++it) {
    const int lo = win.lo, hi = win.hi, n = hi - lo;
    const int32_t v1 = team_at<T>(v, lo + (n - 1) / 2);
    const int32_t v2 = team_at<T>(v, lo + n / 2);
    const float median = median_of(v1, v2);
    // until a warp's window shrinks, no wire needs its clamp
    SdSums<int32_t> sums = __any_sync(kFull, A != 0 || B != 65535)
                               ? wire_sums<T>(v, A, B, v2)
                               : wire_sums<T, false>(v, 0, 65535, v2);
    sums.add(A - v2, -lo);
    sums.add(B - v2, hi - kTeamWires);
    const float sigma = sums.sd(n);
    const int32_t L = low_bound(median, siglow * sigma);
    const int32_t U = high_bound(median, sighigh * sigma);
    // the window's ends, read by every lane
    const int32_t first = team_at<T>(v, lo), last = team_at<T>(v, hi - 1);
    Flags fl{0, 0};
    if (__any_sync(kFull, active && (first <= L || last >= U))) {
      const Flags all = wire_counts<T>(v, L, U);
      fl = {clamp_i(all.low - lo, 0, n), clamp_i(all.high - (kTeamWires - hi), 0, n)};
    }
    if (active) {
      active = win.step(fl);
      if (!win.degen) {
        if (fl.low != 0) A = L + 1;
        if (fl.high != 0) B = U - 1;
      }
      summed = !active && fl.low + fl.high == 0;
      sum = sums.s1 + n * v2;
    }
  }
  if (__any_sync(kFull, live && !summed)) {
    const int32_t all = wire_total<T>(v, A, B);
    if (!summed) sum = all - win.lo * A - (kTeamWires - win.hi) * B;
  }
  Result res{round_mean<int32_t>(sum, win.hi - win.lo), win.degen, win.lo, f - win.hi};
  // the warp settles its degenerate pixels one at a time, on their sorted
  // columns written back to their slots
  const unsigned deg = __ballot_sync(kFull, live && win.degen && lane == 0);
  if (deg != 0u) {
    load_run(v, mine + lane * H);
    warp_sort<T>(v);
    __syncwarp();
    store_run(v, mine + lane * H);
    __syncwarp();
    for (unsigned d = deg; d != 0u; d &= d - 1u) {
      const int owner = (threadIdx.x & ~31u) / T + (__ffs(d) - 1) / T;
      uint32_t* slot = ws + slot_word(owner, words);
      const Result e =
          exact_masked<int32_t>(Column<int>{reinterpret_cast<uint16_t*>(slot), 1}, f,
                                masks_at(slot + T * H, (f + 31) / 32), siglow, sighigh,
                                SigmaStats{});
      if (team == owner) res = e;
    }
  }
  if (live && lane == 0) out.write(px0 + team, res);
}

// The team form's entry for F frames.
KernelFn team_kernel(int64_t f) {
  switch (team_lanes(f) * 100 + team_regs(f, team_lanes(f))) {
    case 102:
      return sigma_team<1, 2>;
    case 104:
      return sigma_team<1, 4>;
    case 108:
      return sigma_team<1, 8>;
    case 116:
      return sigma_team<1, 16>;
    case 132:
      return sigma_team<1, 32>;
    default:
      return sigma_team<2, 32>;
  }
}

// F <= 128: the team form, kTeamPixels pixels a block of kTeamPixels * T
// threads (no other tile), slot_word(tile, team_words(F, T, H)) words of
// shared memory. Larger F, a thread a
// pixel, tile 32, 64 or 128: the columns at stride tile + 2, then 3 *
// ceil(F / 32) mask words a warp, in shared memory; or the scratch of a
// launch over p pixels: the (F, p) columns (rounded up to a whole word),
// then 3 * ceil(F / 32) words for each warp of p pixels.
Plan sigma_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (!scratch && f <= kMaxTeamFrames) {
    const int t = team_lanes(f);
    if (tile != kTeamPixels) return {};
    return {team_kernel(f), kTeamPixels * t, kTeamPixels,
            slot_word(kTeamPixels, team_words(f, t, team_regs(f, t))) * 4, 0, kTeam};
  }
  if (tile != 32 && tile != 64 && tile != 128) return {};
  const int t = static_cast<int>(tile);
  const int64_t warp_masks = 3 * ((f + 31) / 32) * 4;
  if (scratch) {
    return {f < kWideFrames ? sigma_kernel<true, int32_t> : sigma_kernel<true, int64_t>, t, t, 0,
            (f * p + 1) / 2 * 4 + (p + 31) / 32 * warp_masks};
  }
  const int64_t smem = (f * (tile + 2) + 1) / 2 * 4 + tile / 32 * warp_masks;
  return {sigma_kernel<false, int32_t>, t, t, smem, 0, kShared};
}

}  // namespace

SIRILTPU_REJECT_ENTRY(sigma, sigma_plan, kThreadTiles)
