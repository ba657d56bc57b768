// Winsorized sigma clipping: per-pixel sort + winsorization fixed point +
// windowed outer sigma clip + survivor mean, with the exact re-run of
// degenerate pixels, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "winsorized"), both its full-height body (:611-795)
// and its strip body (:358-609, F > 896), reached through the pallas_call
// in _reject_stack_raw (:1079-1122), and the wrapper's fix-up of its
// degenerate pixels (:1143-1167). The TPU needs two bodies only because
// of its scoped-VMEM limit; here one entry takes every F, in the form its
// plan picks by F (below). Its plain
// PyTorch version is siriltpu_torch/ops/cuda/reject_stack.py:reject_plain
// ("winsorized": reject_winsorized_window, then the masked
// reject_winsorized on the degenerate pixels), which it matches bit for
// bit: mean, degenerate flag and both counters.
//
// Per pixel, on the sorted column x (stacking.c:1710-1748):
// - all arithmetic is centred on anchor = x[F/2] of the full column: a
//   value v is v - anchor in the f32 statistics;
// - each pass of the outer clip starts the fixed point (winsor_fixed_point,
//   reject_common.cuh) from the window [lo, hi) as it is, with the working
//   copy re-seeded from x; the working copy is clamp(x, A, B), two bounds
//   a pixel and no second slab;
// - the outer predicate is sigma's, med - v > siglow * sig, on the
//   unclamped x; rejl = lo and rejh = F - hi; the mean is the exact
//   integer mean of x over the window;
// - a pass whose scan would hit the reference's mid-scan break freezes the
//   window form, and the warp re-runs the pixel through exact_masked with
//   the same fixed point on the valid slots (for F <= 4, every pixel).
//
// What bounds it on an H100: a first design, one thread a pixel with two
// uint16 slabs of F * tile, left one warp per SM at F = 1000 (128 KB a
// block of 32 pixels) to run ~27k serial compare-exchanges and ~40 O(F)
// fixed-point steps a pixel with nothing to hide their latency: 176 ms at
// 1000 x 307200 against a 0.18 ms device-memory bound. The work is
// shared-memory and integer instructions, not bytes. A second, a warp a
// pixel sorting its column in shared memory (the shared form below), took
// 11.2 ms: ~20k warp instructions a pixel, ~70% of them the sort's
// shared-memory compare-exchanges, ~3.5k shared-memory wavefronts each.
// The wires form below takes 2.9 ms on the planetary sequence's aligned
// frames (the shared form 9.7): about 0.4 ms of staging, 0.4 of sorting
// and 2 of fixed-point steps and clip counts, ~5.4k warp instructions a
// pixel, issue-bound.
//
// The design here: a warp a pixel, for every F (a team of 32 lanes; at
// F < 32 most lanes idle, which no configuration's path does). A block of
// `tile` warps (8, 4, 2 or 1) owns `tile` neighbouring pixels and stages
// their columns in shared memory together: each frame row gives 2 * tile
// contiguous bytes. Then, by F:
// - F <= 2048, the wires form (winsorized_wires): each warp moves its
//   column into registers once, 2H wires a lane (2H = 4 .. 64, the least
//   that holds F; pads at 65535), and sorts it there (warp_sort in
//   reject_common.cuh: the lane's run by 16-bit SIMD min/max, 15 stages
//   across lanes by shuffles at 2H = 32), ~2k warp instructions a pixel at
//   F = 1000. It writes the sorted column back to its slot once, for the
//   median's and the anchor's single reads and the degenerate re-run.
//   Every fixed-point step clamps the packed registers and adds the exact
//   8-bit split sums by __dp4a (wire_sums), and each outer pass counts its
//   flags on the registers (wire_flags);
// - larger F, the shared form (winsorized_kernel): the warp sorts its
//   column in shared memory with the pruned bitonic network, 32
//   compare-exchanges at a time, and splits every fixed-point step and
//   the window mean across its lanes (slot lo + lane + 32k). Past 227 KB at
//   tile 1 (F > ~97k) the columns and masks go to a device-memory scratch,
//   one pixel's workspace after another.
// Either way the sums are exact integers, so a warp reduction gives the
// same sums in any order, and the one f32 combine, the 1.5 and 1.134
// products, the convergence test and round_shift are computed by every
// lane alike, in the JAX order (winsor_fixed_point).

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

// Ascending sort of the contiguous column col[0..f) by a warp: the pruned
// all-ascending bitonic network of sort_column, each stage's comparators
// split across the lanes.
__device__ __forceinline__ void team_sort(uint16_t* col, int f) {
  const int lane = lane_id();
  auto cmp_swap = [&](int i, int l) {
    const uint16_t a = col[i], b = col[l];
    col[i] = a < b ? a : b;
    col[l] = a < b ? b : a;
  };
  for (int lk = 1; (1 << (lk - 1)) < f; ++lk) {
    // flip stage of 2^lk: (base + t, base + k - 1 - t), t < k / 2
    const int k = 1 << lk, lh = lk - 1;
    const int pairs = ((f + k - 1) >> lk) << lh;
    for (int q = lane; q < pairs; q += 32) {
      const int base = (q >> lh) << lk, t = q & ((1 << lh) - 1);
      const int l = base + k - 1 - t;
      if (l < f) cmp_swap(base + t, l);
    }
    __syncwarp();
    // half-cleaners: (base + t, base + t + j), t < j
    for (int lj = lk - 2; lj >= 0; --lj) {
      const int j = 1 << lj;
      const int jpairs = ((f + 2 * j - 1) >> (lj + 1)) << lj;
      for (int q = lane; q < jpairs; q += 32) {
        const int base = (q >> lj) << (lj + 1), t = q & (j - 1);
        const int l = base + t + j;
        if (l < f) cmp_swap(base + t, l);
      }
      __syncwarp();
    }
  }
}

// The window form on the sorted column in memory, then the exact re-run
// if it froze.
template <typename Acc, class C>
__device__ __forceinline__ Result winsor_pixel(const C& x, int f, float siglow, float sighigh,
                                               Masks m) {
  const int32_t anchor = x[f / 2];
  Window win{0, f, 0, 0};
  for (int oit = 0; oit < kMaxIters; ++oit) {
    const int lo = win.lo, hi = win.hi;
    float med, sig;
    winsor_converge<Acc>(x, WindowSet{lo, hi}, hi - lo, anchor, med, sig);
    if (!win.step(sigma_flags(x, lo, hi, med, siglow * sig, sighigh * sig, anchor))) break;
  }
  if (win.degen) return exact_masked<Acc>(x, f, m, siglow, sighigh, WinsorStats{anchor});
  return {team_mean<Acc>(x, WindowSet{win.lo, win.hi}, win.hi - win.lo), 0, win.lo,
          f - win.hi};
}

// 32-bit words of one pixel's workspace: the column (F rounded up to
// even) and its 3 * ceil(F / 32) mask words.
__host__ __device__ __forceinline__ int64_t pixel_words(int64_t f) {
  return (f + 1) / 2 + 3 * ((f + 31) / 32);
}

template <bool kScratch, typename Acc>
__global__ void __launch_bounds__(256)
    winsorized_kernel(const uint16_t* __restrict__ vals, int64_t ld,
                      uint16_t* __restrict__ scratch, Outputs out, int f, int64_t p,
                      float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  const int tile = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t words = pixel_words(f);
  uint32_t* ws = reinterpret_cast<uint32_t*>(kScratch ? scratch : slab) +
                 (kScratch ? px0 * words : 0);
  const int npx = static_cast<int>(p - px0 < tile ? p - px0 : tile);
  stage_columns(vals, ld, ws, words, f, px0, npx, tile);
  __syncthreads();
  if (warp >= npx) return;
  uint32_t* mine = ws + warp * words;
  auto* col = reinterpret_cast<uint16_t*>(mine);
  team_sort(col, f);
  const Result r = winsor_pixel<Acc>(Column<int>{col, 1}, f, siglow, sighigh,
                                     masks_at(mine + (f + 1) / 2, (f + 31) / 32));
  if (lane_id() == 0) out.write(px0 + warp, r);
}

// ------------------------------------------------------------- wires form

// Largest F of the wires form: 64 wires a lane.
constexpr int kMaxWireFrames = 2048;

// 32-bit words of one pixel's workspace in the wires form: the sorted
// column with its pads (64H halfwords), then its 3 * ceil(F / 32) mask
// words, rounded up to 4 words so that every lane's run is 16-byte
// aligned.
__host__ __device__ __forceinline__ int64_t wire_words(int64_t f, int h) {
  return (32 * h + 3 * ((f + 31) / 32) + 3) / 4 * 4;
}

// The window form on the sorted wires v (the sorted column x in shared
// memory beside them, for single reads), then the exact re-run if it froze.
template <int H>
__device__ __forceinline__ Result winsor_wires(uint32_t (&v)[H], const Column<int>& x, int f,
                                               float siglow, float sighigh, Masks m) {
  const int32_t anchor = x[f / 2];
  Window win{0, f, 0, 0};
  for (int oit = 0; oit < kMaxIters; ++oit) {
    const int lo = win.lo, hi = win.hi, n = hi - lo;
    const int32_t x2 = x[lo + n / 2];
    // wires outside the window clamp to each step's anchor: they add 0
    narrow(v, lo, hi, x2);
    float med, sig;
    winsor_fixed_point(
        x[lo + (n - 1) / 2], x2, anchor,
        [&](int32_t A, int32_t B, int32_t a) { return wire_sums(v, A, B, a).sd(n); }, med,
        sig);
    if (!win.step(wire_flags(v, n, x2, med, siglow * sig, sighigh * sig, anchor))) break;
  }
  if (win.degen) return exact_masked<int32_t>(x, f, m, siglow, sighigh, WinsorStats{anchor});
  narrow(v, win.lo, win.hi, 0);
  return {round_mean<int32_t>(wire_total(v), win.hi - win.lo), 0, win.lo, f - win.hi};
}

// F <= 64H: the column sorted and walked in the warp's registers.
template <int H>
__global__ void __launch_bounds__(256)
    winsorized_wires(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__,
                     Outputs out, int f, int64_t p, float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  const int tile = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = lane_id();
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t words = wire_words(f, H);
  uint32_t* ws = reinterpret_cast<uint32_t*>(slab);
  const int npx = static_cast<int>(p - px0 < tile ? p - px0 : tile);
  stage_columns(vals, ld, ws, words, f, px0, npx, tile);
  __syncthreads();
  if (warp >= npx) return;
  uint32_t* mine = ws + warp * words;
  auto* col = reinterpret_cast<uint16_t*>(mine);
  // frame 32w + lane to wire w of the lane: 32 lanes read 64 contiguous
  // bytes, one wavefront a load
  auto load = [&](int w) -> uint32_t {
    const int i = 32 * w + lane;
    return i < f ? col[i] : 0xffffu;
  };
  uint32_t v[H];
#pragma unroll
  for (int r = 0; r < H; ++r) v[r] = load(r) | load(r + H) << 16;
  warp_sort(v);
  __syncwarp();
  store_run(v, mine + lane * H);
  __syncwarp();
  const Result r = winsor_wires(v, Column<int>{col, 1}, f, siglow, sighigh,
                                masks_at(mine + 32 * H, (f + 31) / 32));
  if (lane == 0) out.write(px0 + warp, r);
}

// Pixels a block, a warp each, largest first (0 ends).
constexpr int kWarpTiles[] = {8, 4, 2, 1, 0};

// tile pixels a block. F <= kMaxWireFrames: the wires form, 2H wires a
// lane, tile * wire_words(F, H) words of shared memory. Larger F: the shared
// form, tile * pixel_words(F) words of shared memory, or the scratch:
// pixel_words(F) words for each of the launch's p pixels.
Plan winsorized_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (tile != 1 && tile != 2 && tile != 4 && tile != 8) return {};
  const int t = static_cast<int>(tile);
  if (scratch) {
    return {f < kWideFrames ? winsorized_kernel<true, int32_t> : winsorized_kernel<true, int64_t>,
            32 * t, t, 0, p * pixel_words(f) * 4};
  }
  if (f <= kMaxWireFrames) {
    const int h = f <= 128 ? 2 : f <= 256 ? 4 : f <= 512 ? 8 : f <= 1024 ? 16 : 32;
    const KernelFn k = h == 2    ? winsorized_wires<2>
                       : h == 4  ? winsorized_wires<4>
                       : h == 8  ? winsorized_wires<8>
                       : h == 16 ? winsorized_wires<16>
                                 : winsorized_wires<32>;
    return {k, 32 * t, t, tile * wire_words(f, h) * 4, 0, kWires};
  }
  return {winsorized_kernel<false, int32_t>, 32 * t, t, tile * pixel_words(f) * 4, 0};
}

}  // namespace

SIRILTPU_REJECT_ENTRY(winsorized, winsorized_plan, kWarpTiles)
