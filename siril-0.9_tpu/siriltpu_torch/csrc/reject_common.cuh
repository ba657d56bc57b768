// What the five rejection-stack kernels share: the column view, the
// per-column sort, the exact sd and mean, the sigma flag scan, the window
// step of the windowed clips, and the launch.
//
// Each kernel replaces one static branch of
// siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:_make_kernel, reached
// through the pallas_call in _reject_stack_raw (:1079-1122). The input is
// (F, P) uint16, F frames by P pixels, and every kernel writes (P,)
// outputs: a uint16 mean, an int32 degenerate flag and int32 low and high
// rejection counts.
//
// One thread owns one pixel column. It copies the column's F values from
// device memory once, sorts them, and runs its rejection on the sorted
// column; neighbouring threads own neighbouring pixels, so every frame row
// is read by coalesced 2-byte loads. Where the column lives:
// - shared memory, at stride `tile` (the block's thread count), so the
//   threads of a warp touch neighbouring words (no bank conflicts). A
//   block of `tile` pixels holds kSlabs * F * tile * 2 bytes;
// - a device-memory scratch laid out (F, P), when even the smallest tile
//   does not fit in the 227 KB of shared memory a block may use. The same
//   code then runs at stride P, so a warp still touches neighbouring
//   pixels. No F is refused.
//
// Bit-exactness rules (each changes clip decisions if broken):
// - the sd is three exact integer sums of an 8-bit split of deviations
//   from an anchor element, combined in float in the order of the JAX
//   code; the library is built without fast math and with -fmad=false,
//   so division and sqrt are IEEE and no product is fused into an add;
// - sums are int32 while 2 * F * 65535 + F < 2^31 (F < 16384) and int64
//   past that;
// - the median is 0.5f * ((float)v1 + (float)v2);
// - the mean is the exact integer (2s + n) / (2n), clipped to [0, 65535];
// - the pass cap is rejection.py's MAX_ITERS = 512 (the Pallas kernel
//   stops at 50, a quirk of the TPU path).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace siriltpu {

constexpr int kMaxIters = 512;
// Shared memory one block may use on sm_90 (227 KB).
constexpr int64_t kMaxSmemBytes = 232448;
// Frame counts from here on sum in int64.
constexpr int64_t kWideFrames = 16384;

// One pixel's column: element i at p[i * stride]. S is int for a column in
// shared memory and int64_t for one in the device-memory scratch.
template <typename S>
struct Column {
  uint16_t* p;
  S stride;
  __device__ __forceinline__ uint16_t& operator[](int i) const {
    return p[static_cast<S>(i) * stride];
  }
};

template <class C>
__device__ __forceinline__ void cmp_swap(const C& col, int i, int l) {
  const uint16_t a = col[i];
  const uint16_t b = col[l];
  col[i] = a < b ? a : b;
  col[l] = a < b ? b : a;
}

// Ascending sort of col[0..f): the bitonic network of the next power of
// two in its all-ascending form (a flip stage, then half-cleaners),
// keeping only comparators with both wires < f. A pad wire would hold the
// maximum value, so every comparator that touches one is a no-op. The
// control flow is data-independent: a warp never diverges while sorting.
template <class C>
__device__ void sort_column(const C& col, int f) {
  for (int k = 2; k < 2 * f; k <<= 1) {
    for (int base = 0; base < f; base += k) {
      for (int t = 0; t < k / 2; ++t) {
        const int l = base + k - 1 - t;
        if (l < f) cmp_swap(col, base + t, l);
      }
    }
    for (int j = k / 4; j > 0; j >>= 1) {
      for (int base = 0; base < f; base += 2 * j) {
        for (int t = 0; t < j; ++t) {
          const int l = base + t + j;
          if (l < f) cmp_swap(col, base + t, l);
        }
      }
    }
  }
}

// Exact sums of the deviations d from an anchor and of their squares,
// split into 8-bit halves (|d| <= 65535).
template <typename Acc>
struct SdSums {
  Acc s1 = 0, shh = 0, shl = 0, sll = 0;
  __device__ __forceinline__ void add(int32_t d) {
    const int32_t ad = d < 0 ? -d : d;
    const int32_t h8 = ad >> 8, l8 = ad & 255;
    s1 += d;
    shh += h8 * h8;
    shl += h8 * l8;
    sll += l8 * l8;
  }
  // gsl_stats sample sd of the n values: the one float combine.
  __device__ __forceinline__ float sd(int n) const {
    const float nf = static_cast<float>(n);
    const float s2 = static_cast<float>(shh) * 65536.0f + static_cast<float>(shl) * 512.0f +
                     static_cast<float>(sll);
    const float s1f = static_cast<float>(s1);
    const float var = (s2 - s1f * s1f / fmaxf(nf, 1.0f)) / fmaxf(nf - 1.0f, 1.0f);
    return n > 1 ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
  }
};

__device__ __forceinline__ float median_of(int32_t v1, int32_t v2) {
  return 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
}

// round_to_WORD of the exact mean of col[lo..hi).
template <typename Acc, class C>
__device__ __forceinline__ int32_t window_mean(const C& col, int lo, int hi) {
  const Acc n = hi - lo;
  Acc s = 0;
  for (int i = lo; i < hi; ++i) s += col[i];
  Acc m = n > 0 ? (2 * s + n) / (2 * n) : 0;
  m = m < 0 ? 0 : (m > 65535 ? 65535 : m);
  return static_cast<int32_t>(m);
}

// The low and high flag counts of sigma clipping on the sorted window
// col[lo..hi), in a domain shifted by `shift`: values v with
// med - (v - shift) > thr_low, and with (v - shift) - med > thr_high. Both
// predicates are monotone in v, so the flags are a prefix and a suffix of
// the window, counted by scans in from both ends.
struct Flags {
  int low, high;
};

template <class C>
__device__ __forceinline__ Flags sigma_flags(const C& col, int lo, int hi, float med,
                                             float thr_low, float thr_high, int32_t shift) {
  Flags fl{0, 0};
  while (lo + fl.low < hi &&
         med - static_cast<float>(static_cast<int32_t>(col[lo + fl.low]) - shift) > thr_low)
    ++fl.low;
  while (hi - 1 - fl.high >= lo &&
         static_cast<float>(static_cast<int32_t>(col[hi - 1 - fl.high]) - shift) - med > thr_high)
    ++fl.high;
  return fl;
}

// The surviving window [lo, hi) of a windowed clip, the values removed so
// far, and the degenerate flag.
struct Window {
  int lo, hi, r, degen;

  // Apply one pass's flags; false once the pixel is done. A pass whose
  // scan would hit the reference's mid-scan break (N - r <= 4,
  // stacking.c:1684-1688) freezes the pixel and flags it degenerate: its
  // stale-buffer removals are not window-shaped, so the wrapper re-runs
  // it exactly.
  __device__ __forceinline__ bool step(Flags fl) {
    const int removed = fl.low + fl.high;
    if (hi - lo - r - removed <= 4) {
      degen = 1;
      return false;
    }
    lo += fl.low;
    hi -= fl.high;
    r += removed;
    return removed != 0 && hi - lo > 3;
  }
};

struct Result {
  int32_t mean, degen, rejl, rejh;
};

struct Outputs {
  uint16_t* mean;
  int32_t* degen;
  int32_t* rejl;
  int32_t* rejh;
};

// Body::run<Acc>(x, w, f, siglow, sighigh) -> Result, on the sorted column
// x; w is the second slab (Body::kSlabs == 2) or x again.
template <class Body, bool kScratch, typename Acc>
__global__ void reject_kernel(const uint16_t* __restrict__ vals, int64_t ld,
                              uint16_t* __restrict__ scratch, Outputs out, int f, int64_t p,
                              float siglow, float sighigh) {
  extern __shared__ uint16_t slab[];
  using S = std::conditional_t<kScratch, int64_t, int>;
  const int64_t px = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (px >= p) return;
  Column<S> x, w;
  if constexpr (kScratch) {
    x = {scratch + px, p};
    w = {scratch + (Body::kSlabs - 1) * static_cast<int64_t>(f) * p + px, p};
  } else {
    const int tp = blockDim.x;
    x = {slab + threadIdx.x, tp};
    w = {slab + (Body::kSlabs - 1) * f * tp + threadIdx.x, tp};
  }
  // F * P reaches 1.7e9 at 100 x 4096^2: offsets are 64-bit.
  for (int i = 0; i < f; ++i) x[i] = vals[static_cast<int64_t>(i) * ld + px];
  sort_column(x, f);
  const Result r = Body::template run<Acc>(x, w, f, siglow, sighigh);
  out.mean[px] = static_cast<uint16_t>(r.mean);
  out.degen[px] = r.degen;
  out.rejl[px] = r.rejl;
  out.rejh[px] = r.rejh;
}

// Launch Body over p pixels on `stream`. vals is (F, p) with row stride ld
// (elements); the outputs are (p,). With scratch == nullptr the columns
// live in shared memory, `tile` pixels a block, kSlabs * F * tile * 2
// bytes at most 227 KB; otherwise in `scratch`, kSlabs * F * p uint16.
// Returns a cudaError_t; the launch is asynchronous.
template <class Body>
int launch(const void* vals, int64_t ld, void* scratch, void* mean, void* degen, void* rejl,
           void* rejh, int64_t f, int64_t p, int64_t tile, float siglow, float sighigh,
           void* stream) {
  if (f < 1 || f > 0x7fffffff || p < 1 || ld < p) return cudaErrorInvalidValue;
  if (tile != 32 && tile != 64 && tile != 128) return cudaErrorInvalidValue;
  const int64_t blocks = (p + tile - 1) / tile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const Outputs out{static_cast<uint16_t*>(mean), static_cast<int32_t*>(degen),
                    static_cast<int32_t*>(rejl), static_cast<int32_t*>(rejh)};
  const auto* v = static_cast<const uint16_t*>(vals);
  auto* s = static_cast<uint16_t*>(scratch);
  const dim3 grid(static_cast<unsigned>(blocks)), block(static_cast<unsigned>(tile));
  const auto st = static_cast<cudaStream_t>(stream);
  const int fi = static_cast<int>(f);
  if (scratch == nullptr) {
    const int64_t smem = Body::kSlabs * f * tile * 2;
    if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
    auto* kernel = reject_kernel<Body, false, int32_t>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, static_cast<size_t>(smem), st>>>(v, ld, s, out, fi, p, siglow,
                                                           sighigh);
  } else if (f < kWideFrames) {
    reject_kernel<Body, true, int32_t><<<grid, block, 0, st>>>(v, ld, s, out, fi, p, siglow,
                                                               sighigh);
  } else {
    reject_kernel<Body, true, int64_t><<<grid, block, 0, st>>>(v, ld, s, out, fi, p, siglow,
                                                               sighigh);
  }
  return cudaGetLastError();
}

}  // namespace siriltpu

// The C entry of one kernel: reject_<name>_u16, see launch() above.
#define SIRILTPU_REJECT_ENTRY(name, Body)                                                     \
  extern "C" int reject_##name##_u16(const void* vals, int64_t ld, void* scratch, void* mean, \
                                     void* degen, void* rejl, void* rejh, int64_t f,          \
                                     int64_t p, int64_t tile, float siglow, float sighigh,    \
                                     void* stream) {                                          \
    return siriltpu::launch<Body>(vals, ld, scratch, mean, degen, rejl, rejh, f, p, tile,    \
                                  siglow, sighigh, stream);                                   \
  }
