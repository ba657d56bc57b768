// Fused per-pixel sort + windowed sigma clip + survivor mean, for Hopper.
//
// Replaces siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:
// _make_kernel(..., "sigma") (the sigma body, :797-856) together with the
// pallas_call in _reject_stack_raw (:1079-1122). Its plain PyTorch version
// is siriltpu_torch/ops/rejection.py:reject_sigma_window, which it matches
// bit for bit: mean, degenerate flag, and the low/high rejection counts.
//
// What bounds it on an H100: the kernel reads F*P*2 bytes once (3.36 GB
// for 100 x 4096^2, about 1 ms at 3.35 TB/s) and writes 14 bytes a pixel.
// Against that, every pixel sorts its F values (~F log^2 F compare-
// exchanges, 1334 for F = 100) and runs a few clip passes of O(F) each,
// all on shared memory. The sort is the larger cost, so the kernel is
// bound by shared-memory instruction throughput, not by device memory.
//
// What the design does about it: the F values of a pixel are read from
// device memory exactly once, into shared memory, and never written back.
// One thread owns one pixel column; a block holds TP consecutive pixels
// (128, or 64 or 32 for large F), so each frame row is read by coalesced
// 2-byte loads of neighbouring pixels. The column is stored with stride TP
// so that the threads of a warp touch neighbouring words (no bank
// conflicts). Each thread sorts its column with a bitonic network in the
// all-ascending form, pruned to the F real wires: pad wires would hold the
// maximum value, so every comparator that touches one is a no-op and is
// skipped, and no pad rows are stored. The network has a data-independent
// control flow, so a warp never diverges while sorting. The clip loop
// then reads the median and the sd anchor by index, and counts the low
// and high flags by scanning in from both ends of the window, which is
// exact because the window is sorted and both predicates are monotone.
// No thread reads another thread's column, so the kernel needs no barrier.
//
// Bit-exactness rules (each changes clip decisions if broken):
// - siglow / sighigh are float, and siglow * sigma is a float product;
// - the sd is three exact integer sums of an 8-bit split, centred on
//   x[lo + (n-1)/2], combined in float in the order of the JAX code;
//   the library is built without fast math and with -fmad=false, so
//   division and sqrt are IEEE and no product is fused into an add;
// - the median is 0.5f * ((float)v1 + (float)v2);
// - the mean is the exact integer (2s + n) / (2n), clipped to [0, 65535];
// - the pass cap is rejection.py's MAX_ITERS = 512 (the Pallas kernel
//   stops at 50, a quirk of the TPU path).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIters = 512;
// Shared memory one block may use on sm_90 (227 KB).
constexpr int64_t kMaxSmemBytes = 232448;

__device__ __forceinline__ void cmp_swap(uint16_t* col, int tp, int i, int l) {
  const uint16_t a = col[i * tp];
  const uint16_t b = col[l * tp];
  col[i * tp] = a < b ? a : b;
  col[l * tp] = a < b ? b : a;
}

// Ascending sort of col[0], col[tp], ..., col[(f-1)*tp]: the bitonic
// network of the next power of two in its all-ascending form (a flip
// stage, then half-cleaners), keeping only comparators with both wires < f.
__device__ void sort_column(uint16_t* col, int tp, int f) {
  for (int k = 2; k < 2 * f; k <<= 1) {
    for (int base = 0; base < f; base += k) {
      for (int t = 0; t < k / 2; ++t) {
        const int l = base + k - 1 - t;
        if (l < f) cmp_swap(col, tp, base + t, l);
      }
    }
    for (int j = k / 4; j > 0; j >>= 1) {
      for (int base = 0; base < f; base += 2 * j) {
        for (int t = 0; t < j; ++t) {
          const int l = base + t + j;
          if (l < f) cmp_swap(col, tp, base + t, l);
        }
      }
    }
  }
}

__global__ void reject_sigma_kernel(const uint16_t* __restrict__ vals,
                                    uint16_t* __restrict__ mean,
                                    int32_t* __restrict__ degen,
                                    int32_t* __restrict__ rejl,
                                    int32_t* __restrict__ rejh, int f,
                                    int64_t p_total, float siglow,
                                    float sighigh) {
  extern __shared__ uint16_t slab[];
  const int tp = blockDim.x;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * tp + threadIdx.x;
  if (p >= p_total) return;
  uint16_t* col = slab + threadIdx.x;

  // F * P reaches 1.7e9 at 100 x 4096^2: offsets are 64-bit.
  for (int i = 0; i < f; ++i) col[i * tp] = vals[static_cast<int64_t>(i) * p_total + p];
  sort_column(col, tp, f);

  int lo = 0, hi = f, r = 0, is_degen = 0;
  for (int it = 0; it < kMaxIters; ++it) {
    const int n = hi - lo;
    const int32_t v1 = col[(lo + (n - 1) / 2) * tp];
    const int32_t v2 = col[(lo + n / 2) * tp];
    const float median = 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
    // Exact sums of the deviations from v1 and of their squares, split
    // into 8-bit halves. F <= 3632 (the shared-memory bound) keeps every
    // sum below 2^31.
    int32_t s1 = 0, shh = 0, shl = 0, sll = 0;
    for (int i = lo; i < hi; ++i) {
      const int32_t d = static_cast<int32_t>(col[i * tp]) - v1;
      const int32_t ad = d < 0 ? -d : d;
      const int32_t h8 = ad >> 8, l8 = ad & 255;
      s1 += d;
      shh += h8 * h8;
      shl += h8 * l8;
      sll += l8 * l8;
    }
    const float nf = static_cast<float>(n);
    const float s2 = static_cast<float>(shh) * 65536.0f + static_cast<float>(shl) * 512.0f +
                     static_cast<float>(sll);
    const float s1f = static_cast<float>(s1);
    const float var = (s2 - s1f * s1f / fmaxf(nf, 1.0f)) / fmaxf(nf - 1.0f, 1.0f);
    const float sigma = n > 1 ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
    const float thr_low = siglow * sigma;
    const float thr_high = sighigh * sigma;

    int nlow = 0;
    while (lo + nlow < hi && median - static_cast<float>(col[(lo + nlow) * tp]) > thr_low) ++nlow;
    int nhigh = 0;
    while (hi - 1 - nhigh >= lo && static_cast<float>(col[(hi - 1 - nhigh) * tp]) - median > thr_high)
      ++nhigh;

    const int removed = nlow + nhigh;
    // The reference scan breaks mid-pass once n - (r + c) <= 4; such a
    // pixel is frozen and flagged for the exact masked re-run.
    if (n - r - removed <= 4) {
      is_degen = 1;
      break;
    }
    lo += nlow;
    hi -= nhigh;
    r += removed;
    if (removed == 0 || hi - lo <= 3) break;
  }

  const int n = hi - lo;
  int32_t s = 0;
  for (int i = lo; i < hi; ++i) s += col[i * tp];
  int32_t m = n > 0 ? (2 * s + n) / (2 * n) : 0;
  m = m < 0 ? 0 : (m > 65535 ? 65535 : m);
  mean[p] = static_cast<uint16_t>(m);
  degen[p] = is_degen;
  rejl[p] = lo;
  rejh[p] = f - hi;
}

}  // namespace

extern "C" {

// Sigma-clip stack of (F, P) row-major uint16 `vals` on `stream`: writes
// mean (P,) uint16 and degen, rejl, rejh (P,) int32. `tile` pixels per
// block: 32, 64 or 128, with F * tile * 2 bytes of shared memory at most
// 227 KB. Returns a cudaError_t; the launch is asynchronous.
int reject_sigma_u16(const void* vals, void* mean, void* degen, void* rejl, void* rejh,
                     int64_t f, int64_t p, int64_t tile, float siglow, float sighigh,
                     void* stream) {
  if (f < 1 || p < 1 || (tile != 32 && tile != 64 && tile != 128)) return cudaErrorInvalidValue;
  const int64_t smem = f * tile * 2;
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int64_t blocks = (p + tile - 1) / tile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reject_sigma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  reject_sigma_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(tile),
                        static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(vals), static_cast<uint16_t*>(mean),
      static_cast<int32_t*>(degen), static_cast<int32_t*>(rejl), static_cast<int32_t*>(rejh),
      static_cast<int>(f), p, siglow, sighigh);
  return cudaGetLastError();
}

}  // extern "C"
