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
// What bounds it on an H100: the kernel must read F*P*2 bytes once (0.42
// GB at config 2's 50 x 2048^2, 0.14 ms at 3.35 TB/s); the sort is the
// work. A first design sorted in shared memory with a pruned bitonic
// network, two loads and two stores a compare-exchange (~2,000
// shared-memory instructions a pixel at F = 50): bound by shared-memory
// instructions, 1.8 ms.
//
// The design here, one thread a pixel:
// - F <= 128 (median_kernel): the column in W = 32, 64 or 128 wires in
//   registers, two a register, as sigma holds it (reject_common.cuh). A
//   median needs two order statistics, not the sorted column, so the W - F
//   spare wires are padded half with 0 and half with 65535 (the low half
//   rounded down): for every F the two middle order statistics of the
//   column are then order statistics W/2 - 1 and W/2 of the wires (for odd
//   F both are W/2 - 1). The bitonic network runs up to the two sorted
//   halves; of its last merge only the first stage is needed, which splits
//   the wires into the W/2 smallest and the W/2 largest: the maximum of the
//   one and the minimum of the other are the two statistics. No run-time
//   index into the registers and no shared memory, so the registers alone
//   set the occupancy;
// - larger F, or the scratch: the first design (thread_plan).

#include "reject_common.cuh"

namespace {

using namespace siriltpu;

__device__ __forceinline__ Result median_result(int32_t v1, int32_t v2) {
  const float med = median_of(v1, v2);
  return {static_cast<int32_t>(fminf(fmaxf(med, 0.0f), 65535.0f)), 0, 0, 0};
}

// On a sorted column in memory.
struct MedianBody {
  template <typename Acc, class C>
  static __device__ Result run(const C& x, int f, float, float) {
    return median_result(x.at((f - 1) / 2), x.at(f / 2));
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads, min_blocks(W))
    median_kernel(const uint16_t* __restrict__ vals, int64_t ld, uint16_t* __restrict__,
                  Outputs out, int f, int64_t p, float, float) {
  constexpr int H = W / 2;
  const int64_t px = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (px >= p) return;
  const int zeros = f + (W - f) / 2;  // wires [f, zeros) pad at 0, the rest at 65535
  auto load = [&](int i) -> uint32_t {
    return i < f ? vals[i * ld + px] : (i < zeros ? 0u : 0xffffu);
  };
  uint32_t v[H];
#pragma unroll
  for (int r = 0; r < H; ++r) v[r] = load(r) | load(r + H) << 16;
  // wires [0, H) ascending and [H, W) descending: a bitonic sequence
  BitonicStage<W, 2, 1, H>::run(v);
  // the first stage of its merge compares wire r with wire r + H, the two
  // halves of register r: the minima are the H smallest wires, the maxima
  // the H largest
  uint32_t low = 0u, high = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const uint32_t a = v[r], swapped = __byte_perm(a, 0u, 0x1032);
    low = __vmaxu2(low, __vminu2(a, swapped));
    high = __vminu2(high, __vmaxu2(a, swapped));
  }
  const int32_t v1 = static_cast<int32_t>(low & 0xffffu);
  out.write(px, median_result(v1, f & 1 ? v1 : static_cast<int32_t>(high & 0xffffu)));
}

// F <= 128 on the wires of 32, 64 or 128, no shared memory; larger F, and
// the scratch path, as thread_plan.
Plan median_plan(int64_t f, int64_t tile, bool scratch, int64_t p) {
  if (scratch || f > 128 || (tile != 32 && tile != 64 && tile != 128))
    return thread_plan<MedianBody>(f, tile, scratch, p);
  const int t = static_cast<int>(tile);
  const KernelFn k = f <= 32   ? median_kernel<32>
                     : f <= 64 ? median_kernel<64>
                               : median_kernel<128>;
  return {k, t, t, 0, 0, kWires};
}

}  // namespace

SIRILTPU_REJECT_ENTRY(median, median_plan, kThreadTiles)
