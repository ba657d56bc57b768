// Zero-fill integer shift of every frame of a sequence in one launch, for
// Hopper: out[f, y, x] = src[f, y - sy[f], x - sx[f]] where that lies inside
// the frame, else 0, for (F, H, W) uint16 frames and any int32 shifts (one
// as large as the frame or larger gives an all-zero frame).
//
// Replaces no Pallas kernel. The JAX package aligns in XLA:
// siril-0.9_tpu/siriltpu/pipelines/register_stack.py:_align_frames_auto_impl,
// a lax.cond on the device between a scanned dynamic_slice over a
// zero-padded copy (_align_frames_slice_impl) and the clipped double gather
// (_align_frames_impl) that XLA fuses. The port's plain versions are
// siriltpu_torch/pipelines/register_stack.py:align_frames_gather (one
// gather) and align_frames_slice (one copy a frame, after a host read of the
// shifts); this kernel matches both word for word.
//
// What bounds it on an H100: nothing is computed, every output word is
// written once and every input word read at most once, 4 F H W bytes:
// 1.23 GB at 1000 x 480 x 640 (0.367 ms at 3.35 TB/s), 6.71 GB at
// 100 x 4096 x 4096 (2.0 ms). The bound counts the zero fill as read, so
// it is rounded up: at shifts in [-20, 20] the words read are 2-4% fewer.
// The design is about those bytes:
// - a warp a row of the output, 8 rows a block (60000 blocks at 1000 x 480
//   rows, 51200 at 100 x 4096: many waves on 132 SMs). The lanes take the
//   row's 16-byte chunks (8 words) in turn, neighbouring lanes neighbouring
//   chunks, and store each with one aligned 16-byte store. The chunks start
//   at the row's first 16-byte boundary; the words before it and after the
//   last whole chunk (a row that does not start on a boundary, W not a
//   multiple of 8) are stored one by one, at most 14 a row;
// - a chunk's source starts x - sx words into its source row, in general
//   off a 16-byte boundary, so each lane loads its 8 words as 8 2-byte
//   loads. Each of the warp's 8 load instructions touches the same 512
//   contiguous bytes, so the L1 serves all but the first and device memory
//   sees each source byte once. Each load is masked at the row's edges: a word whose
//   source lies outside the row is 0 and is not loaded, and a row whose
//   source row lies outside the frame is a row shifted by W: all zeros.
//   Every output word is written exactly once, so nothing zero-fills the
//   output first. Aligned 16-byte loads shifted across registers measured
//   0.4466 ms against these loads' 0.4427 at 1000 x 480 x 640, and 2.2960
//   against 2.3660 at 100 x 4096 x 4096 (H100 80GB HBM3, 700 W, 20 launches
//   back to back): within 3%, for more code, so the plain loads stay;
// - each warp reads its frame's two shifts from device memory itself:
//   nothing is read back to the host, nothing waits.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows (warps) a block

__device__ __forceinline__ int clamp_to(int v, int n) {
  return v < -n ? -n : (v > n ? n : v);
}

// srow[x - dx] where that lies inside the row of w words, else 0.
__device__ __forceinline__ uint16_t pick(const uint16_t* srow, int x, int dx, int w) {
  const int s = x - dx;
  return s >= 0 && s < w ? __ldg(srow + s) : uint16_t(0);
}

__global__ void __launch_bounds__(32 * kWarps)
align_shift_kernel(const uint16_t* __restrict__ src, const int32_t* __restrict__ sx,
                   const int32_t* __restrict__ sy, uint16_t* __restrict__ out,
                   int64_t rows, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int64_t r = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int64_t f = r / h;
  const int y = int(r - f * h);
  const int ys = y - clamp_to(__ldg(sy + f), h);
  const bool inside = ys >= 0 && ys < h;
  // a source row outside the frame: every word falls outside its row
  const int dx = inside ? clamp_to(__ldg(sx + f), w) : w;
  const uint16_t* srow = src + (f * h + (inside ? ys : 0)) * int64_t(w);
  uint16_t* orow = out + r * int64_t(w);

  // words before the row's first 16-byte boundary, whole chunks, the rest
  const int to_boundary = int((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15) >> 1;
  const int head = to_boundary < w ? to_boundary : w;
  const int chunks = (w - head) >> 3;
  const int tail = head + 8 * chunks;

  for (int c = lane; c < chunks; c += 32) {
    const int x0 = head + 8 * c;
    uint32_t e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = pick(srow, x0 + i, dx, w);
    *reinterpret_cast<uint4*>(orow + x0) =
        make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                   e[6] | e[7] << 16);
  }
  const int singles = head + (w - tail);
  if (lane < singles) {
    const int x = lane < head ? lane : tail + (lane - head);
    orow[x] = pick(srow, x, dx, w);
  }
}

}  // namespace

// Align (f, h, w) uint16 frames at src into out by the int32 shifts sx[f],
// sy[f] (device memory), on the given stream. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a size the kernel's int
// arithmetic does not hold (h or w of 2^30 or more).
extern "C" int align_shift_u16(const void* src, const void* sx, const void* sy, void* out,
                               int64_t f, int64_t h, int64_t w, void* stream) {
  if (f < 0 || h < 0 || w < 0 || h >= (1 << 30) || w >= (1 << 30))
    return cudaErrorInvalidValue;
  const int64_t rows = f * h;
  if (rows == 0 || w == 0) return cudaSuccess;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  align_shift_kernel<<<unsigned(blocks), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(src), static_cast<const int32_t*>(sx),
      static_cast<const int32_t*>(sy), static_cast<uint16_t*>(out), rows, int(h), int(w));
  return cudaGetLastError();
}
