"""Zero-fill integer shift of (F, H, W) uint16 frames by per-frame int32
shifts: the CUDA kernel ``csrc/align_shift.cu``, every frame in one launch.

out[f, y, x] = frames[f, y - sy[f], x - sx[f]] where that lies inside the
frame, else 0, for any shift. The kernel reads the shifts on the device, so
a launch waits for nothing and reads nothing back to the host. Its plain
version is ``pipelines.register_stack.align_frames_slice``;
``align_frames_auto`` sends a CUDA tensor here.
Each launch is counted (``utils.timing``, ``align.launches``).

A CUDA tensor always goes to the kernel, and a failed build or launch
raises.
"""

from __future__ import annotations

import torch

from siriltpu_torch.utils.timing import count


def _check(frames: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    if frames.dtype != torch.uint16:
        raise TypeError(f"expected uint16 frames, got {frames.dtype}")
    if sx.dtype != torch.int32 or sy.dtype != torch.int32:
        raise TypeError(f"expected int32 shifts, got {sx.dtype} and {sy.dtype}")
    if frames.dim() != 3 or 0 in frames.shape:
        raise ValueError(f"expected non-empty (F, H, W) frames, got "
                         f"{tuple(frames.shape)}")
    f = frames.shape[0]
    if tuple(sx.shape) != (f,) or tuple(sy.shape) != (f,):
        raise ValueError(f"expected ({f},) shifts for {f} frames, got "
                         f"{tuple(sx.shape)} and {tuple(sy.shape)}")
    if not (frames.is_contiguous() and sx.is_contiguous()
            and sy.is_contiguous()):
        raise ValueError("expected contiguous frames and shifts")
    dev = frames.device
    if dev.type != "cuda" or sx.device != dev or sy.device != dev:
        raise ValueError(f"expected frames and shifts on one CUDA device, got "
                         f"{dev}, {sx.device} and {sy.device}")


def align_shift(frames: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor) -> torch.Tensor:
    """Launch the align kernel on the current stream: (F, H, W) uint16
    frames and (F,) int32 shifts, all on one CUDA device, to a new (F, H,
    W) uint16 tensor. Asynchronous."""
    from siriltpu_torch.utils.build import library

    _check(frames, sx, sy)
    f, h, w = frames.shape
    dev = frames.device
    out = torch.empty((f, h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = library().align_shift_u16(
            frames.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(),
            f, h, w, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"align_shift_u16 launch failed: cudaError_t {rc}")
    count("align.launches", 1)
    return out.view(torch.uint16)


__all__ = ["align_shift"]
