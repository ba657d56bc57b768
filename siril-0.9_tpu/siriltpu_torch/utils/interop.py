"""What crosses between siriltpu and the port, and uint16 at the boundary.

There are no learned weights in this system: what the two packages
exchange is data — (F, H, W) uint16 frames, (F, 2) int32 shifts and the
(siglow, sighigh) pair. Tests hand both packages the same seeded NumPy
frames through these helpers.

torch's op support for ``torch.uint16`` is thin (arithmetic and
reductions raise on some builds), so the port keeps uint16 only at the
public boundary and in kernel pointers. Conversions go through a
bit-preserving ``int16`` view, which every build supports for data
movement (copy, index, pad, ``where``).
"""

from __future__ import annotations

import numpy as np
import torch


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Widen a uint16 tensor to int32 (values 0..65535)."""
    if x.dtype != torch.uint16:
        raise TypeError(f"expected uint16, got {x.dtype}")
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def to_float32(x: torch.Tensor) -> torch.Tensor:
    """Any real tensor -> float32 (uint16 through int32)."""
    if x.dtype == torch.uint16:
        x = u16_to_i32(x)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def i32_to_u16(x: torch.Tensor) -> torch.Tensor:
    """Narrow an integer tensor holding values 0..65535 to uint16."""
    return x.to(torch.int32).to(torch.int16).view(torch.uint16)


def frames_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """(F, H, W) (or any shape) uint16 NumPy array -> uint16 tensor on
    ``device``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint16:
        raise TypeError(f"expected uint16 frames, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


def u16_to_numpy(x: torch.Tensor) -> np.ndarray:
    """uint16 tensor on any device -> uint16 NumPy array."""
    return x.view(torch.int16).cpu().numpy().view(np.uint16)


def shifts_to_numpy(sx: torch.Tensor, sy: torch.Tensor) -> np.ndarray:
    """Per-frame (sx, sy) tensors -> (F, 2) int32 array, columns (x, y)."""
    return np.stack([sx.cpu().numpy(), sy.cpu().numpy()],
                    axis=1).astype(np.int32)


__all__ = ["u16_to_i32", "to_float32", "i32_to_u16", "frames_from_numpy",
           "u16_to_numpy", "shifts_to_numpy"]
