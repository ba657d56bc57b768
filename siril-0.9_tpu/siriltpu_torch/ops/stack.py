"""Sum / max / min stacking on the device.

Port of ``siriltpu.ops.stack``. Reference: src/stacking/stacking.c —
``stack_summing`` (:196-355), ``stack_addmax`` (:824-972),
``stack_addmin`` (:979-1128).

Semantics frozen for 1-LSB parity (BASELINE config 1):

- accumulate with integer registration shifts:
  ``acc[y, x] (op)= frame[y - shifty, x - shiftx]`` when the source is in
  bounds, and NEVER from source index 0 (the ``ii > 0`` test,
  stacking.c:305) — see :mod:`siriltpu_torch.ops.shift`;
- sum: an integer accumulator; if the largest sum exceeds 65535 the
  result is rescaled by ``65535/max`` in float64 and quantized with
  round_to_WORD (:328-343), as the reference's double math does;
  otherwise it is copied;
- max: the accumulator starts at 0 (:870 calloc); min: at 65535 (:1038
  memset 0xFF). No rescale for min/max.

Plain PyTorch ops on the frames' device, one frame at a time; the JAX
package has no kernel here either. ``frames`` is an (F, C, H, W) uint16
tensor and ``shifts`` an (F, 2) int array of (shiftx, shifty), or None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from siriltpu_torch.ops.shift import shift2d
from siriltpu_torch.utils.interop import i32_to_u16, u16_to_i32
from siriltpu_torch.utils.rounding import round_to_word


def _shifted(frames: torch.Tensor, shifts: Optional[np.ndarray], fill: int):
    """Each frame widened to int32 and shifted with ``fill``, skipping the
    source origin."""
    n = frames.shape[0]
    shifts = (np.zeros((n, 2), np.int64) if shifts is None
              else np.asarray(shifts, dtype=np.int64))
    for i in range(n):
        yield shift2d(u16_to_i32(frames[i]), shifts[i, 0], shifts[i, 1],
                      fill=fill, skip_origin=True)


def stack_sum(frames: torch.Tensor, shifts: Optional[np.ndarray] = None):
    """Sum-stack the frames. Returns (uint16 (C, H, W) tensor, hi) where
    hi = round_to_WORD(max sum), matching ``gfit.hi`` (stacking.c:326)."""
    acc = torch.zeros(frames.shape[1:], dtype=torch.int64, device=frames.device)
    for shifted in _shifted(frames, shifts, 0):
        acc += shifted
    maxim = int(acc.max())  # host sync: the rescale depends on it
    if maxim > 65535:
        return round_to_word(acc.double() * (65535.0 / maxim)), 65535
    return i32_to_u16(acc), maxim


def stack_max(frames: torch.Tensor, shifts: Optional[np.ndarray] = None):
    """Keep the brightest pixel (``stack_addmax``). uint16 (C, H, W)."""
    acc = torch.zeros(frames.shape[1:], dtype=torch.int32, device=frames.device)
    for shifted in _shifted(frames, shifts, 0):
        acc = torch.maximum(acc, shifted)
    return i32_to_u16(acc)


def stack_min(frames: torch.Tensor, shifts: Optional[np.ndarray] = None):
    """Keep the darkest pixel (``stack_addmin``); untouched pixels stay
    65535. uint16 (C, H, W)."""
    acc = torch.full(frames.shape[1:], 65535, dtype=torch.int32,
                     device=frames.device)
    for shifted in _shifted(frames, shifts, 65535):
        acc = torch.minimum(acc, shifted)
    return i32_to_u16(acc)


__all__ = ["stack_sum", "stack_max", "stack_min"]
