"""Rounding / quantization helpers frozen for bit-parity with Siril.

Port of ``siriltpu.utils.rounding``. Reference: src/core/utils.c:60-91.

- ``round_to_word(x)``: 0 if x <= 0, 65535 if x > 65535.0, else
  ``(uint16)(x + 0.5)`` (C cast truncates toward zero; x+0.5 >= 0 so floor).
- ``round_to_byte``: same with 255.
- ``round_to_int``: round half away from zero.

The NumPy versions work in float64 (exact C parity). The torch versions
keep the input's float dtype, so a float32 tensor rounds in float32 like
the JAX device path: it can differ from the float64 rule by 1 LSB for
values within ~4e-3 of a .5 boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from siriltpu_torch.utils.interop import i32_to_u16

USHRT_MAX = 65535.0
UCHAR_MAX = 255.0


# ---------------------------------------------------------------- NumPy (f64)

def np_round_to_word(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    # floor(x+0.5) clipped to [0, 65535] is exactly the reference rule
    # (x <= 0 -> 0 agrees with the clip since floor(x+0.5) < 0 iff
    # x < -0.5); fused in-place to avoid 200MB-scale temporaries.
    out = np.array(x, dtype=np.float64)  # fresh buffer, stays ndarray
    out += 0.5
    np.floor(out, out=out)
    np.clip(out, 0.0, float(USHRT_MAX), out=out)
    return out.astype(np.uint16)


def np_round_to_byte(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.floor(x + 0.5)
    out = np.where(x <= 0.0, 0.0, out)
    out = np.where(x > UCHAR_MAX, UCHAR_MAX, out)
    return out.astype(np.uint8)


def np_round_to_int(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0.0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


# ---------------------------------------------------------------- torch

def round_to_word_f(x: torch.Tensor) -> torch.Tensor:
    """round_to_WORD keeping the float dtype (for further arithmetic)."""
    out = torch.floor(x + 0.5)
    out = torch.where(x <= 0.0, 0.0, out)
    return torch.where(x > USHRT_MAX, USHRT_MAX, out)


def round_to_word(x: torch.Tensor) -> torch.Tensor:
    """round_to_WORD of a float tensor. Returns uint16."""
    return i32_to_u16(round_to_word_f(x))


def round_to_byte(x: torch.Tensor) -> torch.Tensor:
    out = torch.floor(x + 0.5)
    out = torch.where(x <= 0.0, 0.0, out)
    out = torch.where(x > UCHAR_MAX, UCHAR_MAX, out)
    return out.to(torch.uint8)


def round_to_int(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0.0, torch.floor(x + 0.5),
                       torch.ceil(x - 0.5)).to(torch.int32)


__all__ = [
    "np_round_to_word",
    "np_round_to_byte",
    "np_round_to_int",
    "round_to_word",
    "round_to_word_f",
    "round_to_byte",
    "round_to_int",
    "USHRT_MAX",
    "UCHAR_MAX",
]
