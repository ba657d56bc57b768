"""Ascending sort along the frame axis.

Port of ``siriltpu.ops.sortnet.sort_axis0``. The JAX package sorts with a
Batcher odd-even merge network because a TPU has no fast sort; any exact
ascending sort gives the same values, so the port uses ``torch.sort``.
uint16 input is widened to int32 first (torch's uint16 op support is
thin), so the result of a uint16 sort is int32.
"""

from __future__ import annotations

import torch

from siriltpu_torch.utils.interop import u16_to_i32


def sort_axis0(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along axis 0. uint16 input comes back as int32."""
    if x.dtype == torch.uint16:
        x = u16_to_i32(x)
    return torch.sort(x, dim=0).values


__all__ = ["sort_axis0"]
