"""Integer translation of images with a fill value — the registration-
shift primitive of the sum, max and min stacks.

Port of ``siriltpu.ops.shift``. Reference semantics
(src/stacking/stacking.c:298-319, :957-971, :1080-1094):
``out[y, x] = in[y - shifty, x - shiftx]`` for in-bounds source coords,
else ``fill``. Rows are bottom-up; shifts come from regdata.

The reference also skips source index 0 (``if (ii > 0 && ...)``,
stacking.c:305): the input pixel at (y=0, x=0) is never accumulated. This
is reproduced behind ``skip_origin=True`` for bit parity of sum/min/max
stacks.

The shifts are host integers here: the output is the fill plus one
rectangle copy.
"""

from __future__ import annotations

import torch


def shift2d(img: torch.Tensor, shiftx: int, shifty: int, fill: int = 0,
            skip_origin: bool = False) -> torch.Tensor:
    """Translate the last two axes (y, x) of ``img`` by integer shifts:
    result[..., y, x] = img[..., y - shifty, x - shiftx] where the source
    is in bounds, else ``fill``."""
    h, w = img.shape[-2], img.shape[-1]
    sx, sy = int(shiftx), int(shifty)
    out = torch.full_like(img, fill)
    y0, y1 = max(0, sy), min(h, h + sy)
    x0, x1 = max(0, sx), min(w, w + sx)
    if y0 < y1 and x0 < x1:
        out[..., y0:y1, x0:x1] = img[..., y0 - sy : y1 - sy, x0 - sx : x1 - sx]
        if skip_origin and y0 == sy and x0 == sx:
            # the source origin (0, 0) landed at (sy, sx)
            out[..., sy, sx] = fill
    return out


def shift_mask(shape, shiftx: int, shifty: int, skip_origin: bool = False, *,
               device) -> torch.Tensor:
    """Just the validity mask of :func:`shift2d` (bool, (H, W)), on
    ``device``."""
    return shift2d(torch.ones(shape, dtype=torch.bool, device=device), shiftx,
                   shifty, fill=False, skip_origin=skip_origin)


__all__ = ["shift2d", "shift_mask"]
