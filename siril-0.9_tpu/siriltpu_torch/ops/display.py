"""Display remapping: the 7 display modes of the reference GUI.

Port of ``siriltpu.ops.display``, which is NumPy already: copied without
change, on the host.

Reference: ``display_mode`` (src/core/siril.h:217-225) and the remap
code in src/gui/callbacks.c: linear, log, sqrt, squared, asinh,
STF autostretch (findMidtonesBalance per remap, callbacks.c:800-801),
and histogram equalization (:699). Produces 8-bit display buffers from
the uint16 data and the [lo, hi] cutoff sliders.
"""

from __future__ import annotations

import numpy as np

from siriltpu_torch.ops.histogram_ops import apply_mtf, find_midtones_balance

LINEAR = "linear"
LOG = "log"
SQRT = "sqrt"
SQUARED = "squared"
ASINH = "asinh"
STF = "autostretch"
HISTEQ = "histeq"

MODES = (LINEAR, LOG, SQRT, SQUARED, ASINH, STF, HISTEQ)


def remap(data: np.ndarray, lo: int = 0, hi: int = 65535,
          mode: str = LINEAR) -> np.ndarray:
    """uint16 (C, H, W) -> uint8 display buffer (rows kept bottom-up)."""
    x = data.astype(np.float64)
    if mode == STF:
        m, s, h2 = find_midtones_balance(data)
        stretched = np.stack([apply_mtf(data[c : c + 1], m, s, h2)[0]
                              for c in range(data.shape[0])])
        x = stretched.astype(np.float64)
        lo, hi = 0, 65535
    if mode == HISTEQ:
        out = np.empty(data.shape, dtype=np.float64)
        for c in range(data.shape[0]):
            counts = np.bincount(data[c].reshape(-1), minlength=65536)
            cdf = np.cumsum(counts).astype(np.float64)
            cdf /= cdf[-1]
            out[c] = cdf[data[c]]
        return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)

    span = max(hi - lo, 1)
    t = np.clip((x - lo) / span, 0.0, 1.0)
    if mode in (LINEAR, STF):
        y = t
    elif mode == LOG:
        y = np.log1p(t * 65535.0) / np.log(65536.0)
    elif mode == SQRT:
        y = np.sqrt(t)
    elif mode == SQUARED:
        y = t * t
    elif mode == ASINH:
        y = np.arcsinh(t * 1000.0) / np.arcsinh(1000.0)
    else:
        raise ValueError(f"unknown display mode {mode}")
    return np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)


__all__ = ["remap", "MODES", "LINEAR", "LOG", "SQRT", "SQUARED", "ASINH",
           "STF", "HISTEQ"]
