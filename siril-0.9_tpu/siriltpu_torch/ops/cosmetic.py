"""Cosmetic correction: deviant-pixel detection from a master dark and
point/line fixes.

Port of ``siriltpu.ops.cosmetic``, which is NumPy already: copied without
change, on the host, on the port's ``ops/stats.py:statistics``.

Reference: src/algos/cosmetic_correction.c —
- detection (``find_deviant_pixels`` :176-243): thresholds from
  STATS_BASIC on the dark: cold = max(median − sig0·sigma, 0),
  hot = min(median + sig1·sigma, 65535); −1 disables either side;
  pixels <= cold are COLD, >= hot are HOT;
- fixes: COLD → 5×5 neighborhood median (center excluded, CFA-aware
  step 2 radius 4, :34-67), HOT → 3×3 neighborhood average (center
  excluded, :101-125), LINE → per-row 3×3 column average (:70-98);
- corrections are applied SEQUENTIALLY in scan order, each reading the
  partially-corrected buffer (cosmeticCorrection :275-294) — reproduced.

The reference's border median has an off-by-one including one stray 0
(start = 24-n-1); interior pixels with the full 24 neighbors hit
undefined behavior (reads before the array). We use the clean median of
the n collected neighbors (documented divergence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from siriltpu_torch.ops.stats import STATS_BASIC, statistics
from siriltpu_torch.utils.rounding import np_round_to_word

COLD_PIXEL = 0
HOT_PIXEL = 1


@dataclass
class DeviantPixel:
    x: int
    y: int
    type: int


def find_deviant_pixels(dark_layer: np.ndarray, sig: Tuple[float, float]
                        ) -> Tuple[List[DeviantPixel], int, int]:
    """Detection from the master dark (cosmetic_correction.c:176-243).
    Returns (pixels in scan order, icold, ihot)."""
    st = statistics(dark_layer, option=STATS_BASIC, nullcheck=True)
    if st is None:
        return [], 0, 0
    sigma, median = st.sigma, st.median
    if sig[0] == -1.0:
        thres_cold = -1.0
    else:
        val = median - sig[0] * sigma
        thres_cold = val if val > 0 else 0.0
    if sig[1] == -1.0:
        thres_hot = 65536.0
    else:
        val = median + sig[1] * sigma
        thres_hot = min(val, 65535.0)

    buf = dark_layer.astype(np.float64)
    hot = buf >= thres_hot
    cold = (~hot) & (buf <= thres_cold)
    ihot = int(hot.sum())
    icold = int(cold.sum())
    devs: List[DeviantPixel] = []
    ys, xs = np.nonzero(hot | cold)
    order = np.argsort(ys * dark_layer.shape[1] + xs)  # scan order
    for k in order:
        y, x = int(ys[k]), int(xs[k])
        devs.append(DeviantPixel(x=x, y=y,
                                 type=HOT_PIXEL if hot[y, x] else COLD_PIXEL))
    return devs, icold, ihot


def _median5x5(buf: np.ndarray, x: int, y: int, is_cfa: bool) -> int:
    """Reference quirk (getMedian5x5, cosmetic_correction.c:34-67,
    verified against the compiled C in test_c_goldens): the n gathered
    neighbours are sorted inside a zero-padded 24-slot buffer and the
    median window starts at 24-n-1 — one slot BEFORE the real values, so
    the result is the median one rank lower than the true median (for
    interior pixels, n == 24, the window nominally starts at value[-1],
    but GSL's even-n median only reads sorted[10] and sorted[11])."""
    h, w = buf.shape
    step, radius = (2, 4) if is_cfa else (1, 2)
    vals = []
    for yy in range(y - radius, y + radius + 1, step):
        for xx in range(x - radius, x + radius + 1, step):
            if 0 <= yy < h and 0 <= xx < w and (xx != x or yy != y):
                vals.append(float(buf[yy, xx]))
    n = len(vals)
    value = np.zeros(24, np.float64)
    value[24 - n:] = np.sort(np.asarray(vals))  # pads (zeros) sort first
    start = 24 - n - 1
    if start >= 0:
        win = value[start : start + n]
        med = win[n // 2] if n % 2 else (win[n // 2 - 1] + win[n // 2]) / 2
    else:  # n == 24: GSL median over (value-1)[0:24] reads value[10,11]
        med = (value[10] + value[11]) / 2
    return int(np_round_to_word(med))


def _average3x3(buf: np.ndarray, x: int, y: int, is_cfa: bool) -> int:
    h, w = buf.shape
    step = radius = 2 if is_cfa else 1
    total, n = 0.0, 0
    for yy in range(y - radius, y + radius + 1, step):
        for xx in range(x - radius, x + radius + 1, step):
            if 0 <= yy < h and 0 <= xx < w and (xx != x or yy != y):
                total += float(buf[yy, xx])
                n += 1
    return int(np_round_to_word(total / n))


def cosmetic_correction(layer: np.ndarray, devs: List[DeviantPixel],
                        is_cfa: bool = False) -> np.ndarray:
    """Apply point fixes sequentially (cosmeticCorrection :275-294)."""
    buf = layer.copy()
    for d in devs:
        if d.type == COLD_PIXEL:
            buf[d.y, d.x] = _median5x5(buf, d.x, d.y, is_cfa)
        else:
            buf[d.y, d.x] = _average3x3(buf, d.x, d.y, is_cfa)
    return buf


def fix_line(layer: np.ndarray, row: int, is_cfa: bool = False) -> np.ndarray:
    """Replace a whole row by the 3×3 column average of adjacent rows
    (getAverage3x3Line :70-98)."""
    h, w = layer.shape
    step = radius = 2 if is_cfa else 1
    buf = layer.copy()
    newline = np.empty(w, dtype=np.uint16)
    for x in range(w):
        total, n = 0.0, 0
        for yy in range(row - radius, row + radius + 1, step):
            if yy == row or not (0 <= yy < h):
                continue
            for xx in range(x - radius, x + radius + 1, step):
                if 0 <= xx < w:
                    total += float(layer[yy, xx])
                    n += 1
        newline[x] = np_round_to_word(total / n)
    buf[row] = newline
    return buf


def auto_detect_and_fix(layer: np.ndarray, sig: Tuple[float, float] = (3.0, 3.0),
                        is_cfa: bool = False) -> Tuple[np.ndarray, int, int]:
    """autoDetect path (cosmetic_correction.c:384): detect deviants on
    the image itself and fix them."""
    devs, icold, ihot = find_deviant_pixels(layer, sig)
    return cosmetic_correction(layer, devs, is_cfa), icold, ihot


__all__ = ["find_deviant_pixels", "cosmetic_correction", "fix_line",
           "auto_detect_and_fix", "DeviantPixel", "COLD_PIXEL", "HOT_PIXEL"]
