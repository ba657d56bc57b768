"""Color operations: colorspace conversions, SCNR, saturation
enhancement, background neutralization, white balance, channel tools.

Port of ``siriltpu.ops.colors``: host NumPy float64, copied without
change (tolerance 0 against it).

Reference: src/algos/colors.c — HSL (Fishkin) :45-146, HSV :148-221,
XYZ/LAB (sRGB D65) :223-283, saturation enhancement :399-470, SCNR 4
types :488-547, background_neutralize :623-656, white balance
:723-841. All vectorized float64 NumPy (bit-parity with the reference's
double math).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from siriltpu_torch.core.frame import Rect, select_area
from siriltpu_torch.ops.stats import STATS_BASIC, statistics
from siriltpu_torch.utils.rounding import np_round_to_word


# ------------------------------------------------------------ conversions

def rgb_to_hsl(r, g, b):
    """Fishkin RGB->HSL (colors.c:111-146), vectorized."""
    v = np.maximum(np.maximum(r, g), b)
    m = np.minimum(np.minimum(r, g), b)
    l = (m + v) / 2.0
    h = np.zeros_like(r)
    s = np.zeros_like(r)
    vm = v - m
    pos = (l > 0) & (vm > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_lo = vm / (v + m)
        s_hi = vm / (2.0 - v - m)
        s = np.where(pos, np.where(l <= 0.5, s_lo, s_hi), 0.0)
        r2 = (v - r) / vm
        g2 = (v - g) / vm
        b2 = (v - b) / vm
        h_r = np.where(g == m, 5.0 + b2, 1.0 - g2)
        h_g = np.where(b == m, 1.0 + r2, 3.0 - b2)
        h_b = np.where(r == m, 3.0 + g2, 5.0 - r2)
        h = np.where(r == v, h_r, np.where(g == v, h_g, h_b)) / 6.0
    h = np.where(pos, h, 0.0)
    l = np.maximum(l, 0.0)
    return h, s, l


def hsl_to_rgb(h, s, l):
    """Fishkin HSL->RGB (colors.c:45-100), vectorized."""
    h = np.where(h >= 1.0, h - 1.0, h)
    v = np.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m = l + l - v
    with np.errstate(divide="ignore", invalid="ignore"):
        sv = np.where(v > 0, (v - m) / v, 0.0)
    h6 = h * 6.0
    sextant = np.floor(h6).astype(np.int64) % 6
    fract = h6 - np.floor(h6)
    vsf = v * sv * fract
    mid1 = m + vsf
    mid2 = v - vsf
    r = np.choose(sextant, [v, mid2, m, m, mid1, v])
    g = np.choose(sextant, [mid1, v, v, mid2, m, m])
    b = np.choose(sextant, [m, m, mid1, v, v, mid2])
    zero = v <= 0
    return (np.where(zero, 0.0, r), np.where(zero, 0.0, g),
            np.where(zero, 0.0, b))


def rgb_to_hsv(r, g, b):
    cmax = np.maximum(np.maximum(r, g), b)
    cmin = np.minimum(np.minimum(r, g), b)
    delta = cmax - cmin
    v = cmax
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(delta > 0, delta / np.maximum(cmax, 1e-30), 0.0)
        h_r = ((g - b) / delta) / 6.0
        h_g = (((b - r) / delta) + 2.0) / 6.0
        h_b = (((r - g) / delta) + 4.0) / 6.0
        h = np.where(cmax == r, h_r, np.where(cmax == g, h_g, h_b))
    h = np.where(delta == 0, 0.0, h)
    h = np.where(h < 0, h + 1.0, h)
    return h, s, v


def hsv_to_rgb(h, s, v):
    h = np.where(h >= 1.0, h - 1.0, h)
    h6 = h * 6.0
    i = h6.astype(np.int64)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = np.clip(i, 0, 5)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return r, g, b


def rgb_to_xyz(r, g, b):
    def lin(c):
        return np.where(c <= 0.04045, c / 12.92,
                        ((c + 0.055) / 1.055) ** 2.4) * 100.0
    r, g, b = lin(r), lin(g), lin(b)
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    return x, y, z


def xyz_to_lab(x, y, z):
    def f(t):
        return np.where(t > 0.008856452, np.cbrt(t),
                        7.787037037 * t + 16.0 / 116.0)
    x, y, z = f(x / 95.047), f(y / 100.0), f(z / 108.883)
    return 116.0 * y - 16.0, 500.0 * (x - y), 200.0 * (y - z)


def lab_to_xyz(L, a, b):
    y = (L + 16.0) / 116.0
    x = a / 500.0 + y
    z = y - b / 200.0

    def finv(t):
        t3 = t ** 3
        return np.where(t3 > 0.008856452, t3, (t - 16.0 / 116.0) / 7.787037037)
    return finv(x) * 95.047, finv(y) * 100.0, finv(z) * 108.883


def xyz_to_rgb(x, y, z):
    x, y, z = x / 100.0, y / 100.0, z / 100.0
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875992 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z

    def gam(c):
        return np.where(c > 0.0031308,
                        1.055 * np.power(np.maximum(c, 1e-30), 1 / 2.4) - 0.055,
                        12.92 * c)
    return gam(r), gam(g), gam(b)


# ------------------------------------------------------------------- SCNR

def scnr(data: np.ndarray, scnr_type: int = 0, amount: float = 0.0,
         preserve_lightness: bool = True) -> np.ndarray:
    """Subtractive chromatic (green) noise reduction (colors.c:488-547).
    Types: 0 average neutral, 1 maximum neutral, 2 maximum mask,
    3 additive mask."""
    norm = 255.0 if int(data.max()) <= 255 else 65535.0
    r = data[0].astype(np.float64) / norm
    g = data[1].astype(np.float64) / norm
    b = data[2].astype(np.float64) / norm
    if preserve_lightness:
        x, y, z = rgb_to_xyz(r, g, b)
        L, _, _ = xyz_to_lab(x, y, z)
    if scnr_type == 0:
        m = 0.5 * (r + b)
        g2 = np.minimum(g, m)
    elif scnr_type == 1:
        m = np.maximum(r, b)
        g2 = np.minimum(g, m)
    elif scnr_type == 2:
        m = np.maximum(r, b)
        g2 = g * (1.0 - amount) * (1.0 - m) + m * g
    elif scnr_type == 3:
        m = np.minimum(1.0, r + b)
        g2 = g * (1.0 - amount) * (1.0 - m) + m * g
    else:
        raise ValueError(f"unknown SCNR type {scnr_type}")
    g = g2
    if preserve_lightness:
        x, y, z = rgb_to_xyz(r, g, b)
        _, a2, b2 = xyz_to_lab(x, y, z)
        x, y, z = lab_to_xyz(L, a2, b2)
        r, g, b = xyz_to_rgb(x, y, z)
    out = np.stack([np_round_to_word(r * norm), np_round_to_word(g * norm),
                    np_round_to_word(b * norm)])
    return out


# -------------------------------------------------------------- saturation

def enhance_saturation(data: np.ndarray, coeff: float, *,
                       h_min: float = 0.0, h_max: float = 360.0,
                       preserve_background: bool = True) -> np.ndarray:
    """Saturation enhancement in HSL within a hue band (colors.c:399-470)."""
    if data.shape[0] != 3 or coeff == 0.0:
        return data
    r = data[0].astype(np.float64) / 65535.0
    g = data[1].astype(np.float64) / 65535.0
    b = data[2].astype(np.float64) / 65535.0
    h, s, l = rgb_to_hsl(r, g, b)
    hmin = h_min / 360.0
    hmax = h_max / 360.0
    bg = 0.0
    if preserve_background:
        st = statistics(data[1], option=STATS_BASIC, nullcheck=True)
        if st:
            bg = (st.median + st.sigma) / st.norm_value
    if hmin > hmax:  # red wraparound case
        in_band = (h >= hmin) | (h <= hmax)
    else:
        in_band = (h >= hmin) & (h <= hmax)
    boost = (l > bg) & in_band
    s = np.where(boost, np.clip(s + s * coeff, 0.0, 1.0), s)
    s = np.where(l > bg, np.clip(s, 0.0, 1.0), s)
    r, g, b = hsl_to_rgb(h, s, l)
    return np.stack([np_round_to_word(r * 65535.0),
                     np_round_to_word(g * 65535.0),
                     np_round_to_word(b * 65535.0)])


# ---------------------------------------------------------- neutralization

def background_neutralize(data: np.ndarray, black_selection: Rect
                          ) -> np.ndarray:
    """Equalize channel backgrounds (colors.c:623-656): ref = mean of the
    3 channel medians (int division by 3), per channel subtract
    (mean − ref) truncated to int."""
    assert data.shape[0] == 3
    ref = 0
    stats = []
    for c in range(3):
        st = statistics(data[c], selection=black_selection,
                        option=STATS_BASIC, nullcheck=True)
        stats.append(st)
        ref += int(st.median)
    ref = ref // 3
    out = np.empty_like(data)
    for c in range(3):
        offset = int(stats[c].mean - ref)  # C int truncation
        buf = data[c].astype(np.int64)
        res = np.where(buf < offset, 0, np.clip(buf - offset, 0, 65535))
        out[c] = res.astype(np.uint16)
    return out


# ------------------------------------------------------------ white balance

def white_balance(data: np.ndarray, *, white_selection: Optional[Rect] = None,
                  black_selection: Optional[Rect] = None,
                  manual_kw: Optional[Tuple[float, float, float]] = None,
                  low: float = 0.0, high: float = 0.9) -> np.ndarray:
    """Color calibration (colors.c:723-841): channel gains from a white
    reference area (pixels in (low, high)·norm), background from a black
    area; out = (v − bg·norm)·kw + bg·norm."""
    assert data.shape[0] == 3
    norm = 255.0 if int(data.max()) <= 255 else 65535.0
    bg = np.zeros(3)
    if manual_kw is not None:
        kw = np.asarray(manual_kw, dtype=np.float64)
    else:
        if white_selection is None or black_selection is None:
            raise ValueError("white and black selections required")
        lo = float(np_round_to_word(np.float64(low * norm)))
        hi = float(np_round_to_word(np.float64(high * norm)))
        kw = np.zeros(3)
        for c in range(3):
            sel = select_area(data[c], white_selection).astype(np.float64)
            good = (sel > lo) & (sel < hi)
            if good.sum() > 0:
                kw[c] = (sel[good] / norm).sum() / good.sum()
        for c in range(3):
            st = statistics(data[c], selection=black_selection,
                            option=STATS_BASIC, nullcheck=True)
            bg[c] = st.median / st.norm_value
        kw = np.abs(kw - bg)
        rc = int(np.argmax(kw))
        kw = np.where(np.arange(3) == rc, 1.0, kw[rc] / np.maximum(kw, 1e-30))
    out = np.empty_like(data)
    for c in range(3):
        if kw[c] == 1.0:
            out[c] = data[c]
            continue
        bg_norm = np.uint16(bg[c] * norm)  # WORD truncation (calibrate :795)
        out[c] = np_round_to_word(
            (data[c].astype(np.float64) - bg_norm) * kw[c] + bg_norm)
    return out


def extract_channels_rgb(data: np.ndarray):
    """Split RGB into three mono layers (extract_channels RGB path)."""
    return data[0:1].copy(), data[1:2].copy(), data[2:3].copy()


__all__ = ["rgb_to_hsl", "hsl_to_rgb", "rgb_to_hsv", "hsv_to_rgb",
           "rgb_to_xyz", "xyz_to_lab", "lab_to_xyz", "xyz_to_rgb",
           "scnr", "enhance_saturation", "background_neutralize",
           "white_balance", "extract_channels_rgb"]
