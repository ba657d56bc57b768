"""Histogram transforms: MTF midtones transfer function, autostretch
parameter finder, histogram equalization.

Port of ``siriltpu.ops.histogram_ops``, which is NumPy already: copied
without change, on the host, with the 65536-entry LUT and the port's
``ops/stats.py:statistics``.

Reference: src/gui/histogram.c —
``MTF(x, m) = ((m-1)x)/((2m-1)x - m)`` (:595-608),
``apply_mtf_to_fits`` (:537-564), and the autostretch
``findMidtonesBalance`` (:684-740) with shadowsClipping = -2.80
sigma-units and targetBackground = 0.25 (:33-34); HISTEQ display mode
uses the image CDF (callbacks.c:699).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from siriltpu_torch.ops.stats import STATS_BASIC, STATS_MAD, statistics
from siriltpu_torch.utils.rounding import np_round_to_word

SHADOWS_CLIPPING = -2.80  # histogram.c:33
TARGET_BACKGROUND = 0.25  # histogram.c:34
MAD_NORM = 1.4826         # src/core/siril.h:64


def mtf(x, m):
    """Midtones transfer function (histogram.c:595-608)."""
    x = np.asarray(x, dtype=np.float64)
    if m == 0.0:
        return np.zeros_like(x)
    if m == 0.5:
        return x.copy()
    if m == 1.0:
        return np.ones_like(x)
    return ((m - 1.0) * x) / (((2.0 * m - 1.0) * x) - m)


def apply_mtf(data: np.ndarray, m: float, lo: float, hi: float,
              norm: float = 65535.0) -> np.ndarray:
    """apply_mtf_to_fits (histogram.c:537-564).

    uint16 input goes through a 65536-entry LUT (bit-identical: the
    transfer function only depends on the integer pixel value) instead
    of 25M-pixel float64 passes."""
    pente = 1.0 / (hi - lo)

    def transfer(x):
        x = np.where(x - lo < 0.0, 0.0, x - lo)
        x *= pente
        return np_round_to_word(mtf(x, m) * norm)

    if data.dtype == np.uint16 and norm == 65535.0:
        lut = transfer(np.arange(65536, dtype=np.float64) / norm)
        return lut[data]
    return transfer(data.astype(np.float64) / norm)


def find_midtones_balance(data: np.ndarray, norm: float = 65535.0
                          ) -> Tuple[float, float, float]:
    """findMidtonesBalance (histogram.c:684-740): returns (m, shadows,
    highlights) for the STF autostretch."""
    n = data.shape[0]
    meds = []
    mads = []
    inverted = 0
    for c in range(n):
        st = statistics(data[c], option=STATS_BASIC | STATS_MAD,
                        nullcheck=True)
        if st is None:
            return 0.0, 0.0, 1.0
        meds.append(st.median / st.norm_value)
        mads.append(st.mad / st.norm_value * MAD_NORM)
        if st.median / st.norm_value > 0.5:
            inverted += 1
    meds = np.asarray(meds)
    mads = np.asarray(mads)
    if inverted < n:
        c0 = float((meds + SHADOWS_CLIPPING * mads).mean())
        m2 = float(meds.mean()) - c0
        m = float(mtf(np.float64(m2), TARGET_BACKGROUND))
        return m, c0, 1.0
    c1 = float((meds - SHADOWS_CLIPPING * mads).mean())
    m2 = c1 - float(meds.mean())
    m = 1.0 - float(mtf(np.float64(m2), TARGET_BACKGROUND))
    return m, 0.0, c1


def autostretch(data: np.ndarray) -> np.ndarray:
    """STF display autostretch: find balance, apply MTF."""
    m, lo, hi = find_midtones_balance(data)
    out = np.empty_like(data)
    for c in range(data.shape[0]):
        out[c] = apply_mtf(data[c : c + 1], m, lo, hi)[0]
    return out


def histeq(data: np.ndarray) -> np.ndarray:
    """Histogram equalization via the CDF (HISTEQ display mode,
    callbacks.c:699)."""
    out = np.empty_like(data)
    for c in range(data.shape[0]):
        counts = np.bincount(data[c].reshape(-1), minlength=65536)
        cdf = np.cumsum(counts).astype(np.float64)
        cdf /= cdf[-1]
        lut = np_round_to_word(cdf * 65535.0)
        out[c] = lut[data[c]]
    return out


__all__ = ["mtf", "apply_mtf", "find_midtones_balance", "autostretch",
           "histeq", "SHADOWS_CLIPPING", "TARGET_BACKGROUND"]
