"""Aperture photometry.

Reference: src/algos/photometry.c.

- aperture radius = FWHMx + 0.5 (:251: sqrt(sx/2)·2·sqrt(2 ln2) + 0.5),
  must be smaller than the sky annulus inner radius (defaults
  inner=20, outer=30 px, gain 2.3 e-/ADU, :40-44);
- fractional-area aperture sum: weight 1 inside (R−0.5), else
  R − sqrt(r²) + 0.5 clipped at 0 (:283-287);
- sky level from the annulus via a robust Hampel-ψ M-estimator
  (``robustmean`` :119-190, ψ constants a=1.7 b=3.4 c=8.5, 50 iters);
- magnitude = −2.5·log10(aperture − area·sky) and the error model
  ``getMagErr`` (:217-228).

Pixels equal to 0 or 65535 are excluded everywhere (lo_data/hi_data
:38-39); at least 5 sky pixels are required (min_sky :37).

The port's own copy of ``siriltpu.ops.photometry``: NumPy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

HAMPEL_A = 1.7
HAMPEL_B = 3.4
HAMPEL_C = 8.5
MAXIT = 50
EPS = 1e-8
MIN_SKY = 5
LO_DATA = 0.0
HI_DATA = 65535.0


@dataclass
class PhotConfig:
    """phot_config (src/core/siril.h:456-460)."""
    inner: float = 20.0
    outer: float = 30.0
    gain: float = 2.3


@dataclass
class Photometry:
    mag: float
    s_mag: float


def _hampel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    sign = np.sign(x)
    out = np.where(ax < HAMPEL_A, x,
                   np.where(ax < HAMPEL_B, sign * HAMPEL_A,
                            np.where(ax < HAMPEL_C,
                                     sign * HAMPEL_A * (ax - HAMPEL_C) /
                                     (HAMPEL_B - HAMPEL_C), 0.0)))
    return out


def _dhampel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < HAMPEL_A, 1.0,
                    np.where(ax < HAMPEL_B, 0.0,
                             np.where(ax < HAMPEL_C,
                                      np.sign(x) * np.sign(x) * HAMPEL_A /
                                      (HAMPEL_B - HAMPEL_C) *
                                      np.where(x >= 0, 1.0, -1.0), 0.0)))


def _wirth_median(a: np.ndarray) -> float:
    """qmedD (photometry.c:84-116): element k = (n-1)//2 for odd n,
    n/2 - 1 for even n (lower middle)."""
    n = a.size
    k = n // 2 if (n & 1) else n // 2 - 1
    return float(np.partition(a, k)[k])


def robustmean(x: np.ndarray) -> Tuple[float, float, int]:
    """Hampel-ψ iterated M-estimator (robustmean, photometry.c:119-190).
    Returns (mean, stdev, status)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n < 1:
        return 0.0, -1.0, 1
    if n == 1:
        return float(x[0]), 0.0, 0
    a = _wirth_median(x.copy())
    s = _wirth_median(np.abs(x - a)) / 0.6745
    if abs(s) < EPS:
        stdev = float(np.sqrt(((x - a) ** 2).sum() / n))
        return a, stdev, 0
    dt = 0.0
    c = s * s * n * n / (n - 1)
    for it in range(1, MAXIT + 1):
        r = (x - a) / s
        psir = _hampel(r)
        sum1 = psir.sum()
        sum2 = _dhampel(r).sum()
        sum3 = (psir * psir).sum()
        if abs(sum2) < EPS:
            break
        d = s * sum1 / sum2
        a = a + d
        dt = c * sum3 / (sum2 * sum2)
        if it > 2 and (d * d < 1e-4 * dt or abs(d) < 10.0 * EPS):
            break
    return float(a), float(np.sqrt(dt) if dt > 0 else 0.0), 0


def get_mag_err(intensity: float, area: float, n_sky: int, skysig: float,
                gain: float) -> float:
    """getMagErr (photometry.c:217-228)."""
    skyvar = skysig * skysig
    sigsq = skyvar / n_sky
    err1 = area * skyvar
    err2 = intensity / gain
    err3 = sigsq * area * area
    return min(9.999, 1.0857 * np.sqrt(max(err1 + err2 + err3, 0.0)) /
               intensity if intensity > 0 else 9.999)


def get_photometry(z: np.ndarray, x0: float, y0: float, sx: float,
                   config: Optional[PhotConfig] = None
                   ) -> Optional[Photometry]:
    """getPhotometryData (photometry.c:233-321) on a box ``z`` with the
    PSF-fit centroid (x0, y0 in the 1-based fit convention) and sx."""
    cfg = config or PhotConfig()
    z = np.asarray(z, dtype=np.float64)
    height, width = z.shape
    xc = x0 - 1
    yc = y0 - 1
    r1 = cfg.inner
    r2 = cfg.outer
    app_radius = np.sqrt(sx / 2.0) * 2.0 * np.sqrt(np.log(2.0) * 2.0) + 0.5
    if app_radius >= r1:
        return None

    x1 = max(int(xc - r2), 1)
    x2 = min(int(xc + r2), width - 1)
    y1 = max(int(yc - r2), 1)
    y2 = min(int(yc + r2), height - 1)
    r1sq, r2sq = r1 * r1, r2 * r2
    rmin_sq = (app_radius - 0.5) ** 2

    ys, xs = np.mgrid[y1 : y2 + 1, x1 : x2 + 1]
    rr = (ys - yc) ** 2 + (xs - xc) ** 2
    # reference quirk: yp = (int)((y-yc)*(y-yc)) truncated per row
    yp = ((ys - yc) * (ys - yc)).astype(np.int64).astype(np.float64)
    rr = yp + (xs - xc) ** 2
    pix = z[y1 : y2 + 1, x1 : x2 + 1]
    good = (pix > LO_DATA) & (pix < HI_DATA)

    f = np.where(rr < rmin_sq, 1.0, app_radius - np.sqrt(rr) + 0.5)
    use = good & (f >= 0)
    area = f[use].sum()
    apmag = (pix * f)[use].sum()

    annulus = good & (rr < r2sq) & (rr > r1sq)
    sky = pix[annulus]
    if area < 1:
        return None
    if sky.size < MIN_SKY:
        return None
    mean, stdev, ret = robustmean(sky)
    if ret > 0:
        return None
    signal = apmag - area * mean
    if signal <= 0:
        return Photometry(mag=float("nan"), s_mag=9.999)
    return Photometry(mag=-2.5 * np.log10(signal),
                      s_mag=get_mag_err(signal, area, sky.size, stdev,
                                        cfg.gain))


__all__ = ["get_photometry", "robustmean", "Photometry", "PhotConfig",
           "get_mag_err"]
