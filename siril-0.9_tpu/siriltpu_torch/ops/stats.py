"""Per-layer image statistics with exact Siril parity.

Port of ``siriltpu.ops.stats``, which is NumPy already: copied without
change, on the host, without the helpers that ``statistics`` does not
call (``compute_histogram``, ``img_stats_noise``). The stacking API's
normalization is its only user in the port (``stacking.api``).

Reference: src/algos/statistics.c:207-326 (entry ``statistics()``),
src/algos/quantize.c (cfitsio-derived mean/sigma/noise), GSL stats.

TPU-first reformulation: because pixel data is uint16, EVERY order
statistic Siril computes (histogram median :47-63, MAD :65-81, BWMV
:102-126, and the whole IKSS iteration :152-187) is a function of the
65536-bin value histogram. So the only O(npixels) work is one histogram
(``np.bincount`` on host, or a device scatter-add inside fused pipelines);
everything else runs on the tiny histogram in float64 — *exactly*
reproducing the reference's double-precision results, including:

- GSL histogram quirk: bins span [0, norm] with norm+1 bins, so a value
  equal to ``norm`` falls on the upper edge and is NOT counted
  (gsl_histogram_increment drops it) while it still counts in ngoodpix.
- histogram median = first bin where cumulative count > n/2
  (statistics.c:47-63) = the (n//2)-th order statistic.
- MAD histogram with nullcheck skips the delta==0 bin (statistics.c:65-81
  passing nullcheck into the median scan).
- IKSS trims by value (data[i] < xlow), which maps exactly to histogram
  bins; median of |x-m| uses GSL's sorted-median (mean of two middle
  order statistics for even n).

The noise estimate (FnNoise1, quantize.c:658-784) is spatial (1st-order
row differences, 5-sigma clip, 3 iterations, median of per-row sigmas) and
is computed vectorized over rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from siriltpu_torch.core.frame import Frame, ImStats, Rect, select_area

# option flags (src/core/siril.h:70-76)
STATS_BASIC = 1 << 1
STATS_AVGDEV = 1 << 2
STATS_MAD = 1 << 3
STATS_BWMV = 1 << 5
STATS_MAIN = STATS_BASIC | STATS_AVGDEV | STATS_MAD | STATS_BWMV
STATS_IKSS = 1 << 6
STATS_EXTRA = STATS_MAIN | STATS_IKSS

SIGMA_CLIP = 5.0  # quantize.c:35
NITER = 3         # quantize.c:36


# ------------------------------------------------------------------ histogram

def _hist_median(counts: np.ndarray, n: int, nullcheck: bool) -> float:
    """siril_stats_ushort_median (statistics.c:47-63): first bin index where
    the cumulative count exceeds n/2, scanning from bin 1 if nullcheck."""
    start = 1 if nullcheck else 0
    c = counts[start:]
    csum = np.cumsum(c)
    idx = np.searchsorted(csum, n * 0.5, side="right")
    if idx >= c.size:
        return 0.0  # loop fell through without triggering
    return float(idx + start)


def _gsl_median_sorted(values: np.ndarray, weights: np.ndarray, n: int) -> float:
    """GSL median of a sorted multiset given (sorted unique values, counts).

    gsl_stats_median_from_sorted_data: even n -> mean of elements n/2-1 and
    n/2 (0-based); odd n -> element (n-1)/2.
    """
    if n == 0:
        return 0.0
    csum = np.cumsum(weights)
    if n % 2 == 1:
        k = (n - 1) // 2
        return float(values[np.searchsorted(csum, k, side="right")])
    k1, k2 = n // 2 - 1, n // 2
    v1 = values[np.searchsorted(csum, k1, side="right")]
    v2 = values[np.searchsorted(csum, k2, side="right")]
    return float((v1 + v2) / 2.0)


# ---------------------------------------------------------------- FnNoise1

def fn_noise1(data: np.ndarray, nullcheck: bool = False) -> float:
    """Background-noise estimate (quantize.c FnNoise1_ushort :658-784):
    sigma-clipped stdev of 1st-order differences per row, median over rows,
    scaled by 1/sqrt(2)."""
    a = np.asarray(data, dtype=np.float64)
    ny, nx = a.shape
    if nx < 3:
        return 0.0

    if nullcheck and (a == 0).any():
        # per-row compaction over non-null pixels (rare path)
        row_sigmas = []
        for r in range(ny):
            vals = a[r][a[r] != 0]
            if vals.size < 3:
                # fewer than 2 differences
                if vals.size >= 1:
                    continue
                continue
            d = vals[:-1] - vals[1:]
            if d.size < 2:
                continue
            row_sigmas.append(_clip_stdev(d))
        diffs = np.asarray(row_sigmas)
    else:
        d = a[:, :-1] - a[:, 1:]
        nvals = nx - 1
        mask = np.ones_like(d, dtype=bool)
        cnt = np.full(ny, nvals, dtype=np.int64)
        s = d.sum(axis=1)
        s2 = (d * d).sum(axis=1)
        mean = s / cnt
        std = np.sqrt(np.maximum(s2 / cnt - mean * mean, 0.0))
        active = std > 0.0
        for _ in range(NITER):
            if not active.any():
                break
            keep = mask & (np.abs(d - mean[:, None]) < SIGMA_CLIP * std[:, None])
            newcnt = keep.sum(axis=1)
            changed = active & (newcnt != cnt)
            # rows that didn't change freeze (break before recompute)
            active = changed
            upd = changed
            if upd.any():
                mask[upd] = keep[upd]
                cnt[upd] = newcnt[upd]
                dm = np.where(mask[upd], d[upd], 0.0)
                s_u = dm.sum(axis=1)
                s2_u = (dm * dm).sum(axis=1)
                with np.errstate(invalid="ignore", divide="ignore"):
                    mean_u = s_u / cnt[upd]
                    std_u = np.sqrt(np.maximum(s2_u / cnt[upd] - mean_u * mean_u, 0.0))
                mean[upd] = np.where(cnt[upd] > 0, mean_u, 0.0)
                std[upd] = np.where(cnt[upd] > 1, std_u, 0.0)
        diffs = std  # all rows valid here (nvals = nx-1 >= 2 since nx >= 3)

    nrows = diffs.size
    if nrows == 0:
        xnoise = 0.0
    elif nrows == 1:
        xnoise = float(diffs[0])
    else:
        sd = np.sort(diffs)
        xnoise = float((sd[(nrows - 1) // 2] + sd[nrows // 2]) / 2.0)
    return 0.70710678 * xnoise



def _clip_stdev(d: np.ndarray) -> float:
    nvals = d.size
    mean = d.mean()
    std = float(np.sqrt(np.maximum((d * d).mean() - mean * mean, 0.0)))
    if std > 0.0:
        for _ in range(NITER):
            keep = np.abs(d - mean) < SIGMA_CLIP * std
            kk = int(keep.sum())
            if kk == nvals:
                break
            d = d[keep]
            nvals = kk
            if nvals == 0:
                return 0.0
            mean = d.mean()
            std = float(np.sqrt(np.maximum((d * d).mean() - mean * mean, 0.0)))
    return std


# --------------------------------------------------------------------- IKSS

def ikss_from_histogram(counts: np.ndarray, norm: float):
    """IKSS location/scale (statistics.c:152-187), computed exactly in the
    histogram domain. ``counts`` is the per-value count of the good pixels
    (NO upper-edge exclusion here: IKSS runs on the raw data array).
    Values are normalized to [0, 1] by (hist_size - 1) == norm.
    Returns (location, scale) already scaled back to [0, norm].
    """
    nbins = counts.size
    v = np.arange(nbins, dtype=np.float64) / norm  # value grid in [0,1]
    c = counts.astype(np.float64)
    lo, hi = 0.0, 1.0  # current value window [xlow, xhigh] inclusive
    active = c.copy()
    s0 = 1.0
    location = scale = 0.0
    while True:
        sel = (v >= lo) & (v <= hi)
        active = np.where(sel, c, 0.0)
        n = int(active.sum())
        if n < 1:
            location = scale = 0.0
            break
        m = _gsl_median_sorted(v, active, n)
        # MAD: median of |v - m| over the active multiset (sorted-median)
        deltas = np.abs(v - m)
        order = np.argsort(deltas, kind="stable")
        mad = _gsl_median_sorted(deltas[order], active[order], n)
        # BWMV (statistics.c:128-150)
        if mad > 0.0:
            yi = (v - m) / (9.0 * mad)
            yi2 = yi * yi
            ai = (np.abs(yi) < 1.0).astype(np.float64)
            up = (active * ai * (v - m) ** 2 * (1.0 - yi2) ** 4).sum()
            down = (active * ai * (1.0 - yi2) * (1.0 - 5.0 * yi2)).sum()
            bwmv = n * (up / (down * down)) if down != 0.0 else 0.0
        else:
            bwmv = 0.0
        s = float(np.sqrt(bwmv))
        if s < 2e-23:
            location, scale = m, 0.0
            break
        if (s0 - s) / s < 10e-6:
            location, scale = m, 0.991 * s
            break
        s0 = s
        # The reference trims by advancing sorted-array indices
        # (statistics.c:180-185: `while (data[i] < xlow) i++` /
        # `while (data[j-1] > xhigh) j--`) -- indices only move INWARD, so a
        # window that re-expands past a previous bound never readmits trimmed
        # values. Reproduce that by intersecting each new window with the
        # running one. Equal values share a histogram bin, so the value-domain
        # bound is exactly equivalent to the index-domain trim.
        lo = max(lo, m - 4.0 * s)
        hi = min(hi, m + 4.0 * s)
    return location * norm, scale * norm


# -------------------------------------------------------------------- entry

def statistics(frame, layer: int = 0, selection: Optional[Rect] = None,
               option: int = STATS_MAIN, nullcheck: bool = False,
               skip_noise: bool = False) -> Optional[ImStats]:
    """Compute per-layer statistics (reference ``statistics()``,
    src/algos/statistics.c:207-326). Returns None if no good pixels.

    ``skip_noise`` leaves ``bgnoise`` at 0 — the FnNoise1 row scan is
    ~0.2 s on a 6 Mpx layer and the star finder's threshold
    (Compute_threshold, star_finder.c:39-57) reads only median/sigma."""
    if isinstance(frame, Frame):
        data = frame.layer(layer)
        nlayers = frame.nlayers
        norm = 255 if int(frame.data.max()) <= 255 else 65535
    else:
        data = np.asarray(frame)
        if data.ndim == 3:
            data = data[layer]
            nlayers = frame.shape[0]
        else:
            nlayers = 1
        norm = 255 if (data.size and int(data.max()) <= 255) else 65535
    if selection is not None and selection.w > 0 and selection.h > 0:
        data = select_area(data, selection)
    data = np.ascontiguousarray(data, dtype=np.uint16)
    total = data.size

    # full-resolution counts (no edge exclusion) for IKSS / min / max
    raw_counts = np.bincount(data.reshape(-1), minlength=norm + 1).astype(np.int64)
    hist = raw_counts.copy()
    if norm < hist.size:
        hist = hist[: norm + 1]
    hist[norm] = 0  # GSL upper-edge exclusion

    mean = sigma = noise = 0.0
    ngoodpix = total
    if option & STATS_BASIC:
        # FnMeanSigma (quantize.c:126-196): population sigma, f64
        vgrid = np.arange(raw_counts.size, dtype=np.float64)
        c = raw_counts.astype(np.float64)
        if nullcheck:
            c0 = c.copy()
            c0[0] = 0.0
            ngoodpix = int(c0.sum())
            csrc = c0
        else:
            csrc = c
        if ngoodpix == 0:
            return None
        s1 = float((vgrid * csrc).sum())
        s2 = float((vgrid * vgrid * csrc).sum())
        if ngoodpix > 1:
            mean = s1 / ngoodpix
            sigma = float(np.sqrt(max(s2 / ngoodpix - mean * mean, 0.0)))
        elif ngoodpix == 1:
            mean, sigma = s1, 0.0
        if not skip_noise:
            noise = fn_noise1(data, nullcheck)

    median = 0.0
    if option & (STATS_BASIC | STATS_AVGDEV | STATS_MAD | STATS_BWMV):
        median = _hist_median(hist, ngoodpix, nullcheck)

    # after this point the reference drops null pixels (reassign_data :189)
    good_counts = raw_counts.copy()
    if nullcheck:
        good_counts[0] = 0

    vmin = vmax = 0.0
    if option & STATS_BASIC:
        nz = np.nonzero(good_counts)[0]
        if nz.size:
            vmin, vmax = float(nz[0]), float(nz[-1])

    avgdev = 0.0
    if option & STATS_AVGDEV:
        vgrid = np.arange(good_counts.size, dtype=np.float64)
        avgdev = float((np.abs(vgrid - median) * good_counts).sum()) / ngoodpix

    mad = 0.0
    if option & (STATS_MAD | STATS_BWMV):
        # delta histogram with GSL binning over [0, 65535] (statistics.c:65-81):
        # integer deltas bin at their value; delta == 65535 dropped.
        vgrid = np.arange(good_counts.size, dtype=np.float64)
        deltas = np.abs(vgrid - median)
        dcounts = np.zeros(65536, dtype=np.int64)
        dbin = np.floor(deltas * 65536.0 / 65535.0).astype(np.int64)
        valid = dbin < 65536
        np.add.at(dcounts, dbin[valid], good_counts[valid])
        mad = _hist_median(dcounts, ngoodpix, nullcheck)

    bwmv = 0.0
    if option & STATS_BWMV:
        if mad > 0.0:
            vgrid = np.arange(good_counts.size, dtype=np.float64)
            yi = (vgrid - median) / (9.0 * mad)
            yi2 = yi * yi
            ai = (np.abs(yi) < 1.0).astype(np.float64)
            cg = good_counts.astype(np.float64)
            up = (cg * ai * (vgrid - median) ** 2 * (1.0 - yi2) ** 4).sum()
            down = (cg * ai * (1.0 - yi2) * (1.0 - 5.0 * yi2)).sum()
            bwmv = ngoodpix * (up / (down * down)) if down != 0.0 else 0.0

    location = scale = 0.0
    if option & STATS_IKSS:
        # data normalized by (hist_size - 1) == norm (statistics.c:278-290)
        location, scale = ikss_from_histogram(good_counts[: norm + 1], float(norm))

    layername = ("B&W" if nlayers == 1 else ("Red", "Green", "Blue")[layer])
    return ImStats(
        total=total, ngoodpix=ngoodpix, mean=mean, median=median, sigma=sigma,
        avgdev=avgdev, mad=mad, sqrtbwmv=float(np.sqrt(bwmv)), bgnoise=noise,
        min=vmin, max=vmax, location=location, scale=scale,
        norm_value=float(norm), layername=layername)


__all__ = [
    "statistics", "fn_noise1", "ikss_from_histogram",
    "STATS_BASIC", "STATS_AVGDEV", "STATS_MAD", "STATS_BWMV", "STATS_MAIN",
    "STATS_IKSS", "STATS_EXTRA",
]
