"""NumPy float64 oracle: literal re-derivations of the reference C code's
per-pixel rejection, the exact path that the linearfit hybrid re-runs its
knife-edge pixels through (``ops.rejection.linearfit_hybrid_block``,
``stacking.api``), and the shift gather of ``ops.imops.shift_image``.

The port's own copy of those parts of ``siriltpu.verify.oracle``.
Everything here favors clarity/exactness over speed. Each function cites
the C code whose behavior it freezes.
"""

from __future__ import annotations

import numpy as np

from siriltpu_torch.utils.rounding import np_round_to_word


def shift_gather(img: np.ndarray, shiftx: int, shifty: int,
                 fill: int = 0, skip_origin: bool = True) -> np.ndarray:
    """out[y,x] = img[y-shifty, x-shiftx] with bounds + ``ii > 0`` quirk
    (stacking.c:298-312)."""
    h, w = img.shape[-2:]
    out = np.full_like(img, fill)
    yy, xx = np.mgrid[0:h, 0:w]
    iy, ix = yy - shifty, xx - shiftx
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    if skip_origin:
        valid &= ~((iy == 0) & (ix == 0))
    out[..., valid] = img[..., iy[valid], ix[valid]]
    return out


# --------------------------------------------------------- GSL helper stats

def gsl_median_sorted(a: np.ndarray) -> float:
    """gsl_stats_median_from_sorted_data (float64 math like GSL)."""
    n = a.size
    if n == 0:
        return 0.0
    if n % 2 == 1:
        return float(a[(n - 1) // 2])
    return (float(a[n // 2 - 1]) + float(a[n // 2])) / 2.0


def gsl_sd(a) -> float:
    """gsl_stats_ushort_sd, bit-faithful to GSL 2.x: the mean is the
    long-double recurrence m += (x-m)/(i+1) (mean_source.c) returned as
    double; the variance recurrence runs on double deltas accumulated in
    long double (variance_source.c); sd = sqrt(var * n/(n-1)). The result
    is ORDER-DEPENDENT — callers must pass values in the same arrangement
    the C sees (pre-quicksort!)."""
    a = list(a)
    n = len(a)
    ld = np.longdouble
    m = ld(0.0)
    for i, v in enumerate(a):
        m += (ld(v) - m) / ld(i + 1)
    mean = np.float64(m)
    var = ld(0.0)
    for i, v in enumerate(a):
        delta = ld(np.float64(v) - mean)  # C computes the delta in double
        var += (delta * delta - var) / ld(i + 1)
    variance = np.float64(var)
    return float(np.sqrt(variance * (np.float64(n) / np.float64(n - 1))))


def gsl_fit_linear(y) -> tuple:
    """gsl_fit_linear over x = 0..n-1, bit-faithful to GSL fit/linear.c
    (double recurrence means, centered moments). Returns (b, a) =
    (intercept c0, slope c1) like the reference's call
    (stacking.c:1764)."""
    n = len(y)
    m_x = np.float64(0.0)
    m_y = np.float64(0.0)
    m_dx2 = np.float64(0.0)
    m_dxdy = np.float64(0.0)
    for i in range(n):
        m_x += (np.float64(i) - m_x) / np.float64(i + 1.0)
        m_y += (np.float64(y[i]) - m_y) / np.float64(i + 1.0)
    for i in range(n):
        dx = np.float64(i) - m_x
        dy = np.float64(y[i]) - m_y
        m_dx2 += (dx * dx - m_dx2) / np.float64(i + 1.0)
        m_dxdy += (dx * dy - m_dxdy) / np.float64(i + 1.0)
    b1 = m_dxdy / m_dx2
    b0 = m_y - m_x * b1
    return float(b0), float(b1)


# --------------------------------------------------- rejection (per pixel)

def _round_word(x) -> int:
    """round_to_WORD (utils.c:68-74): <=0 -> 0, >65535 -> 65535, else
    C cast of x+0.5 (truncation)."""
    x = float(x)
    if x <= 0.0:
        return 0
    if x > 65535.0:
        return 65535
    return int(np.float64(x) + np.float64(0.5))


def _percentile_clipping(pixel, sig, median, crej) -> int:
    """percentile_clipping (stacking.c:1130-1143). median == 0 divides by
    zero in C; IEEE inf/nan comparison semantics preserved via float64."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if np.float64(median - np.float64(pixel)) / np.float64(median) > sig[0]:
            crej[0] += 1
            return -1
        if np.float64(np.float64(pixel) - median) / np.float64(median) > sig[1]:
            crej[1] += 1
            return 1
    return 0


def _sigma_clipping(pixel, sig, sigma, median, crej) -> int:
    """sigma_clipping (stacking.c:1148-1161)."""
    if median - np.float64(pixel) > sig[0] * sigma:
        crej[0] += 1
        return -1
    if np.float64(pixel) - median > sig[1] * sigma:
        crej[1] += 1
        return 1
    return 0


def _line_clipping(pixel, sig, sigma, i, a, b, crej) -> int:
    """line_clipping (stacking.c:1169-1182); left-to-right FP order kept."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if (a * np.float64(i) + b - np.float64(pixel)) / np.float64(sigma) > sig[0]:
            crej[0] += 1
            return -1
        if (np.float64(pixel) - a * np.float64(i) - b) / np.float64(sigma) > sig[1]:
            crej[1] += 1
            return 1
    return 0


def c_reject_block(vec, rejection: str, sig):
    """Literal mirror of the per-pixel rejection switch
    (stacking.c:1656-1793) with every quirk intact:

    - ``r`` accumulates ACROSS do-while passes; the flag loop breaks as
      soon as ``N - r <= 4`` (checked after every element, flagged or not);
    - after a break, the removal loop keeps reading ``rejected[j]`` beyond
      the break point -- STALE flags from the previous pass (the buffer is
      reused, stacking.c:1679-1694). Initial buffer state is pinned to
      zeros, matching the parity goldens;
    - PERCENTILE's removal loop refuses to go below N == 1 (:1667-1673);
    - GSL statistics are evaluated with GSL's own recurrence algorithms
      (gsl_sd / gsl_fit_linear above) on the PRE-SORT arrangement, as the
      C does (sd is computed before quicksort_s each pass);
    - LINEARFIT's sigma is the sequential double accumulation of absolute
      residuals (:1766-1769).

    Returns (survivors uint16 ndarray, [rejlow, rejhigh]). Verified
    bit-exact against the compiled reference in tests/test_c_goldens.py.
    """
    stack = [int(v) for v in np.asarray(vec).reshape(-1)]
    nb = len(stack)
    N = nb
    rejected = [0] * nb
    crej = [0, 0]
    r = 0
    sig = (float(sig[0]), float(sig[1]))

    if rejection in ("none", None):
        return np.array(stack, np.uint16), crej

    if rejection == "percentile":
        stack.sort()
        median = gsl_median_sorted(np.array(stack))
        for f in range(N):
            rejected[f] = _percentile_clipping(stack[f], sig, median, crej)
        frame = 0
        j = 0
        while frame < N:
            if rejected[j] != 0 and N > 1:
                del stack[frame]
                N -= 1
                frame -= 1
            frame += 1
            j += 1
        return np.array(stack[:N], np.uint16), crej

    if rejection == "sigma":
        while True:
            sigma = gsl_sd(stack)          # pre-sort arrangement
            stack.sort()
            median = gsl_median_sorted(np.array(stack))
            n = 0
            for frame in range(N):
                rejected[frame] = _sigma_clipping(stack[frame], sig, sigma,
                                                  median, crej)
                if rejected[frame]:
                    r += 1
                if N - r <= 4:
                    break
            frame = 0
            j = 0
            while frame < N - n:
                if rejected[j] != 0:
                    del stack[frame]
                    n += 1
                    frame -= 1
                frame += 1
                j += 1
            N = N - n
            if not (n > 0 and N > 3):
                break
        return np.array(stack[:N], np.uint16), crej

    if rejection == "sigmedian":
        while True:
            sigma = gsl_sd(stack)
            stack.sort()
            median = gsl_median_sorted(np.array(stack))
            n = 0
            for frame in range(N):
                if _sigma_clipping(stack[frame], sig, sigma, median, crej):
                    stack[frame] = _round_word(median)
                    n += 1
            if not (n > 0 and N > 3):
                break
        return np.array(stack, np.uint16), crej

    if rejection == "winsorized":
        while True:
            sigma = gsl_sd(stack)
            stack.sort()
            median = gsl_median_sorted(np.array(stack))
            w = list(stack)
            while True:
                m0 = median - 1.5 * sigma
                m1 = median + 1.5 * sigma
                for jj in range(N):
                    if np.float64(w[jj]) < m0:
                        w[jj] = _round_word(m0)
                    elif np.float64(w[jj]) > m1:
                        w[jj] = _round_word(m1)
                w.sort()
                median = gsl_median_sorted(np.array(w))
                sigma0 = sigma
                sigma = 1.134 * gsl_sd(w)
                with np.errstate(divide="ignore", invalid="ignore"):
                    cont = (np.float64(abs(np.float64(sigma) - sigma0))
                            / np.float64(sigma0)) > 0.0005
                if not cont:   # NaN (sigma0 == 0) exits like C
                    break
            n = 0
            for frame in range(N):
                rejected[frame] = _sigma_clipping(stack[frame], sig, sigma,
                                                  median, crej)
                if rejected[frame] != 0:
                    r += 1
                if N - r <= 4:
                    break
            frame = 0
            j = 0
            while frame < N - n:
                if rejected[j] != 0:
                    del stack[frame]
                    frame -= 1
                    n += 1
                frame += 1
                j += 1
            N = N - n
            if not (n > 0 and N > 3):
                break
        return np.array(stack[:N], np.uint16), crej

    if rejection == "linearfit":
        while True:
            stack.sort()
            b, a = gsl_fit_linear(stack)
            sigma = np.float64(0.0)
            for frame in range(N):
                sigma += np.float64(
                    abs(np.float64(stack[frame])
                        - (a * np.float64(frame) + b)))
            sigma = float(sigma / np.float64(N))
            n = 0
            for frame in range(N):
                rejected[frame] = _line_clipping(stack[frame], sig, sigma,
                                                 frame, a, b, crej)
                if rejected[frame] != 0:
                    r += 1
                if N - r <= 4:
                    break
            frame = 0
            j = 0
            while frame < N - n:
                if rejected[j] != 0:
                    del stack[frame]
                    frame -= 1
                    n += 1
                frame += 1
                j += 1
            N = N - n
            if not (n > 0 and N > 3):
                break
        return np.array(stack[:N], np.uint16), crej

    raise ValueError(f"unknown rejection {rejection}")



def normalize_pixel_vector(pix: np.ndarray, mode: str, scale, offset, mul) -> np.ndarray:
    """Per-pixel normalization before rejection (stacking.c:1635-1651)."""
    if mode == "none":
        return pix.astype(np.uint16)
    tmp = pix.astype(np.float64) * scale
    if mode in ("additive", "additive_scaling"):
        return np_round_to_word(tmp - offset)
    if mode in ("multiplicative", "multiplicative_scaling"):
        return np_round_to_word(tmp * mul)
    raise ValueError(mode)


__all__ = ["c_reject_block", "normalize_pixel_vector", "gsl_median_sorted",
           "gsl_sd", "gsl_fit_linear", "shift_gather"]
