"""NumPy float64 oracle: literal re-derivations of the reference C code's
semantics: the sum, max, min, mean-with-rejection and median stacks and
their normalization, the per-pixel rejection (the exact path that the
linearfit hybrid re-runs its knife-edge pixels through,
``ops.rejection.linearfit_hybrid_block``, ``stacking.api``), the shift
gather of ``ops.imops.shift_image``, quantize.c's noise estimate, and
libraw's postprocess stages that ``io.rawproc`` is held to.

The port's own copy of ``siriltpu.verify.oracle``, with its arithmetic
order.
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


def stack_sum(frames: np.ndarray, shifts: np.ndarray) -> tuple:
    """stack_summing (stacking.c:196-355): u64 accumulate, rescale max->65535."""
    f, c, h, w = frames.shape
    acc = np.zeros((c, h, w), dtype=np.uint64)
    for i in range(f):
        acc += shift_gather(frames[i].astype(np.uint64), shifts[i, 0],
                            shifts[i, 1], fill=0)
    maxim = int(acc.max())
    if maxim > 65535:
        out = np_round_to_word(acc.astype(np.float64) * (65535.0 / maxim))
    else:
        out = np_round_to_word(acc.astype(np.float64))
    return out, min(maxim, 65535)


def stack_max(frames: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    f, c, h, w = frames.shape
    acc = np.zeros((c, h, w), dtype=np.uint16)
    for i in range(f):
        sh = shift_gather(frames[i], shifts[i, 0], shifts[i, 1], fill=0)
        acc = np.maximum(acc, sh)
    return acc


def stack_min(frames: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    f, c, h, w = frames.shape
    acc = np.full((c, h, w), 65535, dtype=np.uint16)
    for i in range(f):
        sh = shift_gather(frames[i], shifts[i, 0], shifts[i, 1], fill=65535)
        acc = np.minimum(acc, sh)
    return acc


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


def reject_pixel(stack: np.ndarray, rejection: str, sig) -> np.ndarray:
    """Surviving values of the reference's per-pixel rejection loop; see
    c_reject_block for the full semantics."""
    surv, _ = c_reject_block(stack, rejection, sig)
    return surv


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


def stack_mean_rejection(frames: np.ndarray, shifts: np.ndarray,
                         rejection: str = "sigma", sig=(3.0, 3.0),
                         norm_mode: str = "none",
                         coeffs=None) -> np.ndarray:
    """Reference mean-with-rejection stack (stacking.c:1189-1858), literal
    per-pixel loop. Slow — use on small images only (tests)."""
    f, c, h, w = frames.shape
    out = np.zeros((c, h, w), dtype=np.uint16)
    if coeffs is None:
        scale = np.ones(f)
        offset = np.zeros(f)
        mul = np.ones(f)
    else:
        offset, mul, scale = coeffs
    for ch in range(c):
        for y in range(h):
            for x in range(w):
                vec = np.zeros(f, dtype=np.uint16)
                for i in range(f):
                    sx, sy = int(shifts[i, 0]), int(shifts[i, 1])
                    iy, ix = y - sy, x - sx
                    if 0 <= iy < h and 0 <= ix < w:
                        v = frames[i, ch, iy, ix]
                        vec[i] = normalize_pixel_vector(
                            np.asarray(v), norm_mode, scale[i], offset[i], mul[i])
                    else:
                        vec[i] = 0
                surv = reject_pixel(vec, rejection, sig)
                out[ch, y, x] = np_round_to_word(
                    surv.astype(np.float64).sum() / surv.size)
    return out


def stack_median(frames: np.ndarray, norm_mode: str = "none",
                 coeffs=None) -> np.ndarray:
    """Reference median stack (stacking.c:362-816): per-pixel sorted median
    over normalized values; result is the GSL ushort median (int for odd
    counts, can be x.5 truncated to WORD by assignment for even counts —
    the reference assigns the double median straight into WORD, i.e. C
    truncation, stacking.c:765-767)."""
    f, c, h, w = frames.shape
    if coeffs is None:
        scale = np.ones(f)
        offset = np.zeros(f)
        mul = np.ones(f)
    else:
        offset, mul, scale = coeffs
    vec = frames.astype(np.float64) * scale[:, None, None, None]
    if norm_mode in ("additive", "additive_scaling"):
        vec = np_round_to_word(vec - offset[:, None, None, None]).astype(np.float64)
    elif norm_mode in ("multiplicative", "multiplicative_scaling"):
        vec = np_round_to_word(vec * mul[:, None, None, None]).astype(np.float64)
    else:
        vec = frames.astype(np.float64)
    s = np.sort(vec, axis=0)
    if f % 2 == 1:
        med = s[(f - 1) // 2]
    else:
        med = (s[f // 2 - 1] + s[f // 2]) / 2.0
    return med.astype(np.uint16)  # C truncation on WORD assignment


def compute_normalization(stats_ref, stats_all, mode: str):
    """Normalization coefficients from IKSS location/scale
    (stacking.c:79-123). stats_* provide .location and .scale.
    Returns (offset, mul, scale) arrays."""
    n = len(stats_all)
    offset = np.zeros(n)
    mul = np.ones(n)
    scale = np.ones(n)
    if mode == "none":
        return offset, mul, scale
    loc0 = stats_ref.location
    scale0 = stats_ref.scale
    for i, st in enumerate(stats_all):
        if mode in ("additive_scaling", "multiplicative_scaling"):
            scale[i] = scale0 / st.scale if st.scale != 0 else 1.0
        if mode in ("additive", "additive_scaling"):
            offset[i] = scale[i] * st.location - loc0
        elif mode in ("multiplicative", "multiplicative_scaling"):
            mul[i] = loc0 / (st.location * 1.0) if st.location != 0 else 1.0
            # reference: mul[i] = mul0 / mul[i] with mul[i]=location
    return offset, mul, scale


def fn_noise5(data, nullcheck=False):
    """Literal transcription of quantize.c FnNoise5_ushort:260-657:
    explicit v1..v9 pixel shifting with null-skip and end-of-row
    continues, quick_select lower-median per row, mean-of-middles
    across rows. differences2 zero-padded to nvals (see PARITY.md).
    Returns (ngood, minval, maxval, noise2, noise3, noise5)."""
    a = np.asarray(data, dtype=np.int64)
    if a.ndim == 1:
        a = a[None, :]
    ny, nx = a.shape
    if nx < 9:
        a = a.reshape(1, -1)
        ny, nx = a.shape
    ngoodpix = 0
    xmin, xmax = 65535, 0
    if nx < 9:
        for ii in range(nx):
            if nullcheck and a[0, ii] == 0:
                continue
            xmin = min(xmin, int(a[0, ii]))
            xmax = max(xmax, int(a[0, ii]))
            ngoodpix += 1
        return ngoodpix, xmin, xmax, 0.0, 0.0, 0.0
    diffs2, diffs3, diffs5 = [], [], []
    for jj in range(ny):
        row = a[jj]
        ii = 0
        v = []
        # read v1..v8, bailing at end of row
        bail = False
        for _ in range(8):
            while ii < nx and nullcheck and row[ii] == 0:
                ii += 1
            if ii == nx:
                bail = True
                break
            v.append(int(row[ii]))
            ngoodpix += 1
            xmin = min(xmin, int(row[ii]))
            xmax = max(xmax, int(row[ii]))
            ii += 1
        if bail:
            continue
        v1, v2, v3, v4, v5, v6, v7, v8 = v
        d2, d3, d5 = [], [], []
        while ii < nx:
            while ii < nx and nullcheck and row[ii] == 0:
                ii += 1
            if ii == nx:
                break
            v9 = int(row[ii])
            xmin = min(xmin, v9)
            xmax = max(xmax, v9)
            if not (v5 == v6 == v7):
                d2.append(abs(v5 - v7))
            if not (v3 == v4 == v5 == v6 == v7):
                d3.append(abs(2 * v5 - v3 - v7))
                d5.append(abs(6 * v5 - 4 * v3 - 4 * v7 + v1 + v9))
            else:
                ngoodpix += 1
            v1, v2, v3, v4, v5, v6, v7, v8 = v2, v3, v4, v5, v6, v7, v8, v9
            ii += 1
        ngoodpix += len(d3)
        if not d3:
            continue
        if len(d3) == 1:
            if len(d2) == 1:
                diffs2.append(float(d2[0]))
            diffs3.append(float(d3[0]))
            diffs5.append(float(d5[0]))
        else:
            if len(d2) > 1:
                pad = d2 + [0] * (len(d3) - len(d2))
                diffs2.append(float(sorted(pad)[(len(d3) - 1) // 2]))
            diffs3.append(float(sorted(d3)[(len(d3) - 1) // 2]))
            diffs5.append(float(sorted(d5)[(len(d3) - 1) // 2]))

    def med(d):
        if not d:
            return 0.0
        s = sorted(d)
        return (s[(len(d) - 1) // 2] + s[len(d) // 2]) / 2.0

    return (ngoodpix, xmin, xmax, 1.0483579 * med(diffs2),
            0.6052697 * med(diffs3), 0.1772048 * med(diffs5))


# -------------------- libraw/dcraw postprocess (readraw knobs) ----------
# The reference's demosaiced raw path (image_formats_libraries.c:664-828)
# delegates to libraw's dcraw_process with no_auto_bright=1,
# output_color=0, output_bps=16. These literal scalar re-derivations of
# dcraw.c's scale_colors / gamma_curve pin the production implementation
# in siriltpu.io.rawproc.

def libraw_gamma_curve(pwr: float, ts: float, imax: float) -> np.ndarray:
    """Literal dcraw.c ``gamma_curve(pwr, ts, 2, imax)``: the 48-step
    bisection for the linear-toe split and the 0x10000-entry forward
    LUT. libraw calls it from its output stage with
    ``imax = (t_white << 3) / bright`` and t_white = 0x2000 under
    no_auto_bright.

    Each entry is stored as the C stores it into an unsigned short,
    ``int(0x10000 * v) & 0xffff``: where ``v`` reaches 1.0 (or the
    ``g[0] == 0`` log branch gives ``v < 0``) the word wraps as in dcraw,
    where the JAX package's copy raises ``OverflowError``. The production
    ``io.rawproc.gamma_curve`` clips instead; the two differ only there."""
    import math
    g = [pwr, ts, 0.0, 0.0, 0.0, 0.0]
    bnd = [0.0, 0.0]
    bnd[1 if g[1] >= 1 else 0] = 1.0
    if g[1] and (g[1] - 1) * (g[0] - 1) <= 0:
        for _ in range(48):
            g[2] = (bnd[0] + bnd[1]) / 2
            if g[0]:
                cond = (math.pow(g[2] / g[1], -g[0]) - 1) / g[0] \
                    - 1 / g[2] > -1
            else:
                cond = g[2] / math.exp(1 - 1 / g[2]) < g[1]
            bnd[1 if cond else 0] = g[2]
        g[3] = g[2] / g[1]
        if g[0]:
            g[4] = g[2] * (1 / g[0] - 1)
    curve = np.empty(0x10000, dtype=np.uint16)
    for i in range(0x10000):
        curve[i] = 0xffff
        r = i / imax
        if r < 1:
            if r < g[3]:
                v = r * g[1]
            elif g[0]:
                v = math.pow(r, g[0]) * (1 + g[4]) - g[4]
            else:
                v = math.log(r) * g[2] + 1
            curve[i] = int(0x10000 * v) & 0xffff
    return curve


def _fc3(pattern: str, row: int, col: int) -> int:
    ch = {"R": 0, "G": 1, "B": 2}
    p = pattern.upper()
    return ch[p[(row % 2) * 2 + (col % 2)]]


def libraw_auto_wb(cfa: np.ndarray, pattern: str, maximum: int = 65535,
                   black: int = 0) -> np.ndarray:
    """Literal dcraw scale_colors use_auto_wb branch: 8x8 blocks, any
    sample above maximum-25 skips the whole block (the goto), sums of
    max(val - black, 0) per filter color, pre_mul = count/sum."""
    h, w = cfa.shape
    dsum = [0.0] * 8
    for row in range(0, h - 7, 8):
        for col in range(0, w - 7, 8):
            s = [0.0] * 8
            skip = False
            for y in range(row, row + 8):
                for x in range(col, col + 8):
                    c = _fc3(pattern, y, x)
                    val = int(cfa[y, x])
                    if val > maximum - 25:
                        skip = True
                        break
                    val -= black
                    if val < 0:
                        val = 0
                    s[c] += val
                    s[c + 4] += 1
                if skip:
                    break
            if not skip:
                for c in range(8):
                    dsum[c] += s[c]
    pre = np.ones(4)
    for c in range(4):
        if dsum[c]:
            pre[c] = dsum[c + 4] / dsum[c]
    pre[3] = 0.0
    return pre


def libraw_scale_colors(cfa: np.ndarray, pattern: str,
                        pre_mul: np.ndarray, maximum: int = 65535,
                        black: int = 0) -> np.ndarray:
    """Literal dcraw scale_colors tail: green fixups, divide by the
    minimum multiplier (highlight=0 -> dmax=dmin), scale by
    65535/(maximum-black), per-sample truncate-toward-zero + CLIP;
    zero samples skipped."""
    pre = [float(x) for x in pre_mul]
    if pre[1] == 0:
        pre[1] = 1.0
    if pre[3] == 0:
        pre[3] = pre[1]
    dmin = min(pre)
    scale = [p / dmin * 65535.0 / (maximum - black) for p in pre]
    h, w = cfa.shape
    out = np.zeros((h, w), dtype=np.uint16)
    for y in range(h):
        for x in range(w):
            val = int(cfa[y, x])
            if not val:
                continue
            val -= black
            v = int(val * scale[_fc3(pattern, y, x)])
            out[y, x] = min(max(v, 0), 65535)
    return out


__all__ = ["shift_gather", "stack_sum", "stack_max", "stack_min",
           "reject_pixel", "stack_mean_rejection", "stack_median",
           "compute_normalization", "fn_noise5", "c_reject_block",
           "normalize_pixel_vector", "gsl_median_sorted", "gsl_sd",
           "gsl_fit_linear", "libraw_gamma_curve", "libraw_auto_wb",
           "libraw_scale_colors"]
